"""The port's stage-1 contrastive CLI: two optimizer steps on a tiny CSV on
the CPU (and, where there is one, on the GPU through K1 and K6) writing a
checkpoint, resume restoring the adapter, optimizer state and step, the
--attn_impl routes, int8/int4 towers, the flags it refuses, the loss
logger's positivity guard, the missing-GPU error."""

import json
import os

import hf_dirs
import pytest
import torch

from prot2text_tpu_torch.cli import train_contrast as cli
from prot2text_tpu_torch.cli.common import LossLogger
from prot2text_tpu_torch.core.checkpoint import latest_step, restore_checkpoint
from prot2text_tpu_torch.data.chat import ByteTextTokenizer

ROWS = [("P00001", "Cytochrome c", "Homo sapiens", "MGDVEKGKKIFIMKCSQCHTVEK",
         "Electron carrier protein."),
        ("P00002", "Lysozyme C", "Gallus gallus", "KVFGRCELAAAMKRHGLDNYRGY",
         "Hydrolyzes peptidoglycan."),
        ("P00003", "Myoglobin", "Physeter catodon", "MVLSEGEWQLVLHVWAKVEADVA",
         "Oxygen storage protein."),
        ("P00004", "Ubiquitin", "Homo sapiens", "MQIFVKTLTGKTITLEVEPSDTI",
         "Protein degradation signal."),
        ("P00005", "Insulin", "Homo sapiens", "MALWMRLLPLLALLALWGPDPAA",
         "Regulates glucose uptake."),
        ("P00006", "Actin", "Homo sapiens", "MDDDIAALVVDNGSGMCKAGFAG",
         "Forms the cytoskeleton."),
        ("P00007", "Histone H4", "Homo sapiens", "MSGRGKGGKGLGKGGAKRHRKVL",
         "Packs DNA into chromatin."),
        ("P00008", "Ferritin", "Homo sapiens", "MTTASTSQVRQNYHQDSEAAINR",
         "Stores iron.")]


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "train.csv"
    p.write_text("AlphaFoldDB,Full Name,taxon,sequence,function\n" +
                 "".join(",".join(r) + "\n" for r in ROWS))
    return str(p)


def _args(csv_path, ckpt, *extra):
    # 8 rows, batch 2 x accumulation 2: two optimizer steps per epoch
    return ["--train_csv", csv_path, "--device", "cpu",
            "--debug_tiny_model", "true", "--model_dtype", "fp32",
            "--batch_size", "2", "--gradient_accumulation_steps", "2",
            "--num_epochs", "1", "--log_every", "1", "--checkpoint_dir",
            str(ckpt), *extra]


def _run_dir(ckpt):
    (run,) = os.listdir(ckpt)
    return os.path.join(ckpt, run)


def test_train_two_steps_checkpoint_and_resume(csv_path, tmp_path, capsys):
    """Epoch 1's learning rate is 0 (a per-epoch cosine with warmup), so
    the adapter moves from epoch 2 on; the resumed run restores the
    adapter, the moments and the step, and goes on from there."""
    ckpt = tmp_path / "ck"
    state = cli.main(_args(csv_path, ckpt, "--num_epochs", "2",
                           "--eval_csv", csv_path,
                           "--profile_dir", str(tmp_path / "prof")))
    assert state.step == 4 and state.opt_state["count"] == 4
    out = capsys.readouterr().out
    assert "epoch 1: train_loss=" in out and "2 steps" in out
    assert "epoch 2: eval_loss=" in out
    run = _run_dir(ckpt)
    assert latest_step(run) == 4
    saved = restore_checkpoint(run)
    assert set(saved) == {"adapter", "opt_state", "step"}
    assert saved["step"] == 4 and saved["opt_state"]["count"] == 4
    first = restore_checkpoint(run, step=2)
    moved = (saved["adapter"]["fc1"]["kernel"]
             - first["adapter"]["fc1"]["kernel"]).abs().max()
    assert moved > 0                  # epoch 2 has lr > 0
    torch.testing.assert_close(saved["adapter"]["fc2"]["bias"],
                               state.params["fc2"]["bias"].detach())
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]

    state = cli.main(_args(csv_path, tmp_path / "ck2",
                           "--resume_checkpoint_dir", run))
    assert "resumed from step 4" in capsys.readouterr().out
    assert state.step == 6 and state.opt_state["count"] == 6
    assert latest_step(_run_dir(tmp_path / "ck2")) == 6


def test_stage1_adapter_feeds_stage2(csv_path, tmp_path):
    """The README's order: a train_contrast checkpoint's adapter is what
    train_instruct --load_adapter_checkpoint_dir starts from."""
    from prot2text_tpu_torch.cli.train_instruct import main as sft_main

    state = cli.main(_args(csv_path, tmp_path / "s1", "--num_epochs", "2"))
    run = _run_dir(tmp_path / "s1")
    sft = sft_main(_args(csv_path, tmp_path / "s2", "--batch_size", "1",
                         "--load_adapter_checkpoint_dir", run,
                         "--fix_modality_adapter", "true"))
    assert sft.step == 4
    torch.testing.assert_close(sft.params["adapter"]["fc1"]["kernel"],
                               state.params["fc1"]["kernel"].detach())


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_attn_impl_routes_train(csv_path, tmp_path, impl):
    state = cli.main(_args(csv_path, tmp_path / "ck", "--attn_impl", impl))
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in
               (state.params["fc1"]["kernel"], state.params["fc2"]["kernel"]))


@pytest.mark.parametrize("dtype,key", [("int8", "kernel_q"),
                                       ("int4", "kernel_q4p")])
def test_quantized_towers(csv_path, tmp_path, dtype, key):
    """--model_dtype int8/int4: both towers built in bf16 and quantized
    (forward only); the adapter trains in f32."""
    args = _args(csv_path, tmp_path / "ck")
    args[args.index("--model_dtype") + 1] = dtype
    state = cli.main(args)
    assert state.step == 2
    parsed = cli.build_parser().parse_args(args)
    run = cli.build_contrast(parsed, ByteTextTokenizer(),
                             torch.device("cpu"), steps_per_epoch=2)
    assert key in run.frozen["llm_decoder"]["layers"]["q_proj"]
    assert key in run.frozen["esm_encoder"]["layers"]["qkv"]
    assert run.state.params["fc1"]["kernel"].dtype == torch.float32


BASE = ["--train_csv", "unused.csv", "--device", "cpu"]


@pytest.mark.parametrize("flags,item", [
    (["--llm_checkpoint_dir", "qwen3"], "item 6"),
    (["--fsdp", "2"], "item 14"),
    (["--tp", "2"], "item 14"),
    (["--sp", "2"], "item 14"),
    (["--attn_impl", "ring"], "item 14"),
])
def test_unported_flags_raise(flags, item, csv_path, tmp_path, capsys):
    """Each unported flag raises, naming its ROADMAP item.
    --llm_checkpoint_dir is ported: that case now loads a tiny HF Qwen3
    directory as the text tower (equal to the tree it was written from)
    and trains two steps on the CPU."""
    if flags[0] != "--llm_checkpoint_dir":
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md §1 {item}"):
            cli.main(BASE + flags)
        return
    hf_dir, tree = hf_dirs.qwen3_cli_dir(tmp_path / "qwen3")
    args = _args(csv_path, tmp_path / "ck", flags[0], hf_dir)
    run = cli.build_contrast(cli.build_parser().parse_args(args),
                             ByteTextTokenizer(), torch.device("cpu"),
                             steps_per_epoch=2)
    hf_dirs.assert_tree_equal(run.frozen["llm_decoder"], tree)
    state = cli.main(args)
    assert state.step == 2
    assert "2 steps" in capsys.readouterr().out


def test_loss_logger_flags_non_positive_losses(capsys):
    log = LossLogger(log_every=2, positive_required=True)
    for v in (0.5, 0.0, -1.0):
        log.append(torch.tensor(v))
    mean, n = log.finish()
    assert n == 3 and abs(mean - (-0.5 / 3)) < 1e-7
    err = capsys.readouterr().err
    assert "impossible loss 0.0" in err
    assert "impossible loss -1.0" in err
    assert "0.5" not in err


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(BASE[:2] + ["--device", "cuda"])


def test_help():
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0


@pytest.mark.cuda
def test_contrast_on_cuda_flash_launches_k1_and_k6(csv_path, tmp_path):
    """bf16 on the card at --attn_impl flash: per micro-step, K1 once per
    text-tower layer run (min(16, 2) = 2), K6 once per ESMC layer (no
    recomputation: the towers run without a gradient); no backward
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    args = _args(csv_path, tmp_path / "ck", "--attn_impl", "flash")
    args[args.index("--device") + 1] = "cuda"
    args[args.index("--model_dtype") + 1] = "bf16"
    state = cli.main(args)
    counts = launch_counts()
    micro = 4
    assert state.step == 2
    assert counts["K1"] == 2 * micro and counts["K6"] == 2 * micro
    assert counts["K5"] == counts["K6b"] == 0
