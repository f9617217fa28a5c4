"""The port's stage-2 SFT CLI: two optimizer steps on a tiny CSV on the CPU
(and, where there is one, on the GPU through K1/K5, and K6/K6b under
--attn_impl flash) writing a checkpoint, resume restoring the step counter,
the --attn_impl routes, the flags it refuses, the missing-GPU error."""

import json
import os

import hf_dirs
import pytest
import torch

from prot2text_tpu_torch.cli.train_instruct import (
    build_parser, build_training, main,
)
from prot2text_tpu_torch.data.chat import ByteTextTokenizer
from prot2text_tpu_torch.core.checkpoint import latest_step, restore_checkpoint

CSV_ROWS = """AlphaFoldDB,Full Name,taxon,sequence,function
P00001,Cytochrome c,Homo sapiens,MGDVEKGKKIFIMKCSQCHTVEK,Electron carrier protein.
P00002,Lysozyme C,Gallus gallus,KVFGRCELAAAMKRHGLDNYRGY,Hydrolyzes peptidoglycan.
P00003,Myoglobin,Physeter catodon,MVLSEGEWQLVLHVWAKVEADVA,Oxygen storage protein.
P00004,Ubiquitin,Homo sapiens,MQIFVKTLTGKTITLEVEPSDTI,Protein degradation signal.
"""


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "train.csv"
    p.write_text(CSV_ROWS)
    return str(p)


def _args(csv_path, ckpt, *extra):
    # 4 rows, batch 1 x accumulation 2: two optimizer steps per epoch
    return ["--train_csv", csv_path, "--device", "cpu",
            "--debug_tiny_model", "true", "--model_dtype", "fp32",
            "--gradient_accumulation_steps", "2", "--num_epochs", "1",
            "--log_every", "1", "--checkpoint_dir", str(ckpt), *extra]


def _run_dir(ckpt):
    (run,) = os.listdir(ckpt)
    return os.path.join(ckpt, run)


def test_train_two_steps_checkpoint_and_resume(csv_path, tmp_path, capsys):
    ckpt = tmp_path / "ck"
    state = main(_args(csv_path, ckpt, "--eval_csv", csv_path,
                       "--profile_dir", str(tmp_path / "prof")))
    assert state.step == 2 and state.opt_state["count"] == 2
    out = capsys.readouterr().out
    assert "epoch 1: train_loss=" in out and "2 steps" in out
    assert "eval_loss=" in out
    run = _run_dir(ckpt)
    assert latest_step(run) == 2
    saved = restore_checkpoint(run)
    assert set(saved) == {"lora_esm", "lora_llm", "adapter", "opt_state",
                          "step"}
    assert saved["step"] == 2
    b = saved["lora_llm"]["layers"]["q_proj"]["kernel"]["B"]
    assert b.abs().max() > 0          # a step with lr > 0 moved LoRA B
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]

    state = main(_args(csv_path, tmp_path / "ck2",
                       "--resume_checkpoint_dir", run))
    assert "resumed from step 2" in capsys.readouterr().out
    assert state.step == 4 and state.opt_state["count"] == 4
    assert latest_step(_run_dir(tmp_path / "ck2")) == 4


@pytest.mark.cuda
def test_train_on_cuda_launches_k1_and_k5(csv_path, tmp_path):
    """Default --model_dtype (bf16) on the card: per micro-step, K1 runs
    twice per decoder layer (forward, then recomputed in the backward) and
    K5 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    args = _args(csv_path, tmp_path / "ck")
    args[args.index("--device") + 1] = "cuda"
    args[args.index("--model_dtype") + 1] = "bf16"
    state = main(args)
    counts = launch_counts()
    micro, layers = 4, 2
    assert state.step == 2
    assert counts["K1"] == 2 * layers * micro
    assert counts["K5"] == layers * micro


@pytest.mark.cuda
def test_train_on_cuda_flash_launches_k6_and_k6b(csv_path, tmp_path):
    """--attn_impl flash on the card: ESMC's attention runs K6 twice per
    layer and micro-step (forward, then recomputed in the backward) and
    K6b once; the decoder keeps K1/K5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    args = _args(csv_path, tmp_path / "ck", "--attn_impl", "flash")
    args[args.index("--device") + 1] = "cuda"
    args[args.index("--model_dtype") + 1] = "bf16"
    state = main(args)
    counts = launch_counts()
    micro, layers = 4, 2
    assert state.step == 2
    assert counts["K1"] == 2 * layers * micro
    assert counts["K5"] == layers * micro
    assert counts["K6"] == 2 * layers * micro
    assert counts["K6b"] == layers * micro


BASE = ["--train_csv", "unused.csv", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--fsdp", "2"],
    ["--tp", "2"],
    ["--sp", "2"],
    ["--attn_impl", "ring"],
    ["--attn_impl", "xla"],
    ["--attn_impl", "flash"],
    ["--model_dtype", "int8"],
    ["--model_dtype", "int4"],
    ["--llm_checkpoint_dir", "qwen3"],
])
def test_unported_flags_raise(flags, csv_path, tmp_path, capsys):
    """Each unported flag raises, naming its ROADMAP item.  --attn_impl
    xla and flash are ported: those two cases now train two steps on the
    CPU (the plain versions of K6/K6b and K1/K5 under "flash", the plain
    attention function under "xla").  So is --llm_checkpoint_dir: that
    case loads a tiny HF Qwen3 directory as the frozen text tower (equal
    to the tree it was written from) and trains two steps.  So is
    --model_dtype int8/int4 (QLoRA): those cases quantize both towers,
    train two steps, and LoRA B moves at a quantized leaf of each."""
    if flags[0] == "--llm_checkpoint_dir":
        hf_dir, tree = hf_dirs.qwen3_cli_dir(tmp_path / "qwen3")
        flags = [flags[0], hf_dir]
        args = build_parser().parse_args(_args(csv_path, tmp_path / "ck",
                                               *flags))
        run = build_training(args, ByteTextTokenizer(), torch.device("cpu"),
                             total_steps=2)
        hf_dirs.assert_tree_equal(run.frozen["llm_decoder"], tree)
    elif flags[0] != "--model_dtype" and (
            flags[:1] != ["--attn_impl"] or flags[1] == "ring"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(BASE + flags)
        return
    state = main(_args(csv_path, tmp_path / "ck", *flags))
    assert state.step == 2 and state.opt_state["count"] == 2
    assert "2 steps" in capsys.readouterr().out
    for tree, proj in (("lora_esm", "qkv"), ("lora_llm", "q_proj")):
        node = state.params[tree]["layers"][proj]
        (key,) = [k for k, v in node.items() if v is not None]
        assert (key != "kernel") == (flags[0] == "--model_dtype"), key
        assert node[key]["B"].abs().max() > 0      # the LoRA got a gradient


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(BASE[:2] + ["--device", "cuda"])


def test_help():
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
