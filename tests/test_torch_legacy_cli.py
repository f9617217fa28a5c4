"""The legacy CLIs end to end on the CPU over a preprocessed instruct root
(built by the shared data pipeline on synthetic helix PDBs):
`train_legacy` (tiny ESM2 + Llama, f32, StepLR, gradient accumulation),
resumed from its own checkpoint, then that checkpoint into
`generate_legacy --load_checkpoint_dir` and its JSON; train_legacy from
tiny HF directories (--esm_checkpoint_dir, --llama_checkpoint_dir); the
flags both refuse; the missing-GPU error; on the card, the kernels'
launches."""

import glob
import importlib.util
import json
import os
import pathlib

import hf_dirs
import pytest
import torch

from prot2text_tpu_torch.cli import generate_legacy, train_legacy
from prot2text_tpu_torch.cli.common import legacy_config, text_tokenizer
from prot2text_tpu_torch.models.composed import init_esm2llama_params
from prot2text_tpu_torch.models.weights import tree_map
from prot2text_tpu_torch.core.checkpoint import latest_step, restore_checkpoint

CSV_ROWS = """AlphaFoldDB,Full Name,taxon,sequence,function
P00001,Cytochrome c,Homo sapiens,MGDVEKGKKIFIMKCSQCHTVEK,Electron carrier protein.
P00002,Lysozyme C,Gallus gallus,KVFGRCELAAAMKRHG,Hydrolyzes peptidoglycan.
P00003,Myoglobin,Physeter catodon,MVLSEGEWQLVLHVWAKVEADVAGHGQ,Oxygen storage protein.
P00004,Ubiquitin,Homo sapiens,MQIFVKTLTGKTITLEVEPSDTI,Protein degradation signal.
"""
PROMPT = "Predict protein description based on the amino-acid sequence"


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "rows.csv"
    p.write_text(CSV_ROWS)
    return str(p)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory, csv_path):
    import pandas as pd

    from prot2text_tpu.data.chat import ByteTextTokenizer
    from prot2text_tpu.data.dataset import Prot2TextInstructDataset

    # by file path: a `tests` package installed elsewhere may shadow ours
    spec = importlib.util.spec_from_file_location(
        "_pdb_graph_helpers",
        pathlib.Path(__file__).with_name("test_pdb_graph.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    root = str(tmp_path_factory.mktemp("instruct_root"))
    ds = Prot2TextInstructDataset(
        root_dir=root, csv_path=csv_path,
        description_tokenizer=ByteTextTokenizer(),
        skip_download=True, skip_reload=True)
    for uid in pd.read_csv(csv_path)["AlphaFoldDB"]:
        helpers.make_helix_pdb(ds.raw_path(uid), n_res=12)
        ds.process_one(uid)
    ds.update_usable_file_names()
    assert len(ds) == 4
    return root


def _train_args(root, csv, ckpt, *extra):
    return ["--data_root", root, "--train_csv", csv, "--device", "cpu",
            "--debug_tiny_model", "true", "--batch_size", "2",
            "--gradient_accumulation_steps", "2", "--learning_rate", "1e-3",
            "--scheduler_gamma", "0.5", "--checkpoint_dir", ckpt,
            "--log_every", "1", *extra]


def _gen_args(root, csv, out, *extra):
    return ["--data_root", root, "--test_csv", csv, "--device", "cpu",
            "--debug_tiny_model", "true", "--model_dtype", "fp32",
            "--batch_size", "3", "--max_new_tokens", "4",
            "--output_dir", out, *extra]


def test_train_resume_then_generate_from_its_checkpoint(data_root, csv_path,
                                                        tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    state = train_legacy.main(_train_args(data_root, csv_path, ckpt,
                                          "--num_epochs", "2",
                                          "--gradient_clipping", "1.0"))
    assert state.step == 4                 # 2 epochs x 2 batches of 2
    out = capsys.readouterr().out
    assert "epoch 1: train_loss=" in out and "epoch 2: train_loss=" in out
    (run_dir,) = glob.glob(os.path.join(ckpt, "checkpoints_*"))
    assert latest_step(run_dir) == 4
    saved = restore_checkpoint(run_dir)
    assert set(saved) == {"model", "opt_state", "step"}
    assert set(saved["model"]) == {"esm_encoder", "llama_decoder",
                                   "encoder_adapter"}
    assert saved["opt_state"]["count"] == 4
    assert all(t.dtype == torch.float32 for t in
               saved["model"]["llama_decoder"]["layers"].values()
               for t in t.values())
    assert state.opt_state["count"] == 4

    resumed = train_legacy.main(_train_args(
        data_root, csv_path, str(tmp_path / "ckpt2"), "--num_epochs", "1",
        "--resume_checkpoint_dir", run_dir))
    assert resumed.step == 6
    assert "resumed from step 4" in capsys.readouterr().out

    res = str(tmp_path / "res")
    got = generate_legacy.main(_gen_args(data_root, csv_path, res,
                                         "--load_checkpoint_dir", run_dir))
    (path,) = glob.glob(os.path.join(res, "generation_legacy_0.json"))
    data = json.load(open(path))
    assert data == got and len(data) == 4
    assert all(set(v) == {"true", "pred"} for v in data.values())
    assert data["P00001"]["true"] == "Electron carrier protein."
    # the output includes the prompt (bos + sentence + bos)
    assert all(v["pred"].startswith(PROMPT) for v in data.values())
    # the checkpoint's weights, not a fresh draw: another seed changes
    # nothing, while dropping the checkpoint does
    again = generate_legacy.main(_gen_args(
        data_root, csv_path, res, "--load_checkpoint_dir", run_dir,
        "--random_seed", "7"))
    assert again == got
    fresh = generate_legacy.main(_gen_args(data_root, csv_path, res))
    assert fresh != got


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_attn_routes_generate_alike(data_root, csv_path, tmp_path,
                                    attn_impl):
    """f32 random weights: every --attn_impl computes the same function,
    so greedy predictions agree with the default route's."""
    base = generate_legacy.main(_gen_args(data_root, csv_path,
                                          str(tmp_path / "a")))
    other = generate_legacy.main(_gen_args(data_root, csv_path,
                                           str(tmp_path / "b"),
                                           "--attn_impl", attn_impl))
    assert other == base


TRAIN_BASE = ["--data_root", "unused", "--train_csv", "unused.csv",
              "--device", "cpu"]
GEN_BASE = ["--data_root", "unused", "--test_csv", "unused.csv",
            "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--esm_checkpoint_dir", "esm"],
    ["--llama_checkpoint_dir", "llama"],
    ["--fsdp", "2"],
    ["--tp", "2"],
    ["--attn_impl", "ring"],
    ["--model_dtype", "int8"],
])
def test_train_legacy_refuses_unported_flags(flags, data_root, csv_path,
                                            tmp_path, capsys):
    """Each unported flag raises, naming its ROADMAP item.
    --esm_checkpoint_dir and --llama_checkpoint_dir are ported: those
    cases read a tiny HF directory as that tower, in --model_dtype (bf16
    by default: the JAX CLI types imported towers so, the rest stays f32),
    equal to the tree it was written from, and train one epoch."""
    if flags[0] not in ("--esm_checkpoint_dir", "--llama_checkpoint_dir"):
        # --model_dtype int8: not QLoRA, the cast to an integer dtype
        match = ("truncate the weights.*ROADMAP.md §3"
                 if flags[0] == "--model_dtype" else "ROADMAP.md")
        with pytest.raises(NotImplementedError, match=match):
            train_legacy.main(TRAIN_BASE + flags)
        return
    run = _train_args(data_root, csv_path, str(tmp_path / "ckpt"),
                      "--num_epochs", "1")
    args = train_legacy.build_parser().parse_args(run)
    cfg = legacy_config(args, text_tokenizer(args))
    tree = init_esm2llama_params(cfg, generator=torch.Generator()
                                 .manual_seed(3), device="cpu")
    if flags[0] == "--esm_checkpoint_dir":
        part, sd = "esm_encoder", hf_dirs.esm2_state_dict(
            tree["esm_encoder"], cfg.esm_config.num_layers)
    else:
        part, sd = "llama_decoder", hf_dirs.decoder_state_dict(
            tree["llama_decoder"], cfg.llama_config.num_layers)
    run += [flags[0], hf_dirs.write(sd, tmp_path / "hf")]
    built = train_legacy.build_training(
        train_legacy.build_parser().parse_args(run), text_tokenizer(args),
        torch.device("cpu"), steps_per_epoch=2)
    hf_dirs.assert_tree_equal(built.state.params[part], tree_map(
        lambda t: t.to(torch.bfloat16), tree[part]))
    state = train_legacy.main(run)
    assert state.step == 2
    assert "epoch 1: train_loss=" in capsys.readouterr().out


def test_train_legacy_needs_whole_micro_batches():
    with pytest.raises(ValueError, match="micro"):
        train_legacy.main(TRAIN_BASE + ["--batch_size", "3",
                                        "--gradient_accumulation_steps",
                                        "2"])


@pytest.mark.parametrize("flags", [
    ["--sp", "2"],
    ["--attn_impl", "ring"],
    ["--model_dtype", "int4"],
])
def test_generate_legacy_refuses_unported_flags(flags):
    match = ("truncate the weights.*ROADMAP.md §3"
             if flags[0] == "--model_dtype" else "ROADMAP.md")
    with pytest.raises(NotImplementedError, match=match):
        generate_legacy.main(GEN_BASE + flags)


def test_missing_gpu_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for main, base in ((train_legacy.main, TRAIN_BASE),
                       (generate_legacy.main, GEN_BASE)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(base[:-1] + ["cuda"])


@pytest.mark.cuda
def test_both_clis_launch_their_kernels_on_cuda(data_root, csv_path,
                                                tmp_path):
    """One epoch of 2 steps x 2 micro-batches on the card (K1 forward and
    recomputation, K5 backward per decoder layer and micro-batch), then
    generation from the checkpoint (K1 per layer in each prefill, K12 twice
    per decode step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    ckpt = str(tmp_path / "ckpt")
    args = _train_args(data_root, csv_path, ckpt, "--num_epochs", "1")
    args[args.index("--device") + 1] = "cuda"
    reset_launch_counts()
    train_legacy.main(args)
    counts = launch_counts()
    L = 2                                    # LlamaConfig.tiny
    assert counts["K1"] == 2 * L * 4 and counts["K5"] == L * 4
    (run_dir,) = glob.glob(os.path.join(ckpt, "checkpoints_*"))
    gargs = _gen_args(data_root, csv_path, str(tmp_path / "res"),
                      "--load_checkpoint_dir", run_dir)
    gargs[gargs.index("--device") + 1] = "cuda"
    reset_launch_counts()
    generate_legacy.main(gargs)
    counts = launch_counts()
    assert counts["K1"] == 2 * L and counts["K12"] > 0
    assert counts["K12"] % 2 == 0 and counts["K2"] == counts["K3"] == 0
