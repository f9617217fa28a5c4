"""The port's generation CLI: an end-to-end run over a preprocessed
instruct root (built by the shared data pipeline on synthetic helix PDBs)
on the CPU and, where there is one, on the GPU; the flags it refuses; the
missing-GPU error."""

import glob
import importlib.util
import json
import pathlib

import pytest
import torch

from prot2text_tpu_torch.cli.generate_instruct import main

CSV_ROWS = """AlphaFoldDB,Full Name,taxon,sequence,function
P00001,Cytochrome c,Homo sapiens,MGDVEKGKKIFIMKCSQCHTVEK,Electron carrier protein.
P00002,Lysozyme C,Gallus gallus,KVFGRCELAAAMKRHGLDNYRGY,Hydrolyzes peptidoglycan.
P00003,Myoglobin,Physeter catodon,MVLSEGEWQLVLHVWAKVEADVA,Oxygen storage protein.
P00004,Ubiquitin,Homo sapiens,MQIFVKTLTGKTITLEVEPSDTI,Protein degradation signal.
"""


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "test.csv"
    p.write_text(CSV_ROWS)
    return str(p)


@pytest.fixture(scope="module")
def instruct_root(tmp_path_factory, csv_path):
    import pandas as pd

    from prot2text_tpu.data.chat import ByteTextTokenizer
    from prot2text_tpu.data.dataset import Prot2TextInstructDataset

    # by file path: a `tests` package installed elsewhere may shadow ours
    spec = importlib.util.spec_from_file_location(
        "_pdb_graph_helpers",
        pathlib.Path(__file__).with_name("test_pdb_graph.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    make_helix_pdb = helpers.make_helix_pdb
    root = str(tmp_path_factory.mktemp("instruct_root"))
    ds = Prot2TextInstructDataset(
        root_dir=root, csv_path=csv_path,
        description_tokenizer=ByteTextTokenizer(),
        skip_download=True, skip_reload=True)
    for uid in pd.read_csv(csv_path)["AlphaFoldDB"]:
        make_helix_pdb(ds.raw_path(uid), n_res=12)
        ds.process_one(uid)
    ds.update_usable_file_names()
    assert len(ds) == 4
    return root


def test_generate_instruct_cpu_end_to_end(instruct_root, csv_path, tmp_path):
    out = main(["--data_root", instruct_root, "--test_csv", csv_path,
                "--device", "cpu", "--debug_tiny_model", "true",
                "--model_dtype", "fp32", "--batch_size", "2",
                "--max_new_tokens", "4",
                "--output_dir", str(tmp_path / "res")])
    files = glob.glob(str(tmp_path / "res" / "generation_instruct_0.json"))
    assert len(files) == 1
    data = json.load(open(files[0]))
    assert len(data) == 4 and data == out
    assert all(set(v) == {"true", "pred"} for v in data.values())
    assert data["P00001"]["true"] == "Electron carrier protein."


def test_generate_instruct_kv_bits_8_cpu(instruct_root, csv_path, tmp_path):
    """--kv_bits 8 (formerly refused) generates through the int8 cache."""
    out = main(["--data_root", instruct_root, "--test_csv", csv_path,
                "--device", "cpu", "--debug_tiny_model", "true",
                "--model_dtype", "fp32", "--batch_size", "2",
                "--max_new_tokens", "4", "--kv_bits", "8",
                "--output_dir", str(tmp_path / "res")])
    assert len(out) == 4
    assert all(set(v) == {"true", "pred"} for v in out.values())


@pytest.mark.cuda
def test_generate_instruct_cuda_end_to_end(instruct_root, csv_path,
                                           tmp_path):
    """Default --model_dtype (bf16) on the card: K1 launches in the
    prefill and, on the tiny model's head dim 16 (the tbkd cache), K12
    writes each decode step's k and v."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = main(["--data_root", instruct_root, "--test_csv", csv_path,
                "--debug_tiny_model", "true", "--batch_size", "4",
                "--max_new_tokens", "4",
                "--output_dir", str(tmp_path / "res")])
    assert len(out) == 4
    counts = launch_counts()
    assert counts["K1"] == 2 and counts["K12"] > 0
    assert counts["K2"] == counts["K3"] == 0


BASE = ["--data_root", "unused", "--test_csv", "unused.csv",
        "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--use_graph", "true"],
    ["--num_beams", "2"],
    ["--prompt_lookup_tokens", "3"],
    ["--load_checkpoint_dir", "ckpt"],
    ["--esm_checkpoint_dir", "esm"],
    ["--llama_checkpoint_dir", "llama"],
    ["--fsdp", "2"],
    ["--tp", "2"],
    ["--sp", "2"],
    ["--attn_impl", "xla"],
    ["--attn_impl", "flash"],
    ["--attn_impl", "ring"],
    ["--model_dtype", "int8"],
])
def test_unported_flags_raise(flags, instruct_root, csv_path, tmp_path):
    """Each unported flag raises, naming its ROADMAP item.  --attn_impl xla
    and flash are ported: those two cases now generate on the CPU (the
    plain attention function in ESM2 and the prefill under "xla"; K6's and
    K1's plain versions under "flash") and give the "auto" route's
    predictions."""
    if flags[:1] != ["--attn_impl"] or flags[1] == "ring":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(BASE + flags)
        return
    run = ["--data_root", instruct_root, "--test_csv", csv_path,
           "--device", "cpu", "--debug_tiny_model", "true",
           "--model_dtype", "fp32", "--batch_size", "2",
           "--max_new_tokens", "4", "--output_dir", str(tmp_path / "res")]
    assert main(run + flags) == main(run)


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(BASE[:4] + ["--device", "cuda"])


def test_help():
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
