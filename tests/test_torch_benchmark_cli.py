"""The port's scoring CLI (`prot2text_tpu_torch/cli/benchmark.py`) against
the JAX package's (`prot2text_tpu/cli/benchmark.py`) on result JSONs the
port's `generate_instruct --debug_tiny_model --device cpu` writes, beside a
second matching file and one that must not match:

  * the metrics it prints and returns equal JAX's;
  * no file matching the identifier raises JAX's FileNotFoundError;
  * its flags are JAX's plus --device, with JAX's defaults; --device cuda
    without a GPU raises."""

import importlib.util
import json
import pathlib

import pytest
import torch

from prot2text_tpu.cli import benchmark as jcli
from prot2text_tpu_torch.cli import benchmark as tcli
from prot2text_tpu_torch.cli.generate_instruct import main as generate

CSV_ROWS = """AlphaFoldDB,Full Name,taxon,sequence,function
P00001,Cytochrome c,Homo sapiens,MGDVEKGKKIFIMKCSQCHTVEK,Electron carrier protein.
P00002,Lysozyme C,Gallus gallus,KVFGRCELAAAMKRHGLDNYRGY,Hydrolyzes peptidoglycan.
P00003,Myoglobin,Physeter catodon,MVLSEGEWQLVLHVWAKVEADVA,Oxygen storage protein.
"""


@pytest.fixture(scope="module")
def results_dir(tmp_path_factory):
    """generation_instruct_0.json from the port's generation CLI over a
    preprocessed instruct root (synthetic helix PDBs, as tests/
    test_torch_cli.py builds it), a hand-written generation_instruct_1.json
    and a generation_serve_0.json the identifier "instruct" must skip."""
    import pandas as pd

    from prot2text_tpu.data.chat import ByteTextTokenizer
    from prot2text_tpu.data.dataset import Prot2TextInstructDataset

    spec = importlib.util.spec_from_file_location(
        "_pdb_graph_helpers",
        pathlib.Path(__file__).with_name("test_pdb_graph.py"))
    helpers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helpers)
    tmp = tmp_path_factory.mktemp("bench")
    csv_path = tmp / "test.csv"
    csv_path.write_text(CSV_ROWS)
    root = str(tmp / "root")
    ds = Prot2TextInstructDataset(
        root_dir=root, csv_path=str(csv_path),
        description_tokenizer=ByteTextTokenizer(), skip_download=True,
        skip_reload=True)
    for uid in pd.read_csv(csv_path)["AlphaFoldDB"]:
        helpers.make_helix_pdb(ds.raw_path(uid), n_res=12)
        ds.process_one(uid)
    ds.update_usable_file_names()
    out = tmp / "results"
    got = generate(["--data_root", root, "--test_csv", str(csv_path),
                    "--device", "cpu", "--debug_tiny_model", "true",
                    "--model_dtype", "fp32", "--batch_size", "2",
                    "--max_new_tokens", "6", "--output_dir", str(out)])
    assert len(got) == 3
    extra = {"Q1": {"true": "Binds ATP &quot;tightly&quot;, 3.5-fold.",
                    "pred": "Binds ATP tightly (3.5-fold)."},
             "Q2": {"true": "Ion channel.\nVoltage-gated.",
                    "pred": "ion channel"}}
    (out / "generation_instruct_1.json").write_text(json.dumps(extra))
    (out / "generation_serve_0.json").write_text(json.dumps(
        {"Z": {"true": "x", "pred": "y"}}))
    return str(out)


def test_scores_equal_jax(results_dir, capsys):
    args = ["--results_dir", results_dir, "--identifier", "instruct"]
    got = tcli.main(args + ["--device", "cpu"])
    printed = capsys.readouterr().out
    want = jcli.main(args)
    assert got == want
    assert printed == capsys.readouterr().out
    assert "5 pairs from 2 files" in printed
    assert set(got) == {"exact_match", "bleu2", "bleu4", "rouge"}
    preds, refs, paths = tcli.load_results(results_dir, "instruct")
    assert (preds, refs, paths) == jcli.load_results(results_dir, "instruct")
    assert len(paths) == 2 and preds[-1] == "ion channel"


def test_no_match_raises_as_jax(results_dir):
    with pytest.raises(FileNotFoundError) as t:
        tcli.main(["--results_dir", results_dir, "--identifier", "absent",
                   "--device", "cpu"])
    with pytest.raises(FileNotFoundError) as j:
        jcli.main(["--results_dir", results_dir, "--identifier", "absent"])
    assert str(t.value) == str(j.value)


def _options(parser) -> dict:
    return {a.option_strings[0]: a.default for a in parser._actions
            if a.option_strings and a.option_strings[0] != "-h"}


def test_flags_are_jax_plus_device():
    port, ref = _options(tcli.build_parser()), _options(jcli.build_parser())
    assert port.pop("--device") == "cuda"
    assert port == ref
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tcli.main(["--identifier", "x"])
