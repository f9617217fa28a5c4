"""The port's lockstep generation CLI over the CSV-backed light dataset
(`cli/generate_instruct_light.py`) on a tiny ESMC + Qwen3 on the CPU:

  * the JSON it writes, the final partial batch padded and dropped;
  * its predictions equal `ESMCQwen.generate`'s on the CLI's own batches
    and the serving CLI's (continuous batching) on the same requests, at
    every --attn_impl (ROADMAP.md §1 item 3's "done when");
  * --model_dtype int4 and int8 towers; a checkpoint of the port's
    training CLI merged in bf16 before the int4 quantization, and the
    bytes and pairs int4 formats through the API on `build_model`'s bf16
    towers (`build_model` at --model_dtype bf16);
  * every refused flag names its ROADMAP item; the decoding flags (beams,
    prompt lookup, a self-draft, a draft model from an HF directory) run,
    speculative ones to the plain greedy predictions, and conflicting ones
    raise JAX's SystemExit; a missing GPU is an error;
  * on the card: the launch counts of K10 (--model_dtype int4) and, through
    the API, K11a and K11b."""

import json
import os

import hf_dirs
import pytest
import torch

from prot2text_tpu_torch.cli import generate_instruct_light as cli
from prot2text_tpu_torch.cli import serve as serve_cli
from prot2text_tpu_torch.cli.train_instruct import main as train_main
from prot2text_tpu_torch.data.chat import ByteTextTokenizer
from prot2text_tpu_torch.models.composed import ESMCQwen
from prot2text_tpu_torch.models.quant import quantize_params

CSV_ROWS = """AlphaFoldDB,Full Name,taxon,sequence,function
P00001,Cytochrome c,Homo sapiens,MGDVEKGKKIFIMKCSQCHTVEK,Electron carrier protein.
P00002,Lysozyme C,Gallus gallus,KVFGRCELAAAMKRHGLDNYRGY,Hydrolyzes peptidoglycan.
P00003,Myoglobin,Physeter catodon,MVLSEGEWQLVLHVWAKVEADVAGHGQDILIRLF,Oxygen storage.
P00004,Ubiquitin,Homo sapiens,MQIFVKTLTGKTITLEVEPSDTI,Protein degradation signal.
P00005,Insulin,Homo sapiens,MALWMRLLPLLALLALWGPDPAAAFVNQHLCGSHLVEAL,Hormone.
"""


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "test.csv"
    p.write_text(CSV_ROWS)
    return str(p)


def _args(csv_path, out, *extra, device="cpu", dtype="fp32"):
    return ["--test_csv", csv_path, "--device", device,
            "--debug_tiny_model", "true", "--model_dtype", dtype,
            "--batch_size", "2", "--max_new_tokens", "6",
            "--output_dir", str(out), *extra]


def _batches(args, tok):
    from prot2text_tpu_torch.data.dataset import Prot2TextLightDataset

    ds = Prot2TextLightDataset(args.test_csv)
    collate = serve_cli.make_collator(args, tok)
    rows = [ds[i] for i in range(len(ds))]
    return [collate(rows[i:i + args.batch_size])
            for i in range(0, len(rows), args.batch_size)]


def test_light_cli_cpu_end_to_end(csv_path, tmp_path, capsys):
    """5 records at --batch_size 2: the last batch of one row is padded to
    two and only its real row is written."""
    results = cli.main(_args(csv_path, tmp_path))
    assert "descriptions/hour" in capsys.readouterr().out
    with open(tmp_path / "generation_light_0.json") as f:
        saved = json.load(f)
    assert saved == results and len(saved) == 5
    assert saved["P00001"]["true"] == "Electron carrier protein."
    assert all(isinstance(r["pred"], str) for r in saved.values())


@pytest.mark.parametrize("impl", ["auto", "xla", "flash"])
def test_light_cli_matches_generate_and_serve(csv_path, tmp_path, impl):
    """The CLI's predictions are `ESMCQwen.generate`'s tokens on its own
    batches, decoded, and the serving CLI's on the same requests."""
    flags = ("--attn_impl", impl)
    results = cli.main(_args(csv_path, tmp_path, *flags))
    args = cli.build_parser().parse_args(_args(csv_path, tmp_path, *flags))
    tok = ByteTextTokenizer()
    model = cli.build_model(args, tok, torch.device("cpu"))
    assert model.attn_impl == impl
    want = {}
    for batch in _batches(args, tok):
        t = {k: torch.as_tensor(batch[k]).long() for k in cli.AKEYS}
        toks = model.generate(
            t["input_ids"], attention_mask=t["attention_mask"],
            protein_input_ids=t["protein_input_ids"],
            protein_attention_mask=t["protein_attention_mask"],
            max_new_tokens=6, eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id)
        for name, row in zip(batch["name"], toks.tolist()):
            want[name] = tok.decode([x for x in row if x != tok.pad_token_id],
                                    skip_special_tokens=True)
    assert {n: r["pred"] for n, r in results.items()} == want
    served = serve_cli.main(
        ["--test_csv", csv_path, "--device", "cpu", "--debug_tiny_model",
         "true", "--model_dtype", "fp32", "--max_slots", "2",
         "--max_new_tokens", "6", "--prompt_pad", "128,256,512",
         "--output_dir", str(tmp_path / "serve"), *flags])
    assert {n: r["pred"] for n, r in served.items()} == want


@pytest.mark.parametrize("dtype", ["int4", "int8"])
def test_light_cli_quantized_towers(csv_path, tmp_path, capsys, dtype):
    results = cli.main(_args(csv_path, tmp_path, dtype=dtype))
    assert "towers" in capsys.readouterr().out and len(results) == 5


def test_light_cli_int4_formats_through_the_api(csv_path, tmp_path):
    """`build_model`'s bf16 towers quantized in each int4 format
    (`quantize_params(int4_format=)`, as JAX's callers reach bytes and
    pairs) run the CLI's batch loop; the three formats hold the same
    integers, so the predictions agree."""
    args = cli.build_parser().parse_args(_args(csv_path, tmp_path,
                                               dtype="bf16"))
    tok = ByteTextTokenizer()
    cpu = torch.device("cpu")
    bf16 = cli.build_model(args, tok, cpu)
    towers = bf16.params()
    assert towers["llm_decoder"]["layers"]["q_proj"]["kernel"].dtype == \
        torch.bfloat16
    preds = {}
    for fmt, key in (("planes", "kernel_q4p"), ("bytes", "kernel_q4"),
                     ("pairs", "kernel_q4w")):
        params = dict(towers, **{
            t: quantize_params(towers[t], bits=4, int4_format=fmt)
            for t in ("esm_encoder", "llm_decoder")})
        assert key in params["llm_decoder"]["layers"]["q_proj"]
        model = ESMCQwen(bf16.config, params, attn_impl=args.attn_impl)
        stats = []
        res = cli.generate_batches(args, tok, model, _batches(args, tok),
                                   cpu, stats=stats)
        assert len(res) == 5 and len(stats) == 3
        assert all(s["logits_finite"] for s in stats)
        preds[fmt] = {n: r["pred"] for n, r in res.items()}
    assert preds["bytes"] == preds["planes"] == preds["pairs"]
    with_planes = cli.main(_args(csv_path, tmp_path, dtype="int4"))
    assert {n: r["pred"] for n, r in with_planes.items()} == preds["planes"]


def test_light_cli_loads_a_training_cli_checkpoint_int4(csv_path, tmp_path):
    """--model_dtype int4 with --load_sft_checkpoint_dir: the towers are
    built in bf16, the LoRA merged, then quantized (the JAX CLI quantizes
    first and its merge refuses the integer base)."""
    from prot2text_tpu_torch.core.checkpoint import restore_checkpoint
    from prot2text_tpu_torch.models.lora import LoraConfig, merge_lora

    ckpt = tmp_path / "ck"
    train_main(["--train_csv", csv_path, "--device", "cpu",
                "--debug_tiny_model", "true", "--model_dtype", "fp32",
                "--gradient_accumulation_steps", "1", "--num_epochs", "1",
                "--debug_trim_train_split", "2", "--learning_rate", "1e-2",
                "--checkpoint_dir", str(ckpt)])
    (run,) = os.listdir(ckpt)
    sft_dir = str(ckpt / run)
    tok, cpu = ByteTextTokenizer(), torch.device("cpu")
    args = cli.build_parser().parse_args(_args(
        csv_path, tmp_path, "--load_sft_checkpoint_dir", sft_dir,
        dtype="int4"))
    got = cli.build_model(args, tok, cpu).params()
    bf16 = cli.build_model(cli.build_parser().parse_args(_args(
        csv_path, tmp_path, dtype="bf16")), tok, cpu).params()
    sft = restore_checkpoint(sft_dir)
    lcfg = LoraConfig(r=32, alpha=64)
    want = quantize_params(merge_lora(lcfg, bf16["llm_decoder"],
                                      sft["lora_llm"]), bits=4)
    for name in ("q_proj", "down_proj"):
        for k in ("kernel_q4p", "scale"):
            assert torch.equal(got["llm_decoder"]["layers"][name][k],
                               want["layers"][name][k])
    assert torch.equal(got["adapter"]["fc1"]["kernel"],
                       sft["adapter"]["fc1"]["kernel"])
    results = cli.main(_args(csv_path, tmp_path / "res",
                             "--load_sft_checkpoint_dir", sft_dir,
                             dtype="int4"))
    assert len(results) == 5


BASE = ["--test_csv", "unused.csv", "--device", "cpu"]


@pytest.mark.parametrize("flags,item", [
    (["--num_beams", "2"], "§1 item 10"),
    (["--prompt_lookup_tokens", "3"], "§1 item 7"),
    (["--speculative_gamma", "2"], "§1 item 7"),
    (["--speculative_gamma", "2", "--self_speculative_layers", "4"],
     "§1 item 7"),
    (["--load_peft_adapter_dir", "peft"], "§1 item 9"),
    (["--llm_checkpoint_dir", "qwen3"], "§1 item 6"),
    (["--fsdp", "2"], "§1 item 14"),
    (["--tp", "2"], "§1 item 14"),
    (["--sp", "2"], "§1 item 14"),
    (["--attn_impl", "ring"], "§1 item 14"),
])
def test_unported_flags_raise(flags, item, csv_path, tmp_path):
    """Each unported flag raises, naming its ROADMAP item.
    --llm_checkpoint_dir is ported: that case generates with Qwen3 from a
    tiny HF directory (the built tower equal to the tree it was written
    from).  So is --load_peft_adapter_dir: that case merges a PEFT adapter
    directory into the decoder (its logits those of the LoRA merged, not
    the base's) and generates.  So are the §1 item 7 and item 10 decoding
    flags: those cases generate (see below) or raise JAX's ValueError."""
    if flags[0] == "--load_peft_adapter_dir":
        from prot2text_tpu_torch.models.lora import merge_lora

        peft_dir, lora, lcfg = hf_dirs.peft_cli_dir(tmp_path / "peft")
        args = _args(csv_path, tmp_path / "res", flags[0], peft_dir)
        tok, cpu = ByteTextTokenizer(), torch.device("cpu")
        model = cli.build_model(cli.build_parser().parse_args(args), tok,
                                cpu)
        plain = cli.build_model(cli.build_parser().parse_args(
            _args(csv_path, tmp_path / "res")), tok, cpu).params()
        core = model.config.llm_config.core()
        got = hf_dirs.decoder_logits_of(core, model.params()["llm_decoder"])
        want = hf_dirs.decoder_logits_of(core, merge_lora(
            lcfg, plain["llm_decoder"], lora))
        assert torch.equal(got, want)
        assert not torch.equal(got, hf_dirs.decoder_logits_of(
            core, plain["llm_decoder"]))
        results = cli.main(args)
        assert len(results) == 5
        return
    if item in ("§1 item 7", "§1 item 10"):
        # the decoding flags are ported: beams write their JSON file,
        # speculative decoding (a random draft under --debug_tiny_model)
        # gives the plain greedy predictions; a self-draft of 4 of the
        # tiny decoder's 2 layers raises JAX's own ValueError
        args = _args(csv_path, tmp_path / "res", *flags)
        if "--self_speculative_layers" in flags:
            with pytest.raises(ValueError, match="draft_layers"):
                cli.main(args)
            return
        results = cli.main(args)
        with open(tmp_path / "res" / "generation_light_0.json") as f:
            assert json.load(f) == results and len(results) == 5
        if flags[0] != "--num_beams":
            assert results == cli.main(_args(csv_path, tmp_path / "plain"))
        return
    if flags[0] != "--llm_checkpoint_dir":
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            cli.main(BASE + flags)
        return
    hf_dir, tree = hf_dirs.qwen3_cli_dir(tmp_path / "qwen3")
    args = _args(csv_path, tmp_path / "res", flags[0], hf_dir)
    model = cli.build_model(cli.build_parser().parse_args(args),
                            ByteTextTokenizer(), torch.device("cpu"))
    hf_dirs.assert_tree_equal(model.params()["llm_decoder"], tree)
    results = cli.main(args)
    assert len(results) == 5
    assert all(set(v) == {"true", "pred"} for v in results.values())


@pytest.mark.parametrize("flags,exit_message", [
    (["--speculative_gamma", "2", "--self_speculative_layers", "1"], None),
    (["--prompt_lookup_tokens", "3", "--speculative_gamma", "2"],
     "mutually exclusive"),
    (["--prompt_lookup_tokens", "3", "--num_beams", "2"], "greedy-only"),
    (["--speculative_gamma", "2", "--do_sample", "true"], "greedy-only"),
    (["--speculative_gamma", "2", "--debug_tiny_model", "false"],
     "needs --draft_checkpoint_dir"),
])
def test_speculative_flags(flags, exit_message, csv_path, tmp_path):
    """A self-draft of the tiny decoder's first layer gives the plain
    greedy predictions; JAX's SystemExit for flags that do not go
    together."""
    args = _args(csv_path, tmp_path / "res", *flags)
    if exit_message is not None:
        with pytest.raises(SystemExit, match=exit_message):
            cli.main(args)
        return
    assert cli.main(args) == cli.main(_args(csv_path, tmp_path / "plain"))


def test_draft_checkpoint_dir(csv_path, tmp_path, monkeypatch):
    """--speculative_gamma with --draft_checkpoint_dir (no
    --debug_tiny_model): the draft is Qwen3-0.6B's config (here the tiny
    Qwen3's, by monkeypatch) loaded from the HF directory, its tree equal
    to the one written, and the tiny model's predictions with that draft
    are the plain greedy ones."""
    from prot2text_tpu_torch.models.qwen3 import Qwen3Config

    hf_dir, tree = hf_dirs.qwen3_cli_dir(tmp_path / "draft", seed=12)
    tok, cpu = ByteTextTokenizer(), torch.device("cpu")
    plain_args = cli.build_parser().parse_args(_args(csv_path, tmp_path))
    model = cli.build_model(plain_args, tok, cpu)
    tiny = model.config.llm_config
    monkeypatch.setattr(Qwen3Config, "qwen3_0_6b", classmethod(
        lambda cls: tiny))
    args = cli.build_parser().parse_args(_args(
        csv_path, tmp_path, "--speculative_gamma", "3",
        "--draft_checkpoint_dir", hf_dir, "--debug_tiny_model", "false"))
    draft_cfg, draft = cli.build_draft(args, model, cpu)
    assert draft_cfg == tiny
    hf_dirs.assert_tree_equal(draft, tree)
    batches = _batches(plain_args, tok)
    stats = []
    got = cli.generate_batches(args, tok, model, batches, cpu,
                               draft=(draft_cfg, draft), stats=stats)
    assert got == cli.generate_batches(plain_args, tok, model, batches, cpu)
    assert all(s["rounds"] > 0 for s in stats)


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
def test_light_cli_launch_counts_on_cuda(csv_path, tmp_path):
    """--model_dtype int4 on the card: every decode step launches K10 for
    the 7 projections of each of the 2 layers and the head, every batch's
    prefill the same and ESMC's 4 projections a layer; bytes and pairs
    towers launch K11a and K11b as many times (a bf16 x takes the kernels
    at every row count)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    args = cli.build_parser().parse_args(_args(
        csv_path, tmp_path, device="cuda", dtype="bf16"))
    tok, dev = ByteTextTokenizer(), torch.device("cuda")
    bf16 = cli.build_model(args, tok, dev)
    towers = bf16.params()
    batches = _batches(args, tok)
    for fmt, kid in (("planes", "K10"), ("bytes", "K11a"),
                     ("pairs", "K11b")):
        params = dict(towers, **{
            t: quantize_params(towers[t], bits=4, int4_format=fmt)
            for t in ("esm_encoder", "llm_decoder")})
        model = ESMCQwen(bf16.config, params)
        stats = []
        reset_launch_counts()
        cli.generate_batches(args, tok, model, batches, dev, stats=stats)
        counts = launch_counts()
        steps = sum(s["steps"] for s in stats)
        esm = 4 * model.config.esm_config.n_layers
        assert counts[kid] == len(batches) * (15 + esm) + steps * 15, counts
        assert sum(v for k, v in counts.items()
                   if k.startswith(("K10", "K11", "K14")) and k != kid) == 0
