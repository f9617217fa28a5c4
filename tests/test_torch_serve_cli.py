"""The port's serving CLI on a tiny CSV on the CPU (and, where there is one,
on the GPU through K1/K6/K9a, or K4 with --shared_prefix false): the JSON
it writes, its descriptions/hour line, the shared prefix it discovers; the
int8 pool and prompt-lookup speculation (--kv_bits 8,
--prompt_lookup_tokens, the controller flags); weight-quantized towers
(--model_dtype int8/int4); a checkpoint written by the port's training CLI
served through --load_sft_checkpoint_dir, in bf16 and merged before the
int4 quantization; --attn_impl routing the encoder; the flags it refuses;
the missing-GPU error."""

import json
import os

import hf_dirs
import pytest
import torch

from prot2text_tpu.data.chat import ByteTextTokenizer
from prot2text_tpu_torch.cli import serve as cli
from prot2text_tpu_torch.cli.train_instruct import main as train_main
from prot2text_tpu_torch.models.lora import LoraConfig, merge_lora

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
            "--max_slots", "2", "--max_new_tokens", "5",
            "--prompt_pad", "128,256,512", "--output_dir", str(out), *extra]


@pytest.mark.parametrize("extra", [[], ["--prefix_dedup", "false"],
                                   ["--shared_prefix", "false"]],
                         ids=["dedup", "replicated", "no_prefix"])
def test_serve_cpu_end_to_end(csv_path, tmp_path, capsys, extra):
    results = cli.main(_args(csv_path, tmp_path, *extra))
    out = capsys.readouterr().out
    assert "descriptions/hour" in out
    assert ("shared prompt prefix" in out) == (extra != ["--shared_prefix",
                                                         "false"])
    with open(tmp_path / "generation_serve_0.json") as f:
        saved = json.load(f)
    assert saved == results and len(saved) == 5
    assert saved["P00001"]["true"] == "Electron carrier protein."
    assert all(isinstance(r["pred"], str) for r in saved.values())


@pytest.mark.parametrize("extra", [
    ["--kv_bits", "8"], ["--prompt_lookup_tokens", "3"],
    ["--kv_bits", "8", "--prompt_lookup_tokens", "3"],
    ["--kv_bits", "8", "--prompt_lookup_tokens", "3", "--shared_prefix",
     "false", "--spec_break_even", "100", "--spec_probe_every", "2"]],
    ids=["kv8", "spec", "kv8_spec", "kv8_spec_controller"])
def test_serve_int8_and_speculative_cpu(csv_path, tmp_path, capsys, extra):
    """--kv_bits 8 and --prompt_lookup_tokens (formerly refused) serve every
    record and write the JSON; speculative runs print their acceptance."""
    results = cli.main(_args(csv_path, tmp_path, *extra))
    out = capsys.readouterr().out
    assert "descriptions/hour" in out
    assert ("verify rounds accepting" in out) == (
        "--prompt_lookup_tokens" in extra)
    with open(tmp_path / "generation_serve_0.json") as f:
        saved = json.load(f)
    assert saved == results and len(saved) == 5
    assert all(isinstance(r["pred"], str) for r in saved.values())


def test_speculative_serving_keeps_the_greedy_tokens(csv_path, tmp_path):
    """On the bf16 pool in fp32, prompt-lookup speculation is an exact
    shortcut: the same greedy predictions as plain serving."""
    plain = cli.main(_args(csv_path, tmp_path / "plain"))
    spec = cli.main(_args(csv_path, tmp_path / "spec",
                          "--prompt_lookup_tokens", "3"))
    assert spec == plain


def test_prefix_modes_serve_the_same_greedy_tokens(csv_path, tmp_path):
    """Shared prefix (dedup or replicated) or none, the greedy predictions
    are the same: the prefix is an exact shortcut."""
    preds = [cli.main(_args(csv_path, tmp_path / str(i), *extra))
             for i, extra in enumerate(([], ["--prefix_dedup", "false"],
                                        ["--shared_prefix", "false"]))]
    assert preds[0] == preds[1] == preds[2]


def test_serves_a_training_cli_checkpoint(csv_path, tmp_path):
    """Two SFT steps of the port's training CLI (the first, at the warmup's
    lr 0, leaves LoRA B at zero), then serving with its LoRA merged into
    the towers built in --model_dtype and with its adapter."""
    ckpt = tmp_path / "ck"
    train_main(["--train_csv", csv_path, "--device", "cpu",
                "--debug_tiny_model", "true", "--model_dtype", "fp32",
                "--gradient_accumulation_steps", "1", "--num_epochs", "1",
                "--debug_trim_train_split", "2", "--learning_rate", "1e-2",
                "--checkpoint_dir", str(ckpt)])
    (run,) = os.listdir(ckpt)
    sft_dir = str(ckpt / run)
    args = cli.build_parser().parse_args(_args(
        csv_path, tmp_path / "res", "--load_sft_checkpoint_dir", sft_dir))
    tok = ByteTextTokenizer()
    cfg, params = cli.build_server(args, tok, torch.device("cpu"))
    base_args = cli.build_parser().parse_args(_args(csv_path, tmp_path))
    _, base = cli.build_server(base_args, tok, torch.device("cpu"))
    from prot2text_tpu_torch.core.checkpoint import restore_checkpoint

    sft = restore_checkpoint(sft_dir)
    want = merge_lora(LoraConfig(r=32, alpha=64), base["llm_decoder"],
                      sft["lora_llm"])
    got = params["llm_decoder"]["layers"]["q_proj"]["kernel"]
    assert torch.equal(got, want["layers"]["q_proj"]["kernel"])
    assert not torch.equal(got, base["llm_decoder"]["layers"]["q_proj"][
        "kernel"])
    assert torch.equal(params["adapter"]["fc1"]["kernel"],
                       sft["adapter"]["fc1"]["kernel"])
    results = cli.main(_args(csv_path, tmp_path / "res",
                             "--load_sft_checkpoint_dir", sft_dir))
    assert len(results) == 5


def test_serves_a_training_cli_checkpoint_int4(csv_path, tmp_path):
    """--model_dtype int4 with --load_sft_checkpoint_dir: the towers are
    built in bf16, the LoRA merged, then quantized (the JAX CLI quantizes
    first and its merge refuses the integer base), so the served tree is
    quantize_params(merge_lora(bf16 towers)); then the CLI serves."""
    from prot2text_tpu_torch.core.checkpoint import restore_checkpoint
    from prot2text_tpu_torch.models.quant import quantize_params

    ckpt = tmp_path / "ck"
    train_main(["--train_csv", csv_path, "--device", "cpu",
                "--debug_tiny_model", "true", "--model_dtype", "fp32",
                "--gradient_accumulation_steps", "1", "--num_epochs", "1",
                "--debug_trim_train_split", "2", "--learning_rate", "1e-2",
                "--checkpoint_dir", str(ckpt)])
    (run,) = os.listdir(ckpt)
    sft_dir = str(ckpt / run)
    tok = ByteTextTokenizer()
    cpu = torch.device("cpu")
    args = cli.build_parser().parse_args(_args(
        csv_path, tmp_path / "res", "--load_sft_checkpoint_dir", sft_dir,
        dtype="int4"))
    _, params = cli.build_server(args, tok, cpu)
    _, bf16 = cli.build_server(cli.build_parser().parse_args(_args(
        csv_path, tmp_path, dtype="bf16")), tok, cpu)
    sft = restore_checkpoint(sft_dir)
    lcfg = LoraConfig(r=32, alpha=64)
    for tower, lora in (("llm_decoder", "lora_llm"),
                        ("esm_encoder", "lora_esm")):
        want = quantize_params(merge_lora(lcfg, bf16[tower], sft[lora]),
                               bits=4)
        got = params[tower]

        def check(g, w):
            if isinstance(w, dict):
                assert set(g) == set(w)
                for k in w:
                    check(g[k], w[k])
            else:
                assert g.dtype == w.dtype and torch.equal(g, w)

        check(got, want)
    assert not torch.equal(
        params["llm_decoder"]["layers"]["q_proj"]["kernel_q4p"],
        quantize_params(bf16["llm_decoder"], bits=4)["layers"]["q_proj"][
            "kernel_q4p"])
    results = cli.main(_args(csv_path, tmp_path / "res",
                             "--load_sft_checkpoint_dir", sft_dir,
                             dtype="int4"))
    assert len(results) == 5


BASE = ["--test_csv", "unused.csv", "--device", "cpu"]


@pytest.mark.parametrize("flags,item", [
    (["--medusa_path", "heads.npz"], "item 8, Medusa serving"),
    (["--load_peft_adapter_dir", "peft"], "item 9"),
    (["--llm_checkpoint_dir", "qwen3"], "item 6"),
    (["--tp", "2"], "item 14"),
    (["--fsdp", "2"], "item 14"),
    (["--sp", "2"], "item 14"),
    (["--model_dtype", "int8"], "item 4"),
    (["--model_dtype", "int4"], "item 4"),
    (["--attn_impl", "ring"], "item 14"),
])
def test_unported_flags_raise(csv_path, tmp_path, capsys, flags, item):
    """Each unported flag raises, naming its ROADMAP item.  --model_dtype
    int8/int4 (weight-quantized serving) is ported: those two cases now run
    a tiny CPU serve that quantizes both towers, prints their bytes and
    writes its JSON.  So is --llm_checkpoint_dir: that case serves Qwen3
    from a tiny HF directory (the built tower equal to the tree it was
    written from).  So is --load_peft_adapter_dir: that case merges a PEFT
    adapter directory into the decoder (its logits those of the LoRA
    merged, not the base's) and serves."""
    if flags[0] == "--load_peft_adapter_dir":
        peft_dir, lora, lcfg = hf_dirs.peft_cli_dir(tmp_path / "peft")
        args = _args(csv_path, tmp_path, flags[0], peft_dir)
        cfg, params = cli.build_server(cli.build_parser().parse_args(args),
                                       ByteTextTokenizer(),
                                       torch.device("cpu"))
        _, plain = cli.build_server(cli.build_parser().parse_args(
            _args(csv_path, tmp_path)), ByteTextTokenizer(),
            torch.device("cpu"))
        core = cfg.llm_config.core()
        got = hf_dirs.decoder_logits_of(core, params["llm_decoder"])
        want = hf_dirs.decoder_logits_of(core, merge_lora(
            lcfg, plain["llm_decoder"], lora))
        assert torch.equal(got, want)
        assert not torch.equal(got, hf_dirs.decoder_logits_of(
            core, plain["llm_decoder"]))
        results = cli.main(args)
        assert len(results) == 5
        return
    if flags[0] == "--llm_checkpoint_dir":
        hf_dir, tree = hf_dirs.qwen3_cli_dir(tmp_path / "qwen3")
        args = _args(csv_path, tmp_path, flags[0], hf_dir)
        _, params = cli.build_server(cli.build_parser().parse_args(args),
                                     ByteTextTokenizer(),
                                     torch.device("cpu"))
        hf_dirs.assert_tree_equal(params["llm_decoder"], tree)
        results = cli.main(args)
        assert "descriptions/hour" in capsys.readouterr().out
        with open(tmp_path / "generation_serve_0.json") as f:
            assert json.load(f) == results and len(results) == 5
        return
    if flags[0] != "--model_dtype":
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md §1 {item}"):
            cli.main(BASE + flags)
        return
    dtype = flags[1]
    results = cli.main(_args(csv_path, tmp_path, dtype=dtype))
    out = capsys.readouterr().out
    assert f"--model_dtype {dtype}: towers" in out
    assert "descriptions/hour" in out
    with open(tmp_path / "generation_serve_0.json") as f:
        saved = json.load(f)
    assert saved == results and len(saved) == 5
    args = cli.build_parser().parse_args(_args(csv_path, tmp_path,
                                               dtype=dtype))
    assert args.model_dtype == dtype          # build_server leaves args be
    _, params = cli.build_server(args, ByteTextTokenizer(),
                                 torch.device("cpu"))
    key = "kernel_q4p" if dtype == "int4" else "kernel_q"
    assert key in params["llm_decoder"]["layers"]["q_proj"]
    assert key in params["llm_decoder"]["lm_head"]
    assert key in params["esm_encoder"]["layers"]["qkv"]
    assert params["llm_decoder"]["embed_tokens"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["auto", "xla", "flash"])
def test_attn_impl_routes_the_encoder(csv_path, tmp_path, monkeypatch,
                                      impl):
    """--attn_impl reaches every ESMC attention (a spy on the encoder's
    attention call) and nothing else: the engine's decoder keeps its own
    routes, as in JAX serving; the greedy tokens are those of "auto"."""
    from prot2text_tpu_torch.models import esmc

    seen = []
    real = esmc.dot_product_attention

    def spy(q, k, v, bias, impl="xla"):
        seen.append(impl)
        return real(q, k, v, bias, impl=impl)

    monkeypatch.setattr(esmc, "dot_product_attention", spy)
    results = cli.main(_args(csv_path, tmp_path, "--attn_impl", impl))
    n_layers = 2                      # ESMCConfig.tiny()
    assert len(seen) > 0 and len(seen) % n_layers == 0
    assert set(seen) == {impl}
    monkeypatch.setattr(esmc, "dot_product_attention", real)
    if impl != "auto":
        base = cli.main(_args(csv_path, tmp_path / "auto"))
        assert {k: r["pred"] for k, r in results.items()} == \
            {k: r["pred"] for k, r in base.items()}


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(BASE[:2] + ["--device", "cuda"])


@pytest.mark.cuda
@pytest.mark.parametrize("shared_prefix", ["true", "false"])
def test_serve_cuda_launches_its_kernels(csv_path, tmp_path, shared_prefix):
    """bf16 on the card: with the shared prefix (dedup), K1 runs for the
    prefix prefill, K6 per layer and prefix install, K9a per layer and
    decode step; without it, K1 per layer and install and K4 per layer and
    decode step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    args = cli.build_parser().parse_args(_args(
        csv_path, tmp_path, "--shared_prefix", shared_prefix,
        device="cuda", dtype="bf16"))
    tok = ByteTextTokenizer()
    dev = torch.device("cuda")
    cfg, params = cli.build_server(args, tok, dev)
    batches = [cli.make_collator(args, tok)(
        [dict(zip(CSV_ROWS.splitlines()[0].split(","), line.split(",")))
         for line in CSV_ROWS.strip().splitlines()[1 + i:3 + i]])
        for i in (0, 2, 4)]
    reset_launch_counts()
    run = cli.serve(args, tok, cfg, params, batches, dev)
    counts = launch_counts()
    eng, L = run.engine, cfg.llm_config.num_layers
    assert len(run.results) == 5
    if shared_prefix == "true":
        assert run.prefix_len >= 16
        assert counts["K9a"] == L * eng.steps and counts["K4"] == 0
        assert counts["K6"] == L * eng.installs["prefix"]
        assert counts["K1"] == L * (1 + eng.installs["full"])
    else:
        assert counts["K4"] == L * eng.steps and counts["K9a"] == 0
        assert counts["K6"] == 0
        assert counts["K1"] == L * eng.installs["full"]
    assert counts["K2"] == counts["K3"] == counts["K5"] == 0
