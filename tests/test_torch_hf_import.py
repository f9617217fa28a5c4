"""The port's HF weight loader (`prot2text_tpu_torch/models/hf_import.py`)
against `safetensors` and the JAX package, on tiny `transformers` models
saved by the tests themselves (no real weights are in the repository):

  * its safetensors reader gives what `safetensors.torch.load_file` gives
    on every dtype it maps, an empty tensor and a checkpoint sharded into
    two files; a header that does not describe its file raises;
  * its converters give trees bit-identical, leaf for leaf, to JAX's
    (`esm2_params_from_hf`, `decoder_params_from_hf`,
    `qwen3_params_from_hf`) for `EsmModel`, `LlamaForCausalLM` tied and
    untied and `Qwen3ForCausalLM`, saved in f32 and bf16, as safetensors
    and `.bin`, with and without the "esm."/"model." prefixes, converted to
    f32 and to bf16 (JAX reads every directory itself, and a bf16 one's
    tensors are also handed to it in memory);
  * numpy alone cannot read a bf16 safetensors file (JAX's route reads
    one only through ml_dtypes, which importing jax registers); the port
    reads the format itself;
  * the port's legacy model (`Esm2LlamaForCausalLM.from_pretrained`) and a
    tiny ESMC + Qwen3 (`cli/common.py build_models --llm_checkpoint_dir`)
    built from loaded weights match the JAX package on the same weights:
    f32 logits within 1e-5, greedy tokens identical.

`transformers` is imported inside the fixtures only (an import takes
seconds), with TensorFlow left out (`USE_TF=0`)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.models import hf_import as jhf
from prot2text_tpu_torch.models import hf_import as thf
from prot2text_tpu_torch.models.weights import params_from_jax, tree_to_numpy

ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """{name: model}: tiny HF models, two layers each, random weights."""
    os.environ.setdefault("USE_TF", "0")
    import transformers as tr

    torch.manual_seed(0)
    llama = dict(vocab_size=300, hidden_size=128, intermediate_size=192,
                 num_hidden_layers=2, num_attention_heads=2,
                 num_key_value_heads=1, rope_theta=1e4, rms_norm_eps=1e-5)
    models = {
        "esm": tr.EsmModel(tr.EsmConfig(
            vocab_size=33, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=96, pad_token_id=1,
            mask_token_id=32, position_embedding_type="rotary",
            token_dropout=True, emb_layer_norm_before=False,
            layer_norm_eps=1e-5)),
        "llama_untied": tr.LlamaForCausalLM(tr.LlamaConfig(
            **llama, tie_word_embeddings=False)),
        "llama_tied": tr.LlamaForCausalLM(tr.LlamaConfig(
            **llama, tie_word_embeddings=True)),
        "qwen3": tr.Qwen3ForCausalLM(tr.Qwen3Config(
            vocab_size=300, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, rope_theta=1e6,
            tie_word_embeddings=False)),
    }
    for m in models.values():
        with torch.no_grad():        # norms away from 1, biases away from 0
            for name, p in m.named_parameters():
                if "norm" in name.lower() or name.endswith(".bias"):
                    p.add_(torch.randn_like(p) * 0.1)
    return models


def state_dict(model, dtype, prefix: bool) -> dict:
    """The model's tensors as a checkpoint holds them: cloned, in `dtype`,
    a tied head left out; `prefix` True: ESM under "esm.", a decoder as
    its CausalLM keys ("model."), False: ESM bare, a decoder stripped of
    "model."."""
    sd = {k: v.detach().to(dtype).clone() for k, v in
          model.state_dict().items()}
    if getattr(model.config, "tie_word_embeddings", False):
        sd.pop("lm_head.weight", None)
    if model.config.model_type == "esm":
        return {("esm." + k if prefix else k): v for k, v in sd.items()}
    return {(k if prefix else k.removeprefix("model.")): v
            for k, v in sd.items()}


def save_dir(sd: dict, path, fmt: str, shards: int = 1) -> str:
    """`sd` written to the directory `path` as safetensors or `.bin`,
    split into `shards` files."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    keys = sorted(sd)
    for i in range(shards):
        part = {k: sd[k] for k in keys[i::shards]}
        if fmt == "safetensors":
            save_file(part, os.path.join(
                path, f"model-{i + 1:05d}-of-{shards:05d}.safetensors"),
                metadata={"format": "pt"})
        else:
            torch.save(part, os.path.join(
                path, f"pytorch_model-{i + 1:05d}-of-{shards:05d}.bin"))
    return str(path)


def leaves(tree) -> dict:
    """{path: f32 numpy} of a JAX tree or the port's."""
    if isinstance(tree, dict) and any(torch.is_tensor(x) for x in
                                      jax.tree_util.tree_leaves(tree)):
        tree = tree_to_numpy(tree)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(x).astype(np.float32)
            for p, x in flat}


def assert_same_tree(got, want):
    g, w = leaves(got), leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def convert(name, sd, L, lib, dtype):
    """The converter of model `name` from the JAX package (lib "jax") or
    the port's, at `dtype` ("f32" or "bf16")."""
    tied = name == "llama_tied"
    if lib == "jax":
        dt = jnp.float32 if dtype == "f32" else jnp.bfloat16
        if name == "esm":
            return jhf.esm2_params_from_hf(sd, L, dt)
        if name == "qwen3":
            return jhf.qwen3_params_from_hf(sd, L, dt)
        return jhf.decoder_params_from_hf(sd, L, dt, tie_word_embeddings=tied)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    if name == "esm":
        return thf.esm2_params_from_hf(sd, L, dtype=dt)
    if name == "qwen3":
        return thf.qwen3_params_from_hf(sd, L, dtype=dt)
    return thf.llama_params_from_hf(sd, L, dtype=dt,
                                    tie_word_embeddings=tied)


# ---------------------------------------------------------------------------
# the reader


def test_reader_matches_safetensors_on_every_dtype(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(1)
    sd = {"f32": torch.randn(3, 4, generator=g),
          "f16": torch.randn(5, generator=g).half(),
          "bf16": torch.randn(2, 3, 2, generator=g).bfloat16(),
          "i64": torch.arange(-3, 4), "i32": torch.arange(6,
                                                          dtype=torch.int32),
          "i16": torch.tensor([1, -2, 300], dtype=torch.int16),
          "i8": torch.tensor([[1, -2], [127, -128]], dtype=torch.int8),
          "u8": torch.tensor([0, 200, 255], dtype=torch.uint8),
          "bool": torch.tensor([True, False, True]),
          "scalar": torch.tensor(2.5), "empty": torch.empty(0, 3),
          "empty_bf16": torch.empty(4, 0, dtype=torch.bfloat16)}
    path = str(tmp_path / "all.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got, want = thf.read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    assert set(thf.ST_DTYPES.values()) == {t.dtype for t in sd.values()}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_state_dict_dir_reads_two_shards(tmp_path, fmt):
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(2)
    sd = {f"w{i}": torch.randn(i + 1, 3, generator=g).bfloat16()
          for i in range(5)}
    d = save_dir(sd, tmp_path / "d", fmt, shards=2)
    assert len(os.listdir(d)) == 2
    got = thf.load_state_dict_dir(d)
    assert sorted(got) == sorted(sd)
    for k in sd:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], sd[k])
    if fmt == "safetensors":
        want = {}
        for n in sorted(os.listdir(d)):
            want.update(load_file(os.path.join(d, n)))
        assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError):
        thf.load_state_dict_dir(str(tmp_path))


def _corrupt(raw: bytes, how: str) -> bytes:
    n = int.from_bytes(raw[:8], "little")
    header = raw[8:8 + n]
    if how == "length past the end":
        return (len(raw) + 1).to_bytes(8, "little") + raw[8:]
    if how == "not json":
        return raw[:8] + b"{" + header[1:-1].replace(b'"', b"'") + \
            b"}" + raw[8 + n:]
    if how == "offsets past the end":
        return raw[:-4]
    if how == "bad dtype":
        return raw[:8] + header.replace(b'"F32"', b'"F99"') + raw[8 + n:]
    if how == "truncated":
        return raw[:6]
    raise ValueError(how)


@pytest.mark.parametrize("how", ["length past the end", "not json",
                                 "offsets past the end", "bad dtype",
                                 "truncated"])
def test_reader_refuses_a_corrupt_header(tmp_path, how):
    from safetensors.torch import save_file

    path = tmp_path / "x.safetensors"
    save_file({"a": torch.ones(4, 4), "b": torch.zeros(3)}, str(path))
    path.write_bytes(_corrupt(path.read_bytes(), how))
    with pytest.raises(ValueError):
        thf.read_safetensors(str(path))


# ---------------------------------------------------------------------------
# the converters against JAX's


CASES = [(name, fmt, file_dtype, prefix)
         for name in ("esm", "llama_untied", "llama_tied", "qwen3")
         for fmt in ("safetensors", "bin")
         for file_dtype in ("f32", "bf16")
         for prefix in (True, False)]


@pytest.mark.parametrize("name,fmt,file_dtype,prefix", CASES)
def test_converters_match_jax(models, tmp_path, name, fmt, file_dtype,
                              prefix):
    model = models[name]
    L = model.config.num_hidden_layers
    tdt = torch.float32 if file_dtype == "f32" else torch.bfloat16
    sd = state_dict(model, tdt, prefix)
    d = save_dir(sd, tmp_path / "ckpt", fmt)
    loaded = thf.load_state_dict_dir(d)
    assert all(loaded[k].dtype == tdt for k in sd)
    # JAX reads the directory itself (bf16 through ml_dtypes, which jax
    # registers with numpy); a bf16 one it is also handed in memory
    jsds = [jhf.load_state_dict_dir(d)] + ([sd] if file_dtype == "bf16"
                                           else [])
    for dtype in ("f32", "bf16"):
        got = convert(name, dict(loaded), L, "torch", dtype)
        for jsd in jsds:
            assert_same_tree(got, convert(name, jsd, L, "jax", dtype))
        want_dt = torch.float32 if dtype == "f32" else torch.bfloat16
        for t in jax.tree_util.tree_leaves(got):
            assert t.dtype == want_dt and t.is_contiguous()
    if name != "esm":
        assert ("lm_head" in got) == (name != "llama_tied")


def test_untied_decoder_without_a_head_takes_the_embedding(models):
    """An untied model whose checkpoint has no lm_head.weight (a bare
    LlamaModel) gets the embedding transposed as its head, as in JAX."""
    model = models["llama_untied"]
    sd = state_dict(model, torch.float32, prefix=False)
    sd.pop("lm_head.weight")
    got = thf.decoder_params_from_hf(dict(sd), 2)
    want = jhf.decoder_params_from_hf(sd, 2, jnp.float32)
    assert_same_tree(got, want)
    assert torch.equal(got["lm_head"]["kernel"], got["embed_tokens"].T)
    assert got["lm_head"]["kernel"].is_contiguous()


def test_num_layers_with_and_without_prefixes(models):
    for name, prefixes, stem in (("esm", ("esm.",), "encoder.layer."),
                                 ("qwen3", ("model.",), "layers.")):
        for prefix in (True, False):
            sd = state_dict(models[name], torch.float32, prefix)
            assert thf.num_layers_in(sd, prefixes, stem) == 2
    with pytest.raises(ValueError, match="layers"):
        thf.num_layers_in({"x": torch.ones(1)}, ("model.",), "layers.")


def test_bf16_safetensors_read_by_numpy_only_through_ml_dtypes(models,
                                                               tmp_path):
    """JAX reads safetensors through numpy (`safe_open(..., framework=
    "np")`, prot2text_tpu/models/hf_import.py:56).  numpy alone has no
    bfloat16: in an interpreter that has not imported `ml_dtypes` the read
    of a bf16 file raises TypeError.  JAX's loader works all the same,
    because importing jax registers ml_dtypes' bfloat16 with numpy; it then
    gives the port's tensors, value for value.  The port reads the format
    itself, with torch's bfloat16."""
    import subprocess
    import sys

    sd = state_dict(models["qwen3"], torch.bfloat16, prefix=True)
    d = save_dir(sd, tmp_path / "bf16", "safetensors")
    f = os.path.join(d, os.listdir(d)[0])
    probe = ("import sys\nfrom safetensors import safe_open\n"
             "try:\n    with safe_open(sys.argv[1], framework='np') as f:\n"
             "        [f.get_tensor(k) for k in f.keys()]\n"
             "except TypeError as e:\n    print('TypeError', e)\n"
             "print('ml_dtypes' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", probe, f], check=True,
                         capture_output=True, text=True).stdout.split("\n")
    assert out[0].startswith("TypeError") and "bfloat16" in out[0]
    assert out[1] == "False"
    got = thf.load_state_dict_dir(d)
    want = jhf.load_state_dict_dir(d)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], sd[k])
        assert str(want[k].dtype) == "bfloat16"
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      want[k].astype(np.float32))


def test_adapter_converter_matches_jax():
    from prot2text_tpu.models import adapters as ja
    from prot2text_tpu_torch.models import adapters as ta

    g = torch.Generator().manual_seed(3)
    sd = {"adapter.fc1.weight": torch.randn(12, 8, generator=g),
          "adapter.fc1.bias": torch.randn(12, generator=g),
          "adapter.fc2.weight": torch.randn(32, 12, generator=g),
          "adapter.fc2.bias": torch.randn(32, generator=g),
          "adapter.ln1.weight": torch.ones(12),
          "adapter.ln1.bias": torch.zeros(12)}
    got = ta.modality_adapter_params_from_torch(sd, prefix="adapter.")
    assert_same_tree(got, ja.modality_adapter_params_from_torch(
        sd, jnp.float32, prefix="adapter."))
    assert set(got) == {"fc1", "fc2"}
    bf = ta.modality_adapter_params_from_torch(
        {k.removeprefix("adapter."): v for k, v in sd.items()},
        dtype=torch.bfloat16)
    assert bf["fc2"]["kernel"].dtype == torch.bfloat16
    assert bf["fc2"]["kernel"].is_contiguous()


# ---------------------------------------------------------------------------
# models built from loaded weights against JAX on the same weights


def test_legacy_model_from_hf_dirs_matches_jax(models, tmp_path):
    """`Esm2LlamaForCausalLM.from_pretrained(esm_checkpoint_dir=...,
    llama_checkpoint_dir=...)` in both packages on f32 safetensors: the
    towers bit-identical; with JAX's random adapter given to the port,
    logits at the valid positions within 1e-5 and greedy generation
    identical.  The port also reads bf16 directories: its towers then
    equal JAX's converters on the same tensors."""
    from prot2text_tpu.models import composed as jc
    from prot2text_tpu.models import esm2 as je
    from prot2text_tpu.models import llama as jl
    from prot2text_tpu_torch.models import composed as tc
    from prot2text_tpu_torch.models import esm2 as te
    from prot2text_tpu_torch.models import llama as tl

    esm = dict(hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=96)
    llama = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
                 num_kv_heads=1, intermediate_size=192, rope_theta=1e4,
                 tie_word_embeddings=False, rope_scaling=None)
    jcfg = jc.Esm2LlamaConfig(je.ESM2Config(**esm), jl.LlamaConfig(**llama),
                              128, 256, 257)
    tcfg = tc.Esm2LlamaConfig(te.ESM2Config(**esm), tl.LlamaConfig(**llama),
                              128, 256, 257)
    dirs = {}
    for fdt in ("f32", "bf16"):
        tdt = torch.float32 if fdt == "f32" else torch.bfloat16
        dirs[fdt] = [save_dir(state_dict(models[n], tdt, prefix=True),
                              tmp_path / f"{n}_{fdt}", "safetensors")
                     for n in ("esm", "llama_untied")]
    jm = jc.Esm2LlamaForCausalLM.from_pretrained(
        jcfg, esm_checkpoint_dir=dirs["f32"][0],
        llama_checkpoint_dir=dirs["f32"][1], rng=jax.random.PRNGKey(0))
    tm = tc.Esm2LlamaForCausalLM.from_pretrained(
        tcfg, esm_checkpoint_dir=dirs["f32"][0],
        llama_checkpoint_dir=dirs["f32"][1])
    for part in ("esm_encoder", "llama_decoder"):
        assert_same_tree(tm.params()[part], jm.params[part])
    tb = tc.Esm2LlamaForCausalLM.from_pretrained(
        tcfg, esm_checkpoint_dir=dirs["bf16"][0],
        llama_checkpoint_dir=dirs["bf16"][1])
    bf = {n: state_dict(models[n], torch.bfloat16, prefix=True)
          for n in ("esm", "llama_untied")}
    assert_same_tree(tb.params()["esm_encoder"],
                     jhf.esm2_params_from_hf(bf["esm"], 2))
    assert_same_tree(tb.params()["llama_decoder"],
                     jhf.decoder_params_from_hf(bf["llama_untied"], 2))
    # the adapter is random in both: the port takes JAX's
    params = dict(tm.params())
    params["encoder_adapter"] = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.params["encoder_adapter"])).tree()
    tm = tc.Esm2LlamaForCausalLM(tcfg, params)
    rng = np.random.default_rng(4)
    B, Pp = 2, 10
    pids = np.ones((B, Pp), np.int64)
    pmask = np.zeros((B, Pp), np.int64)
    for b, n in enumerate((6, 8)):
        pids[b, Pp - n:] = np.r_[0, rng.integers(4, 24, n - 2), 2]
        pmask[b, Pp - n:] = 1
    ids = np.tile(np.r_[256, rng.integers(3, 250, 5), 256], (B, 1))
    batch = dict(input_ids=ids, attention_mask=np.ones_like(ids),
                 protein_input_ids=pids, protein_attention_mask=pmask)
    want = jc.Esm2LlamaForCausalLM.apply(
        jcfg, jm.params, **{k: jnp.asarray(v) for k, v in batch.items()},
        attn_impl="xla").logits
    got = tc.Esm2LlamaForCausalLM.apply(
        tcfg, tm.params(), **{k: torch.from_numpy(v)
                              for k, v in batch.items()}).logits
    valid = np.concatenate([pmask, batch["attention_mask"]], 1).astype(bool)
    np.testing.assert_allclose(got.detach().numpy()[valid],
                               np.asarray(want)[valid], atol=ATOL, rtol=0)
    gen = {("inputs" if k == "input_ids" else k): v for k, v in batch.items()}
    jtok = np.asarray(jm.generate(**{k: jnp.asarray(v)
                                     for k, v in gen.items()},
                                  max_new_tokens=5))
    ttok = tm.generate(**{k: torch.from_numpy(v) for k, v in gen.items()},
                       max_new_tokens=5)
    np.testing.assert_array_equal(ttok.numpy(), jtok)


def test_esmc_qwen3_from_llm_checkpoint_dir_matches_jax(models, tmp_path):
    """`build_models` with --llm_checkpoint_dir in both packages (the JAX
    one: prot2text_tpu/cli/train_contrast.py:114-118) on an f32 Qwen3
    directory: the Qwen3 towers bit-identical; with JAX's random ESMC and
    adapter given to the port, `ESMCQwen.generate`'s greedy tokens
    identical and its prefill logits within 1e-5 of JAX's teacher-forced
    forward."""
    from prot2text_tpu.cli import train_contrast as jtc
    from prot2text_tpu.data.chat import ByteTextTokenizer as JTok
    from prot2text_tpu.models import composed as jc
    from prot2text_tpu.models import decoder as jd
    from prot2text_tpu_torch.cli import common as tcommon
    from prot2text_tpu_torch.cli import train_contrast as ttc
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer as TTok
    from prot2text_tpu_torch.models import composed as tc

    tok = TTok()
    V = tok.vocab_size
    import transformers as tr       # the `models` fixture imported it

    torch.manual_seed(5)
    hf = tr.Qwen3ForCausalLM(tr.Qwen3Config(
        vocab_size=V, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, rope_theta=1e6, rms_norm_eps=1e-6,
        tie_word_embeddings=False))
    d = save_dir(state_dict(hf, torch.float32, prefix=True),
                 tmp_path / "qwen3", "safetensors")
    argv = ["--train_csv", "unused.csv", "--debug_tiny_model", "true",
            "--model_dtype", "fp32", "--llm_checkpoint_dir", d]
    jcfgs = jtc.build_models(jtc.build_parser().parse_args(argv), JTok())
    tcfgs = tcommon.build_models(ttc.build_parser().parse_args(argv), tok,
                                 torch.device("cpu"))
    (j_esm, j_llm, j_ad, j_towers, j_adapter) = jcfgs
    (t_esm, t_llm, t_ad, t_towers, _) = tcfgs
    assert_same_tree(t_towers["llm_decoder"], j_towers["llm_decoder"])
    assert_same_tree(t_towers["llm_decoder"], thf.qwen3_params_from_hf(
        state_dict(hf, torch.float32, prefix=True), 2))
    PH = tok.placeholder_id
    jcfg = jc.ESMCQwenConfig(j_esm, j_ad, j_llm, placeholder_id=PH)
    tcfg = tc.ESMCQwenConfig(t_esm, t_ad, t_llm, placeholder_id=PH)
    jm = jc.ESMCQwen(jcfg, params={**j_towers, "adapter": j_adapter},
                     attn_impl="auto")
    shared = params_from_jax(jax.tree_util.tree_map(np.asarray, {
        "esm_encoder": j_towers["esm_encoder"], "adapter": j_adapter})).tree()
    tm = tc.ESMCQwen(tcfg, {**shared,
                            "llm_decoder": t_towers["llm_decoder"]})
    seqs = ["MKTAYIAKQR", "GSHMLEDPV"]
    S, rng = 24, np.random.default_rng(6)
    ids = np.full((2, S), tok.pad_token_id, np.int64)
    mask = np.zeros((2, S), np.int64)
    for b, s in enumerate(seqs):
        text = list(rng.integers(0, 200, 4))
        row = text[:2] + [PH] * (len(s) + 2) + text[2:]
        ids[b, S - len(row):] = row
        mask[b, S - len(row):] = 1
    want = np.asarray(jm.generate(jnp.asarray(ids), jnp.asarray(mask),
                                  protein_sequences=seqs, max_new_tokens=5))
    stats = {}
    got = tm.generate(torch.from_numpy(ids), torch.from_numpy(mask),
                      protein_sequences=seqs, max_new_tokens=5, stats=stats)
    np.testing.assert_array_equal(got.numpy(), want)
    emb, m = jm.forward(protein_sequences=seqs, input_ids=jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask),
                        return_decoder_inputs=True)
    core = j_llm.core()
    pos = jnp.clip(jnp.cumsum(m, axis=1) - 1, 0, None).astype(jnp.int32)
    h, _ = jd.decoder_forward(
        core, j_towers["llm_decoder"], inputs_embeds=emb,
        bias=jd.causal_bias_from_mask(m), positions=pos, attn_impl="xla",
        attn_lengths=jd.contiguous_lengths(m))
    jlog = np.asarray(jd.decoder_logits(core, j_towers["llm_decoder"],
                                        h[:, -1:])[:, 0])
    np.testing.assert_allclose(stats["logits"][0].numpy(), jlog, atol=ATOL,
                               rtol=0)
