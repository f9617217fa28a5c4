"""The port's ESM2 encoder, modality adapter, placeholder fusion and
no-cache decoder against the JAX package on the same weights (JAX init →
numpy → `params_from_jax`) and the same numpy inputs (f32, atol 1e-5)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.models import adapters as ja
from prot2text_tpu.models import composed as jc
from prot2text_tpu.models import decoder as jd
from prot2text_tpu.models import esm2 as je
from prot2text_tpu.models import fusion as jf
from prot2text_tpu.models import llama as jl
from prot2text_tpu_torch.core.device import resolve_device
from prot2text_tpu_torch.models import adapters as ta
from prot2text_tpu_torch.models import composed as tc
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models import esm2 as te
from prot2text_tpu_torch.models import fusion as tf
from prot2text_tpu_torch.models import llama as tl
from prot2text_tpu_torch.models.weights import params_from_jax

ATOL = 1e-5
PH = 250          # placeholder id in the tiny vocab


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        out += (_paths(v, f"{prefix}{k}.") if isinstance(v, dict)
                else [prefix + k])
    return out


ESM = je.ESM2Config(hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64)


def _protein_batch():
    ids = np.array([[0, 5, 6, 32, 7, 8, 2, 1, 1],
                    [0, 4, 9, 10, 11, 12, 13, 14, 2]], np.int32)
    mask = (ids != 1).astype(np.int32)
    return ids, mask


def test_params_from_jax_keeps_tree_paths_and_layout():
    params = _np_tree(je.init_esm2_params(ESM, jax.random.PRNGKey(0)))
    tree = params_from_jax(params)
    assert sorted(tree.state_dict()) == sorted(_paths(params))
    k = tree.state_dict()["layers.query.kernel"]
    assert tuple(k.shape) == params["layers"]["query"]["kernel"].shape
    assert tuple(k.shape) == (2, 32, 32)         # stacked (L, in, out)
    np.testing.assert_array_equal(k.numpy(),
                                  params["layers"]["query"]["kernel"])
    assert not any(p.requires_grad for p in tree.parameters())
    bf = params_from_jax(params, dtype=torch.bfloat16)
    assert bf.state_dict()["word_embeddings"].dtype == torch.bfloat16


def test_esm2_hidden_states():
    params = je.init_esm2_params(ESM, jax.random.PRNGKey(1))
    ids, mask = _protein_batch()
    want = jax.jit(lambda p, i, m: je.esm2_encode(ESM, p, i, m))(
        params, ids, mask)
    got = te.esm2_encode(ESM, params_from_jax(_np_tree(params)).tree(),
                         torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_modality_adapter_and_l2_normalize():
    cfg = ja.ModalityAdapterConfig(32, 48, 24)
    params = ja.init_modality_adapter_params(cfg, jax.random.PRNGKey(2))
    x = np.random.default_rng(0).standard_normal((2, 5, 32)).astype(
        np.float32)
    want = ja.modality_adapter(cfg, params, jnp.asarray(x))
    tcfg = ta.ModalityAdapterConfig(32, 48, 24)
    got = ta.modality_adapter(tcfg, params_from_jax(_np_tree(params)).tree(),
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(
        ta.l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(ja.l2_normalize(jnp.asarray(x))), atol=1e-6, rtol=0)


def test_placeholder_merge_and_count_check():
    rng = np.random.default_rng(3)
    ids = np.array([[7, PH, PH, PH, 9, 3],
                    [PH, PH, 4, 4, 4, 4],
                    [1, 2, PH, 5, PH, PH]], np.int32)
    emb = rng.standard_normal((3, 6, 8)).astype(np.float32)
    enc = rng.standard_normal((3, 4, 8)).astype(np.float32)
    emask = np.array([[1, 1, 1, 0], [0, 1, 1, 0], [1, 0, 1, 1]], np.int32)
    want = jf.placeholder_merge(jnp.asarray(emb), jnp.asarray(ids),
                                jnp.asarray(enc), jnp.asarray(emask), PH)
    got = tf.placeholder_merge(torch.from_numpy(emb), torch.from_numpy(ids),
                               torch.from_numpy(enc), torch.from_numpy(emask),
                               PH)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tf.count_check(torch.from_numpy(ids), PH,
                       torch.from_numpy(emask)).numpy(),
        np.asarray(jf.count_check(jnp.asarray(ids), PH, jnp.asarray(emask))))


DEC_KW = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=96, head_dim=16,
              rope_theta=500000.0, rope_scaling="llama3",
              rope_scaling_factor=8.0)


def test_decoder_no_cache_logits():
    jcfg, tcfg = jd.DecoderConfig(**DEC_KW), td.DecoderConfig(**DEC_KW)
    params = jd.init_decoder_params(jcfg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    B, S = 3, 11
    x = (rng.standard_normal((B, S, 64)) * 0.5).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :4] = 0                     # left padding
    mask[2, 8:] = 0                     # right padding
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))

    def jax_logits(p, x, mask, pos):
        h, _ = jd.decoder_forward(
            jcfg, p, inputs_embeds=x, bias=jd.causal_bias_from_mask(mask),
            positions=pos, attn_impl="xla",
            attn_lengths=jd.contiguous_lengths(mask))
        return jd.decoder_logits(jcfg, p, h)

    want = np.asarray(jax.jit(jax_logits)(params, x, mask, pos))
    tp = params_from_jax(_np_tree(params)).tree()
    tmask = torch.from_numpy(mask)
    h, _ = td.decoder_forward(tcfg, tp, inputs_embeds=torch.from_numpy(x),
                              positions=torch.from_numpy(pos.copy()),
                              attn_lengths=td.contiguous_lengths(tmask))
    got = td.decoder_logits(tcfg, tp, h).numpy()
    # rows' valid positions; causal left-pad query rows have no valid key
    # (JAX: uniform average over masked keys; K1: exactly 0) by design
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)


def _tiny_composed():
    esm = ESM
    llama = jl.LlamaConfig.tiny(vocab_size=256)
    llama = jl.LlamaConfig(**{**llama.__dict__, "placeholder_id": PH})
    jcfg = jc.Esm2LlamaInstructConfig(
        esm, ja.ModalityAdapterConfig(32, 48, llama.hidden_size), llama, PH)
    tcfg = tc.Esm2LlamaInstructConfig(
        te.ESM2Config(**esm.__dict__),
        ta.ModalityAdapterConfig(32, 48, llama.hidden_size),
        tl.LlamaConfig(**llama.__dict__), PH)
    return jcfg, tcfg


def test_composed_apply_switches_and_logits():
    jcfg, tcfg = _tiny_composed()
    jm = jc.Esm2LlamaInstructForCausalLM(jcfg, rng=jax.random.PRNGKey(5))
    tm = tc.Esm2LlamaInstructForCausalLM(
        tcfg, params_from_jax(_np_tree(jm.params)))
    pids, pmask = _protein_batch()
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 200, (2, 14)).astype(np.int32)
    ids[0, 3:9] = PH                        # 6 protein tokens in row 0
    ids[1, 4:13] = PH                       # 9 in row 1
    mask = np.ones_like(ids)
    labels = np.where(ids == PH, -100, ids).astype(np.int32)
    kw = dict(input_ids=ids, attention_mask=mask, protein_input_ids=pids,
              protein_attention_mask=pmask)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    jout = jm(**kw, labels=labels)
    tout = tm(**tkw, labels=torch.from_numpy(labels))
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tout.loss.numpy(), np.asarray(jout.loss),
                               atol=ATOL, rtol=0)
    for switch in ("return_encoder_outputs", "return_adapter_outputs",
                   "return_decoder_inputs"):
        j = jm(**kw, **{switch: True})
        t = tm(**tkw, **{switch: True})
        j0 = j[0] if isinstance(j, tuple) else j
        t0 = t[0] if isinstance(t, tuple) else t
        np.testing.assert_allclose(t0.numpy(), np.asarray(j0), atol=ATOL,
                                   rtol=0)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            resolve_device("cuda")


@pytest.mark.parametrize("use_embeds", [False, True])
def test_esm2_matches_hf_esm_model(use_embeds):
    """The HF oracle of tests/test_esm2_parity.py: EsmModel with random tiny
    weights, mapped to the JAX layout by the JAX package's importer."""
    from transformers import EsmConfig, EsmModel

    from prot2text_tpu.models.hf_import import esm2_params_from_hf

    torch.manual_seed(0)
    hf_cfg = EsmConfig(
        vocab_size=33, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=512, position_embedding_type="rotary",
        pad_token_id=1, mask_token_id=32, token_dropout=True,
        layer_norm_eps=1e-5, emb_layer_norm_before=False,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = EsmModel(hf_cfg, add_pooling_layer=False).eval()
    cfg = te.ESM2Config(vocab_size=33, hidden_size=64, num_layers=3,
                        num_heads=4, intermediate_size=128)
    params = params_from_jax(_np_tree(
        esm2_params_from_hf(model.state_dict(), cfg.num_layers))).tree()
    rng = np.random.default_rng(0)
    if use_embeds:
        embeds = torch.from_numpy(
            rng.standard_normal((2, 9, 64)).astype(np.float32))
        mask = torch.ones((2, 9), dtype=torch.int64)
        with torch.no_grad():
            ref = model(inputs_embeds=embeds,
                        attention_mask=mask).last_hidden_state
        out = te.esm2_encode(cfg, params, attention_mask=mask,
                             inputs_embeds=embeds)
        valid = mask.bool()
    else:
        ids = torch.ones((3, 17), dtype=torch.int64)
        mask = torch.zeros((3, 17), dtype=torch.int64)
        for b, L in enumerate((17, 11, 5)):
            ids[b, 0], ids[b, L - 1] = 0, 2
            ids[b, 1:L - 1] = torch.from_numpy(rng.integers(4, 24, L - 2))
            mask[b, :L] = 1
        ids[0, 3] = 32                  # a mask token: token-dropout scaling
        with torch.no_grad():
            ref = model(input_ids=ids, attention_mask=mask).last_hidden_state
        out = te.esm2_encode(cfg, params, ids, mask)
        valid = mask.bool()
    # HF's fp32 order of operations differs from both packages'
    torch.testing.assert_close(out[valid], ref[valid], atol=3e-5, rtol=3e-5)
