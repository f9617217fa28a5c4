"""HF checkpoint → the port's parameter trees (counterpart of
prot2text_tpu/models/hf_import.py).

`load_state_dict_dir` reads a directory of `*.safetensors` files (read by
this module, no `safetensors` package needed) or, failing those, of
`*.bin` files (`torch.load`); `write_safetensors` writes the format.  The
converters turn an HF `EsmModel`,
`LlamaForCausalLM` or `Qwen3ForCausalLM` state dict into the tree the
port's `init_*_params` build: kernels stored (in, out), per-layer tensors
stacked along a leading (num_layers, ...) axis, every leaf contiguous on
`device` in `dtype`.

The JAX converters make an fp32 numpy copy of every tensor first; these
write each source tensor, cast and transposed, straight into its slot of a
preallocated stacked leaf on `device`, and drop it from the (prefix-
stripped) state dict once copied, so no fp32 copy of the model exists
unless `dtype` asks for fp32.  The casts round as JAX's do (a 16-bit
source to fp32 is exact; fp32 to bf16 rounds to nearest even), so the
trees are bit-identical to JAX's at the same dtype.
"""

from __future__ import annotations

import json
import mmap
import os
from typing import Mapping

import torch

# safetensors dtype names → torch
ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
             "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
             "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
             "BOOL": torch.bool}


def read_safetensors(path: str) -> dict:
    """The tensors of one safetensors file, {name: tensor} in the file's
    dtypes and shapes, backed by a copy-on-write memory map of the file.
    The format: an 8-byte little-endian header length, a JSON header of
    {name: {"dtype", "shape", "data_offsets": [begin, end]}} (and an
    optional "__metadata__"), then the raw bytes, offsets counted from the
    header's end.  A header that does not describe the file raises
    ValueError."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        head = f.read(8)
        n = int.from_bytes(head, "little") if len(head) == 8 else -1
        if not 0 < n <= size - 8:
            raise ValueError(f"{path}: header length {n} does not fit the "
                             f"file's {size} bytes")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: the header is not JSON ({e})") from e
        if not isinstance(header, dict):
            raise ValueError(f"{path}: the header is not a JSON object")
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if size > 8 + n else None)
    base, out = 8 + n, {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = ST_DTYPES[info["dtype"]]
            shape = [int(d) for d in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: bad header entry {name!r}: "
                             f"{info!r}") from e
        numel = 1
        for d in shape:
            numel *= d
        nbytes = numel * torch.empty((), dtype=dtype).element_size()
        if min(shape, default=0) < 0 or begin < 0 or \
                end - begin != nbytes or base + end > size:
            raise ValueError(f"{path}: {name!r} ({info['dtype']} {shape}) "
                             f"does not match its offsets {begin}, {end}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=numel,
                                         offset=base + begin).view(shape)
    return out


def write_safetensors(path: str, tensors: Mapping) -> str:
    """`tensors` {name: tensor} as the safetensors file `path`, the format
    `read_safetensors` reads (and HF's `safetensors` package): the 8-byte
    header length, the JSON header of each tensor's dtype, shape and
    offsets (padded with spaces to 8 bytes), then the raw bytes in the
    header's order, one tensor copied to the host at a time."""
    names = {v: k for k, v in ST_DTYPES.items()}
    header, offset = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().view(-1).view(
                torch.uint8).numpy())
    return path


def load_state_dict_dir(path: str) -> dict:
    """Every tensor under `path`: all `*.safetensors` files in sorted order
    (a sharded checkpoint), else all `*.bin` files
    (`torch.load(map_location="cpu", weights_only=True)`), else
    FileNotFoundError.  Tensors keep the files' dtypes."""
    names = sorted(os.listdir(path))
    sd = {}
    st_files = [n for n in names if n.endswith(".safetensors")]
    if st_files:
        for n in st_files:
            sd.update(read_safetensors(os.path.join(path, n)))
        return sd
    bins = [n for n in names if n.endswith(".bin")]
    if bins:
        for n in bins:
            sd.update(torch.load(os.path.join(path, n), map_location="cpu",
                                 weights_only=True))
        return sd
    raise FileNotFoundError(f"no checkpoint files in {path}")


def _strip_prefix(sd: Mapping, prefixes) -> dict:
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


class _Converter:
    """Takes tensors out of a state dict, each cast and (for kernels)
    transposed into a new contiguous leaf on `device` in `dtype`."""

    def __init__(self, sd: dict, num_layers: int, device, dtype):
        self.sd, self.L, self.device, self.dtype = sd, num_layers, device, \
            dtype

    def has(self, key: str) -> bool:
        return key in self.sd

    def leaf(self, key: str, transpose: bool = False):
        src = self.sd.pop(key)
        out = torch.empty(src.T.shape if transpose else src.shape,
                          dtype=self.dtype, device=self.device)
        out.copy_(src.T if transpose else src)
        return out

    def stacked(self, key: str, transpose: bool = False):
        """`key` holds "{i}" for the layer: the L tensors in one (L, ...)
        leaf, each written into its slot."""
        out = None
        for i in range(self.L):
            src = self.sd.pop(key.format(i=i))
            if transpose:
                src = src.T
            if out is None:
                out = torch.empty((self.L, *src.shape), dtype=self.dtype,
                                  device=self.device)
            out[i].copy_(src)
            del src
        return out

    def dense(self, pre: str, bias: bool = True) -> dict:
        p = {"kernel": self.stacked(pre + ".weight", transpose=True)}
        if bias and self.has(pre.format(i=0) + ".bias"):
            p["bias"] = self.stacked(pre + ".bias")
        return p

    def norm(self, pre: str, layered: bool = True) -> dict:
        get = self.stacked if layered else self.leaf
        p = {"scale": get(pre + ".weight")}
        if self.has((pre.format(i=0) if layered else pre) + ".bias"):
            p["bias"] = get(pre + ".bias")
        return p


def esm2_params_from_hf(sd: Mapping, num_layers: int, *, device="cpu",
                        dtype=torch.float32) -> dict:
    """An HF `EsmModel` state dict (keys with or without the "esm." or
    "esm_encoder." prefix) → the port's ESM2 tree (`init_esm2_params`)."""
    c = _Converter(_strip_prefix(sd, ("esm.", "esm_encoder.")), num_layers,
                   device, dtype)
    pre = "encoder.layer.{i}"
    return {
        "word_embeddings": c.leaf("embeddings.word_embeddings.weight"),
        "layers": {
            "attn_ln": c.norm(f"{pre}.attention.LayerNorm"),
            "query": c.dense(f"{pre}.attention.self.query"),
            "key": c.dense(f"{pre}.attention.self.key"),
            "value": c.dense(f"{pre}.attention.self.value"),
            "attn_out": c.dense(f"{pre}.attention.output.dense"),
            "mlp_ln": c.norm(f"{pre}.LayerNorm"),
            "intermediate": c.dense(f"{pre}.intermediate.dense"),
            "output": c.dense(f"{pre}.output.dense"),
        },
        "final_ln": c.norm("encoder.emb_layer_norm_after", layered=False),
    }


def decoder_params_from_hf(sd: Mapping, num_layers: int, *, device="cpu",
                           dtype=torch.float32, qk_norm: bool = False,
                           tie_word_embeddings: bool = False) -> dict:
    """An HF Llama / Qwen3 causal-LM state dict (keys with or without the
    "model." prefix) → the port's decoder tree (`init_decoder_params`):
    with `qk_norm` the per-head q/k norms, and unless `tie_word_embeddings`
    an `lm_head` kernel, from `lm_head.weight` or, where the checkpoint has
    none, the embedding transposed."""
    c = _Converter(_strip_prefix(sd, ("model.",)), num_layers, device, dtype)
    pre = "layers.{i}"
    layers = {
        "input_ln": c.norm(f"{pre}.input_layernorm"),
        "q_proj": c.dense(f"{pre}.self_attn.q_proj"),
        "k_proj": c.dense(f"{pre}.self_attn.k_proj"),
        "v_proj": c.dense(f"{pre}.self_attn.v_proj"),
        "o_proj": c.dense(f"{pre}.self_attn.o_proj"),
        "post_attn_ln": c.norm(f"{pre}.post_attention_layernorm"),
        "gate_proj": c.dense(f"{pre}.mlp.gate_proj"),
        "up_proj": c.dense(f"{pre}.mlp.up_proj"),
        "down_proj": c.dense(f"{pre}.mlp.down_proj"),
    }
    if qk_norm:
        layers["q_norm"] = c.norm(f"{pre}.self_attn.q_norm")
        layers["k_norm"] = c.norm(f"{pre}.self_attn.k_norm")
    params = {"embed_tokens": c.leaf("embed_tokens.weight"),
              "layers": layers,
              "final_ln": c.norm("norm", layered=False)}
    if not tie_word_embeddings:
        params["lm_head"] = {"kernel": (
            c.leaf("lm_head.weight", transpose=True) if c.has("lm_head.weight")
            else params["embed_tokens"].T.contiguous())}
    return params


llama_params_from_hf = decoder_params_from_hf


def qwen3_params_from_hf(sd: Mapping, num_layers: int, *, device="cpu",
                         dtype=torch.float32,
                         tie_word_embeddings: bool = False) -> dict:
    return decoder_params_from_hf(sd, num_layers, device=device, dtype=dtype,
                                  qk_norm=True,
                                  tie_word_embeddings=tie_word_embeddings)


def num_layers_in(sd: Mapping, prefixes, stem: str) -> int:
    """1 + the largest layer index among the keys `{stem}{i}.` once a
    prefix is stripped ("encoder.layer." for ESM2, "layers." for a
    decoder)."""
    idx = [int(k[len(stem):].split(".", 1)[0])
           for k in _strip_prefix(sd, prefixes) if k.startswith(stem)]
    if not idx:
        raise ValueError(f"no '{stem}N.' keys in the state dict")
    return 1 + max(idx)
