"""In-place KV-cache slot writes (CUDA C++), one kernel per cache layout
(`models/decoder.kv_cache_layout`):

* K3, `cache_slot_write_bkt`: the (L, B, Hkv, T, D) cache.  Replaces
  prot2text_tpu/kernels/cache_update.py `cache_slot_write_bkt`
  (`_write_group_kernel`).  No model path of the port calls it: the bf16
  lockstep step writes its slot inside K4 per layer (JAX's fused-write
  route); JAX's default lockstep step still calls it
  (prot2text_tpu/models/decoder.py:1008-1011).
* K12, `cache_slot_write`: the sequence-leading (L, T, B, Hkv, D) cache of
  D=64 decoders.  Replaces `cache_slot_write` (`_write_kernel`).  No model
  path of the port calls it: the tbkd lockstep step writes each layer's
  slot in K4's epilogue at the tbkd strides (`decode_attention_stacked_
  write(..., layout="tbkd")`); JAX's tbkd step still writes k and v with
  two K12 calls after the layer loop (prot2text_tpu/models/decoder.py:
  1139-1143).
* K13, `cache_slot_write_kv`: K12 for the k and v caches in one launch.
  Replaces `cache_slot_write_kv` (`_write_kv_kernel`).  No path of either
  package calls it (JAX: tests/test_flash_attention.py:142).

The kernels are `csrc/cache_update.cu`; its comments state what bounds them
(bytes and launch latency) and their design.  Each `*_plain` function is
the plain PyTorch version (slice assignment); kernel and plain version are
bit-identical.  At the path's shapes K12/K13 are about a launch, so their
wrappers keep the host path short, as `probe_int8_kv`'s: one device
comparison a tensor (`_build.require_cuda`), shape arithmetic, one ctypes
call on the raw stream.
"""

from __future__ import annotations

from . import _build


def cache_slot_write_bkt_plain(cache, new, index: int):
    cache[:, :, :, index] = new
    return cache


def cache_slot_write_plain(cache, new, index: int):
    cache[:, index] = new
    return cache


def cache_slot_write_kv_plain(cache_k, cache_v, new_k, new_v, index: int):
    cache_k[:, index] = new_k
    cache_v[:, index] = new_v
    return cache_k, cache_v


def _check(cache, new, index, kid, slot_dim):
    """Device, rank, shape, dtype, contiguity and slot of one cache and its
    new rows: (L, B, Hkv, T, D) with slot_dim 3 (K3); new is the cache's
    shape without T."""
    if cache.device.type != "cuda" or new.device != cache.device:
        raise ValueError(f"{kid} kernel needs CUDA tensors on one device, "
                         f"got {cache.device} and {new.device}")
    if cache.dim() != 5:
        raise ValueError(f"{kid}: cache must have 5 dims, got "
                         f"{tuple(cache.shape)}")
    want = cache.shape[:slot_dim] + cache.shape[slot_dim + 1:]
    if new.shape != want:
        raise ValueError(f"{kid}: new {tuple(new.shape)} vs cache "
                         f"{tuple(cache.shape)}")
    if new.dtype != cache.dtype:
        raise TypeError(f"{kid}: new is {new.dtype}, cache is {cache.dtype}")
    if not (cache.is_contiguous() and new.is_contiguous()):
        raise ValueError(f"{kid}: cache and new must be contiguous")
    T = cache.shape[slot_dim]
    if not 0 <= index < T:
        raise ValueError(f"{kid}: slot {index} out of range [0, {T})")


def cache_slot_write_bkt(cache, new, index: int):
    """K3: cache[:, :, :, index] = new, in place; returns cache.  CPU
    tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if cache.device.type == "cpu":
        return cache_slot_write_bkt_plain(cache, new, index)
    index = int(index)
    _check(cache, new, index, "K3", 3)
    L, B, Hkv, T, D = cache.shape
    lib = _build.library()
    err = lib.p2t_cache_slot_write(
        cache.data_ptr(), new.data_ptr(), L * B * Hkv, T, index,
        D * cache.element_size(), _build.stream_of(cache))
    _build.check(err, "p2t_cache_slot_write")
    cache_slot_write_bkt.launches += 1
    return cache


cache_slot_write_bkt.launches = 0


def _tbkd_shape(kid, cache, new, index):
    """(L, T, run bytes) of a (L, T, B, Hkv, D) cache and its (L, B, Hkv, D)
    new rows of one dtype, the slot in [0, T); raises otherwise.  Devices
    and contiguity are `_build.require_cuda`'s, checked after this."""
    shape = cache.shape
    if len(shape) != 5 or new.dim() != 4 or new.shape[0] != shape[0] \
            or new.shape[1:] != shape[2:]:
        raise ValueError(f"{kid}: new {tuple(new.shape)} vs cache "
                         f"{tuple(shape)}")
    if new.dtype != cache.dtype:
        raise TypeError(f"{kid}: new is {new.dtype}, cache is {cache.dtype}")
    L, T = shape[0], shape[1]
    if not 0 <= index < T:
        raise ValueError(f"{kid}: slot {index} out of range [0, {T})")
    return L, T, shape[2] * shape[3] * shape[4] * new.element_size()


def cache_slot_write(cache, new, index: int):
    """K12: cache (L, T, B, Hkv, D), new (L, B, Hkv, D) in the cache's
    dtype, index a host int: cache[:, index] = new, in place; returns cache.
    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if cache.is_cpu:
        return cache_slot_write_plain(cache, new, index)
    index = int(index)
    L, T, run = _tbkd_shape("K12", cache, new, index)
    _build.require_cuda("K12", cache, new)
    err = _build.library().p2t_cache_slab_write(
        cache.data_ptr(), new.data_ptr(), None, None, 1, L, T, index, run,
        _build.stream_of(cache))
    _build.check(err, "p2t_cache_slab_write")
    cache_slot_write.launches += 1
    return cache


cache_slot_write.launches = 0


def cache_slot_write_kv(cache_k, cache_v, new_k, new_v, index: int):
    """K13: `cache_slot_write` of both caches in one launch; returns
    (cache_k, cache_v).  The two caches share one shape and dtype."""
    if cache_k.is_cpu:
        return cache_slot_write_kv_plain(cache_k, cache_v, new_k, new_v,
                                         index)
    if cache_v.shape != cache_k.shape or cache_v.dtype != cache_k.dtype:
        raise ValueError("K13: the k and v caches must share shape, dtype "
                         "and device")
    index = int(index)
    L, T, run = _tbkd_shape("K13", cache_k, new_k, index)
    if new_v.shape != new_k.shape or new_v.dtype != new_k.dtype:
        raise ValueError(f"K13: new_v {new_v.dtype} {tuple(new_v.shape)} "
                         f"vs new_k {new_k.dtype} {tuple(new_k.shape)}")
    _build.require_cuda("K13", cache_k, cache_v, new_k, new_v)
    err = _build.library().p2t_cache_slab_write(
        cache_k.data_ptr(), new_k.data_ptr(), cache_v.data_ptr(),
        new_v.data_ptr(), 2, L, T, index, run, _build.stream_of(cache_k))
    _build.check(err, "p2t_cache_slab_write")
    cache_slot_write_kv.launches += 1
    return cache_k, cache_v


cache_slot_write_kv.launches = 0
