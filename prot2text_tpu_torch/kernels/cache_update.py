"""In-place KV-cache slot writes (CUDA C++), one kernel per cache layout
(`models/decoder.kv_cache_layout`):

* K3, `cache_slot_write_bkt`: the (L, B, Hkv, T, D) cache.  Replaces
  prot2text_tpu/kernels/cache_update.py `cache_slot_write_bkt`
  (`_write_group_kernel`).
* K12, `cache_slot_write`: the sequence-leading (L, T, B, Hkv, D) cache of
  D=64 decoders.  Replaces `cache_slot_write` (`_write_kernel`).
* K13, `cache_slot_write_kv`: K12 for the k and v caches in one launch.
  Replaces `cache_slot_write_kv` (`_write_kv_kernel`).  No path of either
  package calls it (JAX: tests/test_flash_attention.py:142); the lockstep
  decode step writes k and v with two K12 calls, as JAX's does.

The kernels are `csrc/cache_update.cu`; its comments state what bounds them
(bytes and launch latency) and their design.  Each `*_plain` function is
the plain PyTorch version (slice assignment); kernel and plain version are
bit-identical.
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
    new rows: (L, B, Hkv, T, D) with slot_dim 3 (K3) or (L, T, B, Hkv, D)
    with slot_dim 1 (K12/K13); new is the cache's shape without T."""
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


def _slab_write(caches, news, index):
    L, T, B, Hkv, D = caches[0].shape
    pairs = [(c.data_ptr(), n.data_ptr()) for c, n in zip(caches, news)]
    c1, s1 = pairs[1] if len(pairs) == 2 else (None, None)
    err = _build.library().p2t_cache_slab_write(
        *pairs[0], c1, s1, len(pairs), L, T, index,
        B * Hkv * D * caches[0].element_size(),
        _build.stream_of(caches[0]))
    _build.check(err, "p2t_cache_slab_write")


def cache_slot_write(cache, new, index: int):
    """K12: cache (L, T, B, Hkv, D), new (L, B, Hkv, D) in the cache's
    dtype, index a host int: cache[:, index] = new, in place; returns cache.
    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if cache.device.type == "cpu":
        return cache_slot_write_plain(cache, new, index)
    index = int(index)
    _check(cache, new, index, "K12", 1)
    _slab_write((cache,), (new,), index)
    cache_slot_write.launches += 1
    return cache


cache_slot_write.launches = 0


def cache_slot_write_kv(cache_k, cache_v, new_k, new_v, index: int):
    """K13: `cache_slot_write` of both caches in one launch; returns
    (cache_k, cache_v).  The two caches share one shape and dtype."""
    if cache_k.device.type == "cpu":
        return cache_slot_write_kv_plain(cache_k, cache_v, new_k, new_v,
                                         index)
    index = int(index)
    _check(cache_k, new_k, index, "K13", 1)
    _check(cache_v, new_v, index, "K13", 1)
    if (cache_v.shape != cache_k.shape or cache_v.dtype != cache_k.dtype
            or cache_v.device != cache_k.device):
        raise ValueError("K13: the k and v caches must share shape, dtype "
                         "and device")
    _slab_write((cache_k, cache_v), (new_k, new_v), index)
    cache_slot_write_kv.launches += 1
    return cache_k, cache_v


cache_slot_write_kv.launches = 0
