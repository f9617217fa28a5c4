"""K3: in-place KV-cache slot write for the (L, B, Hkv, T, D) cache (CUDA C++).

Replaces prot2text_tpu/kernels/cache_update.py `cache_slot_write_bkt`
(`_write_group_kernel`).  The kernel is `csrc/cache_update.cu`; its header
states what bounds it (bytes and launch latency) and its design.
`cache_slot_write_bkt_plain` is the plain PyTorch version
(`cache[:, :, :, index] = new`); the two are bit-identical.
"""

from __future__ import annotations

from . import _build


def cache_slot_write_bkt_plain(cache, new, index: int):
    cache[:, :, :, index] = new
    return cache


def _check(cache, new, index):
    if cache.device.type != "cuda" or new.device != cache.device:
        raise ValueError(f"K3 kernel needs CUDA tensors on one device, got "
                         f"{cache.device} and {new.device}")
    if cache.dim() != 5:
        raise ValueError("cache must be (L, B, Hkv, T, D)")
    L, B, Hkv, T, D = cache.shape
    if new.shape != (L, B, Hkv, D):
        raise ValueError(f"new {tuple(new.shape)} vs cache "
                         f"{tuple(cache.shape)}")
    if new.dtype != cache.dtype:
        raise TypeError(f"new is {new.dtype}, cache is {cache.dtype}")
    if not (cache.is_contiguous() and new.is_contiguous()):
        raise ValueError("cache and new must be contiguous")
    if not 0 <= index < T:
        raise ValueError(f"slot {index} out of range [0, {T})")


def cache_slot_write_bkt(cache, new, index: int):
    """cache[:, :, :, index] = new, in place; returns cache.  CPU tensors
    run the plain version; CUDA tensors launch the kernel (or raise)."""
    if cache.device.type == "cpu":
        return cache_slot_write_bkt_plain(cache, new, index)
    index = int(index)
    _check(cache, new, index)
    L, B, Hkv, T, D = cache.shape
    lib = _build.library()
    err = lib.p2t_cache_slot_write(
        cache.data_ptr(), new.data_ptr(), L * B * Hkv, T, index,
        D * cache.element_size(), _build.stream_of(cache))
    _build.check(err, "p2t_cache_slot_write")
    cache_slot_write_bkt.launches += 1
    return cache


cache_slot_write_bkt.launches = 0
