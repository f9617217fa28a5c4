// K7 and K9b: grouped-query decode attention over layer `li` of the stacked
// int8 (L, B, Hkv, T, D) KV cache with per-(head, token) fp32 scales, fused
// with the in-place write of each row's current int8 k/v and scales into
// its own slot `slots[b]` (a scalar slot is broadcast by the wrapper, for
// lockstep generation); K9b adds the read-only int8 shared prefix
// (L, 1, Hkv, Pc, D) with scales, gated per row by pmask.
//
// Replaces prot2text_tpu/kernels/decode_attention.py
// decode_attention_stacked_write_q (_kernel_write_q, K7) and
// decode_attention_stacked_write_q_prefix (_kernel_write_q_p, K9b).  The
// TPU kernels rewrote the slot's 32-row int8 tile group and the layer's
// whole scale rows through aliased outputs; here the kernel stores exactly
// the one row and its two scales.  Bound: bytes (~540 valid columns × 2 ×
// 128 bytes + 8 of scales per (b, kv head) at the serving shape).  bf16 K7
// and K9b with at most 32 query rows (`split::int8_takes`, the wrappers'
// `int8_split_route`) run the cluster-split tensor-core body of
// decode_attention_split.cuh (policies Int8Cache and ChunkWrite, G = 1,
// the current key dequantized before the dot; K7 over CacheCols, K9b over
// PrefixCols; its header states the design) through
// decode_attention_split_q.cu.  f32 q, and a call past 32 rows, run the
// SIMT body of decode_attention_q.cuh, whose header states its numerics
// and design; this is its G = 1 instance.  The route is the shape's: a
// failure of the split body raises, it never falls back to the SIMT body.
#include "decode_attention_q.cuh"
#include "decode_attention_split.cuh"

// ck/cv/sk/sv: the layer's (B, Hkv, T[, D]) slices; kq/vq (B, Hkv, D) and
// ks/vs (B, Hkv) the current token's quantized k/v; pk/pv/psk/psv the
// layer's prefix slices and pmask (B, Pc), all ignored when Pc == 0 (K7)
extern "C" int p2t_decode_attention_write_q(
    const void* qg, void* ck, void* cv, void* sk, void* sv,
    const void* kv_mask, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* slots, const void* pk, const void* pv,
    const void* psk, const void* psv, const void* pmask, void* out, int B,
    int Hkv, int rep, int T_len, int Pc, int D, int dtype, void* stream) {
  if (split::int8_takes(dtype, rep))
    return p2t_decode_split_int8(qg, ck, cv, sk, sv, kv_mask, kq, vq, ks, vs,
                                 slots, pk, pv, psk, psv, pmask, out, B, Hkv,
                                 rep, /*G=*/1, T_len, Pc, D,
                                 /*dequant_first=*/1, stream);
  return q_entry(qg, ck, cv, sk, sv, kv_mask, kq, vq, ks, vs, slots, pk, pv,
                 psk, psv, pmask, out, B, Hkv, rep, /*G=*/1, T_len, Pc, D,
                 dtype, /*dequant_first=*/1, stream);
}
