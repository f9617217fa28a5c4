// K8 and K9c: speculative chunk verification over layer `li` of the stacked
// int8 (L, B, Hkv, T, D) KV cache: G·rep query rows per (b, kv head) (row
// g·rep + r is chunk token g, head replica r) attend [cache ‖ intra-chunk
// causal] in one fp32 softmax, and the chunk's G int8 k/v rows and scales
// are written in place at columns [slots[b], slots[b] + G); K9c adds the
// read-only int8 shared prefix (L, 1, Hkv, Pc, D) with scales, gated per
// row by pmask.
//
// Replaces prot2text_tpu/kernels/decode_attention.py
// decode_attention_stacked_verify_qc (_kernel_verify_qc, K8) and
// decode_attention_stacked_verify_qc_prefix (_kernel_verify_qc_p, K9c).
// The TPU kernels' (B, 2) grid — a second step only to copy out the second
// spanned 32-row tile group — and their two-group read-modify-write are TPU
// artefacts: here exactly the G rows are stored, so the kernel needs only
// slots[b] + G <= T (the wrapper checks it; the serving engine keeps the
// TPU rule slots[b] <= T - 64 so the pools keep their shapes).  Bound:
// bytes.  bf16 K8 and K9c with G·rep <= 32 query rows
// (`split::int8_takes`, the wrappers' `int8_split_route`) run the
// cluster-split tensor-core body of decode_attention_split.cuh (policies
// Int8Cache and ChunkWrite, the chunk's key dot scaled after the product;
// K8 over CacheCols, K9c over PrefixCols; all G·rep rows in one block, so
// the slab is read once; its header states the design) through
// decode_attention_split_q.cu.  f32 q, and a call past 32 rows, run the
// SIMT body of decode_attention_q.cuh, whose header states its numerics
// and design; this is its G-token instance.  The route is the shape's: a
// failure of the split body raises, it never falls back to the SIMT body.
#include "decode_attention_q.cuh"
#include "decode_attention_split.cuh"

extern "C" int p2t_decode_attention_verify(
    const void* qg, void* ck, void* cv, void* sk, void* sv,
    const void* kv_mask, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* slots, const void* pk, const void* pv,
    const void* psk, const void* psv, const void* pmask, void* out, int B,
    int Hkv, int rep, int G, int T_len, int Pc, int D, int dtype,
    void* stream) {
  if (G > 0 && split::int8_takes(dtype, G * rep))
    return p2t_decode_split_int8(qg, ck, cv, sk, sv, kv_mask, kq, vq, ks, vs,
                                 slots, pk, pv, psk, psv, pmask, out, B, Hkv,
                                 rep, G, T_len, Pc, D,
                                 /*dequant_first=*/0, stream);
  return q_entry(qg, ck, cv, sk, sv, kv_mask, kq, vq, ks, vs, slots, pk, pv,
                 psk, psv, pmask, out, B, Hkv, rep, G, T_len, Pc, D, dtype,
                 /*dequant_first=*/0, stream);
}
