// bf16 K9b and K9c on the cluster-split decode body's int8 policy
// (decode_attention_split.cuh: PrefixCols, Int8Cache and ChunkWrite; its
// header states the design, what bounds it and the numerics), and the
// entry of bf16 K7 and K8, which run the same policy over CacheCols (no
// prefix tile, no prefix pointer read) from decode_attention_split_qc.cu.
// One translation unit holds each column policy's instantiations, so the
// two build in parallel with each other and with the SIMT bodies of
// decode_attention_write_q.cu (K7, K9b) and decode_attention_verify.cu
// (K8, K9c), whose C entry points call in here for the shapes
// `split::int8_takes` gives this body.
#include "decode_attention_split.cuh"

// K7, K8, K9b and K9c's untyped arguments (as p2t_decode_attention_verify's,
// G current rows of rep query heads each; dequant_first 1: K7/K9b's
// q·(kq·ks), 0: K8/K9c's (q·kq)·ks) → the Int8Cache body: Pc > 0 needs the
// prefix's pointers and runs PrefixCols; Pc == 0 takes null ones and runs
// CacheCols
extern "C" int p2t_decode_split_int8(
    const void* qg, void* ck, void* cv, void* sk, void* sv,
    const void* kv_mask, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* slots, const void* pk, const void* pv,
    const void* psk, const void* psv, const void* pmask, void* out, int B,
    int Hkv, int rep, int G, int T_len, int Pc, int D, int dequant_first,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || rep <= 0 || G <= 0 || T_len <= 0 || Pc < 0)
    return (int)cudaErrorInvalidValue;
  if (Pc == 0)
    return p2t_decode_split_int8_cache(qg, ck, cv, sk, sv, kv_mask, kq, vq,
                                       ks, vs, slots, out, B, Hkv, rep, G,
                                       T_len, D, dequant_first, stream);
  if (pk == nullptr || pv == nullptr || psk == nullptr || psv == nullptr ||
      pmask == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)split::run_int8<split::PrefixCols>(
      qg, ck, cv, sk, sv, kv_mask, kq, vq, ks, vs, slots, pk, pv, psk, psv,
      pmask, out, B, Hkv, rep, G, T_len, Pc, D, dequant_first,
      static_cast<cudaStream_t>(stream));
}

// The clusters of the instantiation for `rows` query rows and head dim D
// that the card holds at once, into *n: with the prefix (PrefixCols,
// K9b/K9c) or without it (CacheCols, K7/K8) (scripts/sweep_decode_split.py;
// no path calls it)
extern "C" int p2t_decode_split_int8_resident(int prefix, int rows, int D,
                                              void* n) {
  if (!prefix) return p2t_decode_split_int8_cache_resident(rows, D, n);
  return (int)split::resident_clusters<split::PrefixCols, split::Int8Cache,
                                       split::ChunkWrite>(
      D, rows, static_cast<int*>(n));
}
