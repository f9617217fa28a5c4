// bf16 K7 and K8 on the cluster-split decode body's int8 policy
// (decode_attention_split.cuh: CacheCols, Int8Cache and ChunkWrite; its
// header states the design, what bounds it and the numerics): the
// no-prefix instantiations, in a translation unit of their own so that
// they build in parallel with K9b/K9c's (decode_attention_split_q.cu,
// whose p2t_decode_split_int8 calls in here when Pc == 0).
#include "decode_attention_split.cuh"

// p2t_decode_split_int8's arguments without the prefix: G current rows of
// rep query heads each; dequant_first 1: K7's q·(kq·ks), 0: K8's
// (q·kq)·ks
extern "C" int p2t_decode_split_int8_cache(
    const void* qg, void* ck, void* cv, void* sk, void* sv,
    const void* kv_mask, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* slots, void* out, int B, int Hkv, int rep,
    int G, int T_len, int D, int dequant_first, void* stream) {
  return (int)split::run_int8<split::CacheCols>(
      qg, ck, cv, sk, sv, kv_mask, kq, vq, ks, vs, slots, nullptr, nullptr,
      nullptr, nullptr, nullptr, out, B, Hkv, rep, G, T_len, /*Pc=*/0, D,
      dequant_first, static_cast<cudaStream_t>(stream));
}

// The clusters of the no-prefix instantiation for `rows` query rows and
// head dim D that the card holds at once, into *n
extern "C" int p2t_decode_split_int8_cache_resident(int rows, int D,
                                                    void* n) {
  return (int)split::resident_clusters<split::CacheCols, split::Int8Cache,
                                       split::ChunkWrite>(
      D, rows, static_cast<int*>(n));
}
