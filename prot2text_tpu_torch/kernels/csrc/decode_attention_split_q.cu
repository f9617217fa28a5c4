// bf16 K9b and K9c on the cluster-split decode body's int8 policy
// (decode_attention_split.cuh: PrefixCols, Int8Cache and ChunkWrite; its
// header states the design, what bounds it and the numerics).  One
// translation unit holds the policy's instantiations for both kernels, so
// they build once and in parallel with the SIMT bodies of
// decode_attention_write_q.cu (K7, K9b) and decode_attention_verify.cu
// (K8, K9c), whose C entry points call in here for the shapes
// `split::int8_takes` gives this body.
#include "decode_attention_split.cuh"

// K9b and K9c's untyped arguments (as p2t_decode_attention_verify's, G
// current rows of rep query heads each; dequant_first 1: K9b's q·(kq·ks),
// 0: K9c's (q·kq)·ks) → the Int8Cache body
extern "C" int p2t_decode_split_int8(
    const void* qg, void* ck, void* cv, void* sk, void* sv,
    const void* kv_mask, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* slots, const void* pk, const void* pv,
    const void* psk, const void* psv, const void* pmask, void* out, int B,
    int Hkv, int rep, int G, int T_len, int Pc, int D, int dequant_first,
    void* stream) {
  using namespace split;
  if (B <= 0 || Hkv <= 0 || rep <= 0 || G <= 0 || T_len <= 0 || Pc <= 0 ||
      pk == nullptr || pv == nullptr || psk == nullptr || psv == nullptr ||
      pmask == nullptr)
    return (int)cudaErrorInvalidValue;
  const Params<int8_t> p = {
      static_cast<const bf16*>(qg), static_cast<const int8_t*>(ck),
      static_cast<const int8_t*>(cv), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int32_t*>(kv_mask),
      static_cast<const int8_t*>(pk), static_cast<const int8_t*>(pv),
      static_cast<const float*>(psk), static_cast<const float*>(psv),
      static_cast<const int32_t*>(pmask), static_cast<bf16*>(out),
      Hkv, rep, G * rep, T_len, Pc};
  const Int8Cache e = {static_cast<const float*>(kq),
                       static_cast<const float*>(vq),
                       static_cast<const float*>(ks),
                       static_cast<const float*>(vs), G, dequant_first};
  const ChunkWrite w = {static_cast<int8_t*>(ck), static_cast<int8_t*>(cv),
                        static_cast<float*>(sk), static_cast<float*>(sv),
                        static_cast<const int32_t*>(slots)};
  return (int)run<PrefixCols>(D, p, e, w, B,
                              static_cast<cudaStream_t>(stream));
}

// The clusters of the instantiation for `rows` query rows and head dim D
// that the card holds at once, into *n (scripts/sweep_decode_split.py; no
// path calls it)
extern "C" int p2t_decode_split_int8_resident(int rows, int D, void* n) {
  return (int)split::resident_clusters<split::PrefixCols, split::Int8Cache,
                                       split::ChunkWrite>(
      D, rows, static_cast<int*>(n));
}
