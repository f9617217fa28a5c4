// K11a and K11b on the many-row body (quant_matmul_rows.cuh: the BytesW and
// PairsW policies; its header states the bound, the design and why on the
// same integers both give K10's many-row result bit for bit).  One
// translation unit holds their instantiations, so that they build in
// parallel with quant_matmul_rows.cu's (K10, K14, K15g), whose entry point
// calls in here for the two formats.
#include "quant_matmul_rows.cuh"

extern "C" int p2t_quant_matmul_rows_int4(const void* x, void* xp,
                                          const void* w, const void* scale,
                                          void* out, int R, int K, int N,
                                          int fmt, int bm, int bn, int ck,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  using bf16 = __nv_bfloat16;
  using rows::BytesW;
  using rows::PairsW;
  if (fmt == rows::kBytes && dtype == p2t::kFloat32)
    return rows::run<BytesW, float>(x, xp, w, sc, out, R, K, N, bm, bn, ck,
                                    s);
  if (fmt == rows::kBytes && dtype == p2t::kBFloat16)
    return rows::run<BytesW, bf16>(x, xp, w, sc, out, R, K, N, bm, bn, ck,
                                   s);
  if (fmt == rows::kPairs && dtype == p2t::kFloat32)
    return rows::run<PairsW, float>(x, xp, w, sc, out, R, K, N, bm, bn, ck,
                                    s);
  if (fmt == rows::kPairs && dtype == p2t::kBFloat16)
    return rows::run<PairsW, bf16>(x, xp, w, sc, out, R, K, N, bm, bn, ck,
                                   s);
  return (int)cudaErrorInvalidValue;
}
