// The many-row body's entry point (quant_matmul_rows.cuh, whose header
// states its bound and design): K14 (int8), K10 (int4 nibble planes), K11a
// (int4 split-half bytes) and K11b (int4 bf16-pair words) above the
// few-row threshold, and K15g (bf16 x int8 -> f32, no scale),
//
//   y[r, n] = (sum_k x[r, k] * q[k, n]) * scale[n]
//
// K14 replaces prot2text_tpu/kernels/quant_matmul.py quant_matmul_int8
// (_mm_i8_kernel) and quant_matmul_int8_stacked (_mm_i8_stacked_kernel),
// K10 quant_matmul_int4_planes (_mm_i4p_kernel) and
// quant_matmul_int4_planes_stacked (_mm_i4p_stacked_kernel), K11a
// quant_matmul_int4 (_mm_i4_kernel) and quant_matmul_int4_stacked
// (_mm_i4_stacked_kernel), K11b quant_matmul_int4_pairs (_mm_i4w_kernel)
// and quant_matmul_int4_pairs_stacked (_mm_i4w_stacked_kernel), K15g
// scripts/bench_int8_mxu.py mm_mix; at or below the threshold K10 and K14
// run quant_matmul.cu's few-row body, K11a and K11b
// quant_matmul_int4.cu's.  This unit holds the int8 and planes
// instantiations; quant_matmul_rows_int4.cu those of bytes and pairs.
#include "quant_matmul_rows.cuh"

// x (R, K) bf16; xp (R, K) bf16 scratch for the int4 formats (x in the
// body's k order), nullptr for int8; w by fmt (rows::Format): 0 (K, N)
// int8, 1 (K/8, N) int32 nibble planes, 2 (K/2, N) int8 split-half bytes,
// 3 (K/8, N) int32 bf16-pair words; scale (N,) f32, or nullptr for none;
// out (R, N) f32 (dtype 0) or bf16 (dtype 1); bm rows and bn columns a
// block, K split over ck blocks of a cluster (kernels/quant_matmul.py
// rows_tiling picks them; rows_fit states the operands it takes)
extern "C" int p2t_quant_matmul_rows(const void* x, void* xp,
                                     const void* w, const void* scale,
                                     void* out, int R, int K, int N,
                                     int fmt, int bm, int bn, int ck,
                                     int dtype, void* stream) {
  if (fmt == rows::kBytes || fmt == rows::kPairs)
    return p2t_quant_matmul_rows_int4(x, xp, w, scale, out, R, K, N, fmt, bm,
                                      bn, ck, dtype, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  using bf16 = __nv_bfloat16;
  using rows::Int8W;
  using rows::PlanesW;
  if (fmt == rows::kInt8 && dtype == p2t::kFloat32)
    return rows::run<Int8W, float>(x, xp, w, sc, out, R, K, N, bm, bn, ck, s);
  if (fmt == rows::kInt8 && dtype == p2t::kBFloat16)
    return rows::run<Int8W, bf16>(x, xp, w, sc, out, R, K, N, bm, bn, ck, s);
  if (fmt == rows::kPlanes && dtype == p2t::kFloat32)
    return rows::run<PlanesW, float>(x, xp, w, sc, out, R, K, N, bm, bn, ck,
                                     s);
  if (fmt == rows::kPlanes && dtype == p2t::kBFloat16)
    return rows::run<PlanesW, bf16>(x, xp, w, sc, out, R, K, N, bm, bn, ck,
                                    s);
  return (int)cudaErrorInvalidValue;
}
