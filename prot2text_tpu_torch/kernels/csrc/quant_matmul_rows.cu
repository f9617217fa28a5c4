// The many-row body's entry point (quant_matmul_rows.cuh, whose header
// states its bound and design): K14 (int8) and K10 (int4 nibble planes)
// above the few-row threshold, and K15g (bf16 x int8 -> f32, no scale),
//
//   y[r, n] = (sum_k x[r, k] * q[k, n]) * scale[n]
//
// K14 replaces prot2text_tpu/kernels/quant_matmul.py quant_matmul_int8
// (_mm_i8_kernel) and quant_matmul_int8_stacked (_mm_i8_stacked_kernel),
// K10 quant_matmul_int4_planes (_mm_i4p_kernel) and
// quant_matmul_int4_planes_stacked (_mm_i4p_stacked_kernel), K15g
// scripts/bench_int8_mxu.py mm_mix; at or below the threshold K10 and K14
// run quant_matmul.cu's few-row body.
#include "quant_matmul_rows.cuh"

// x (R, K) bf16; xp (R, K) bf16 scratch for nibble planes (x in the
// body's k order), nullptr for int8; w (K, N) int8 (bits 8) or (K/8, N)
// int32 nibble planes (bits 4, K % 64 == 0); scale (N,) f32, or nullptr for
// none; out (R, N)
// f32 (dtype 0) or bf16 (dtype 1); bm rows and bn columns a block, K split
// over ck blocks of a cluster (kernels/quant_matmul.py rows_tiling picks
// them; rows_fit states the operands it takes)
extern "C" int p2t_quant_matmul_rows(const void* x, void* xp,
                                     const void* w, const void* scale,
                                     void* out, int R, int K, int N,
                                     int bits, int bm, int bn, int ck,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  using bf16 = __nv_bfloat16;
  using rows::Int8W;
  using rows::PlanesW;
  if (bits == 8 && dtype == p2t::kFloat32)
    return rows::run<Int8W, float>(x, xp, w, sc, out, R, K, N, bm, bn, ck, s);
  if (bits == 8 && dtype == p2t::kBFloat16)
    return rows::run<Int8W, bf16>(x, xp, w, sc, out, R, K, N, bm, bn, ck, s);
  if (bits == 4 && dtype == p2t::kFloat32)
    return rows::run<PlanesW, float>(x, xp, w, sc, out, R, K, N, bm, bn, ck,
                                     s);
  if (bits == 4 && dtype == p2t::kBFloat16)
    return rows::run<PlanesW, bf16>(x, xp, w, sc, out, R, K, N, bm, bn, ck,
                                    s);
  return (int)cudaErrorInvalidValue;
}
