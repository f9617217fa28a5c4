// K10 and K14: weight-quantized matmul over int4 nibble planes (K10) or
// int8 (K14) weights,
//
//   y[r, n] = (sum_k bf16(x[r, k]) * w[k, n]) * scale[n]
//
// x (R, K) f32 or bf16; w int4 nibble planes (K/8, N) int32, nibble j of
// word [k8, n] holding w[k8 + j*K/8, n] (K10), or int8 (K, N) (K14); scale
// (N,) f32; fp32 accumulation, y in x's dtype.
//
// Replaces prot2text_tpu/kernels/quant_matmul.py quant_matmul_int4_planes
// (_mm_i4p_kernel) and quant_matmul_int4_planes_stacked
// (_mm_i4p_stacked_kernel) for K10, quant_matmul_int8 (_mm_i8_kernel) and
// quant_matmul_int8_stacked (_mm_i8_stacked_kernel) for K14.  Up to the
// few-row threshold the TMA body of quant_matmul.cuh (its header states its
// bound, bytes, and its design), shared with K11 (quant_matmul_int4.cu);
// shapes TMA cannot describe take the ragged route at every row count
// (quant_matmul_ragged.cuh); above the threshold quant_matmul_rows.cu.
#include "quant_matmul.cuh"

// The ragged route: bits 4 (w: (K/8, N) int32 nibble planes) or 8 (w: (K,
// N) int8); splits >= 1 slices of K (in steps of 32 k values for int4, 16
// for int8), with `partial` an (splits, R, N) fp32 scratch buffer when
// splits > 1 (the wrapper picks splits and allocates it)
extern "C" int p2t_quant_matmul(const void* x, const void* w,
                                const void* scale, void* out, void* partial,
                                int R, int K, int N, int bits, int splits,
                                int dtype, void* stream) {
  if (bits == 4)
    return run<kPlanes>(x, w, scale, out, partial, R, K, N, splits, dtype,
                        stream);
  if (bits == 8)
    return run<kInt8>(x, w, scale, out, partial, R, K, N, splits, dtype,
                      stream);
  return (int)cudaErrorInvalidValue;
}

// The few-row TMA body: x (R, K) f32 or bf16 (dtype) 16-byte aligned; w
// by fmt (quant_matmul_ragged.cuh Format: kPlanes 0, kPairs 1, kBytes 2,
// kInt8 3; bytes and pairs are instantiated in quant_matmul_int4.cu), 16-
// byte aligned; scale (N,) f32; out (R, N) in x's dtype; K split over ck
// blocks of a cluster, `stages` ring stages (kernels/quant_matmul.py
// few_rows_tiling picks them, few_fit states the operands it takes)
extern "C" int p2t_quant_matmul_few(const void* x, const void* w,
                                    const void* scale, void* out, int R,
                                    int K, int N, int fmt, int ck,
                                    int stages, int dtype, void* stream) {
  if (fmt == kBytes || fmt == kPairs)
    return p2t_quant_matmul_few_int4(x, w, scale, out, R, K, N, fmt, ck,
                                     stages, dtype, stream);
  if (fmt == kPlanes)
    return few::run_dtype<few::WordsF<kPlanes>>(x, w, scale, out, R, K, N,
                                                ck, stages, dtype, stream);
  if (fmt == kInt8)
    return few::run_dtype<few::Int8F<>>(x, w, scale, out, R, K, N, ck,
                                        stages, dtype, stream);
  return (int)cudaErrorInvalidValue;
}
