// K11a and K11b: weight-quantized matmul over the JAX package's two other
// int4 packings,
//
//   y[r, n] = (sum_k bf16(x[r, k]) * q[k, n]) * scale[n]
//
// x (R, K) f32 or bf16; scale (N,) f32; fp32 accumulation, y in x's dtype;
// q stored as
//   K11a split-half bytes (K/2, N) int8: byte [k2, n] holds q[k2, n] in
//        its low nibble and q[k2 + K/2, n] in its high one, two's complement
//        (`pack_int4`);
//   K11b bf16-pair words (K/8, N) int32: bits [4p, 4p+4) hold
//        q[k8 + 2p*K/8, n] + 8 and bits [16+4p, 20+4p) hold
//        q[k8 + (2p+1)*K/8, n] + 8 (`pack_int4_pairs`).
//
// Replaces prot2text_tpu/kernels/quant_matmul.py quant_matmul_int4
// (_mm_i4_kernel) and quant_matmul_int4_stacked (_mm_i4_stacked_kernel) for
// K11a, quant_matmul_int4_pairs (_mm_i4w_kernel) and
// quant_matmul_int4_pairs_stacked (_mm_i4w_stacked_kernel) for K11b.  The
// TPU pairs kernel bit-casts each word to two bf16 rows of 136 + q,
// interleaved by Mosaic's bitcast (hence its x rearrangement), and takes
// 136 * rowsum(x) off in its fp32 epilogue, which leaves a cancellation
// error of about 4e-6 of max|y|; here each bf16 pair is made exact before
// the product (one bf16x2 subtraction of 136) and the word is read by its
// defined layout.  Both formats build K10's fragments, so on the same
// integers K11a and K11b give K10's result bit for bit (the TMA body; the
// ragged route with K % 8 == 0).  The bodies, their bound (bytes: the
// weight stream, a quarter of bf16's) and their design are in
// quant_matmul.cuh (the few-row TMA body: few::BytesF, few::WordsF<kPairs>)
// and quant_matmul_ragged.cuh, shared with K10/K14.
#include "quant_matmul.cuh"

// The ragged route: fmt 0: K11a, w (K/2, N) int8 split-half bytes (K
// even); fmt 1: K11b, w (K/8, N) int32 bf16-pair words (K % 8 == 0).
// splits >= 1 slices of K in steps of 32 k values, with `partial` an
// (splits, R, N) fp32 scratch buffer when splits > 1
extern "C" int p2t_quant_matmul_int4(const void* x, const void* w,
                                     const void* scale, void* out,
                                     void* partial, int R, int K, int N,
                                     int fmt, int splits, int dtype,
                                     void* stream) {
  if (fmt == 0)
    return run<kBytes>(x, w, scale, out, partial, R, K, N, splits, dtype,
                       stream);
  if (fmt == 1)
    return run<kPairs>(x, w, scale, out, partial, R, K, N, splits, dtype,
                       stream);
  return (int)cudaErrorInvalidValue;
}

// The few-row TMA body's K11 instantiations: p2t_quant_matmul_few's
// arguments (quant_matmul.cu), fmt kBytes or kPairs
extern "C" int p2t_quant_matmul_few_int4(const void* x, const void* w,
                                         const void* scale, void* out, int R,
                                         int K, int N, int fmt, int ck,
                                         int stages, int dtype, void* stream) {
  if (fmt == kBytes)
    return few::run_dtype<few::BytesF<>>(x, w, scale, out, R, K, N, ck,
                                         stages, dtype, stream);
  if (fmt == kPairs)
    return few::run_dtype<few::WordsF<kPairs>>(x, w, scale, out, R, K, N, ck,
                                               stages, dtype, stream);
  return (int)cudaErrorInvalidValue;
}
