// Shared helpers for the port's CUDA kernels (built for sm_90a by
// kernels/_build.py into one shared library with a plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace p2t {

// dtype codes shared with kernels/_build.py DTYPE_CODES
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded through T and back: the JAX kernels cast the softmax weights to
// the value dtype before the P·V product (`p.astype(v.dtype)`).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// 8 consecutive elements → fp32 with 16-byte loads (p must be 16B aligned).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---------------------------------------------------------------------------
// bf16 tensor cores (mma.sync) and the copies that feed them.  Fragments of
// m16n8k16 for lane = 4g + t: A (16x16, row) a0 (row g, k 2t..2t+1), a1 (row
// g+8), a2 (row g, k 2t+8..2t+9), a3 (row g+8, k 2t+8..); B (16x8, col) b0
// (k 2t..2t+1, col g), b1 (k 2t+8..2t+9); C c0, c1 (row g, cols 2t, 2t+1),
// c2, c3 (row g+8).  A bf16 pair holds the lower index in its low half.

// c += a · b, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four 8x8 bf16 matrices from shared memory; lanes 8i .. 8i+7 give the row
// addresses of matrix i, which lands in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// the same, each matrix transposed (row-major k x n → B fragments)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16 bytes global → shared without passing through registers; src_bytes 0
// writes 16 zero bytes and reads nothing (src must still be a valid
// address).  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
// 4 bytes (both addresses 4-byte aligned); src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// rows [r0, r0 + kRows) of a (rows, D) bf16 matrix of row stride ss →
// shared [kRows][kStride] by 16-byte cp.async, spread over kThreads
// threads; rows at or past `limit` are zero-filled and not read.  The
// source's base and row stride must be 16-byte aligned.
template <int D, int kRows, int kStride, int kThreads>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              int64_t ss, int r0, int limit,
                                              int tid) {
  constexpr int kChunks = D / 8;
  static_assert(kRows * kChunks % kThreads == 0, "tile / thread mismatch");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * kStride + 8 * c,
               ok ? src + (int64_t)(r0 + r) * ss + 8 * c : src, ok ? 16 : 0);
  }
}

// an 8x8 bf16 matrix held as one fragment register (lane 4g + t: row g,
// columns 2t, 2t+1) → its transpose in the same layout; turns a C
// fragment's rows into a B fragment's columns
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// a bf16 operand cp.async can copy: base and (batch, head, sequence)
// element strides 16-byte aligned
__host__ inline bool aligned16(const void* ptr, int64_t sb, int64_t sh,
                               int64_t ss) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 &&
         ((sb | sh | ss) & 7) == 0;
}

// 2^x (MUFU; -inf → +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace p2t
