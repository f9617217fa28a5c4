// Shared helpers for the port's CUDA kernels (built for sm_90a by
// kernels/_build.py into one shared library with a plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// Chained launches: programmatic dependent launch (sm_90).  A kernel
// launched by `launch_chained` may begin while the kernel before it on the
// stream is still running: its blocks run their index arithmetic, then
// `grid_dependency_wait()` holds them until that kernel has finished and
// its writes are visible, so no global memory may be read (or written)
// before that wait.  `launch_dependents()`, after a kernel's stores, lets
// the next chained launch begin once every block of this grid has called
// it (or exited); that launch still waits for this grid's end in its own
// `grid_dependency_wait()`.  Stream capture keeps the dependency as a
// programmatic edge of the graph.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// launch kernel<<<grid, block, 0, stream>>>(args...) with the programmatic
// stream serialization attribute; returns the launch's error
template <typename... Params, typename... Args>
inline cudaError_t launch_chained(void (*kernel)(Params...), dim3 grid,
                                  dim3 block, cudaStream_t stream,
                                  Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// 2^x (MUFU; -inf → +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Word-moving kernels (K12/K13, K15h-K15l): one W-byte word a thread, W the
// widest of 16, 8, 4, 2, 1 that the lengths and addresses allow, in grids
// sized to the words.

constexpr int kWriteThreads = 1024;   // threads a block at most
constexpr int kSMs = 132;             // the H100 SXM's

// one W-byte word: its type, and a volatile global load of it (issued
// where it stands: never sunk behind a branch nor reordered with another)
template <int W> struct Word;
template <> struct Word<16> {
  using T = uint4;
  static __device__ __forceinline__ T load(const void* p) {
    T v;
    asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
  }
};
template <> struct Word<8> {
  using T = uint2;
  static __device__ __forceinline__ T load(const void* p) {
    T v;
    asm volatile("ld.global.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(v.x), "=r"(v.y) : "l"(p));
    return v;
  }
};
template <> struct Word<4> {
  using T = uint32_t;
  static __device__ __forceinline__ T load(const void* p) {
    T v;
    asm volatile("ld.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
    return v;
  }
};
template <> struct Word<2> {
  using T = uint16_t;
  static __device__ __forceinline__ T load(const void* p) {
    T v;
    asm volatile("ld.global.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
    return v;
  }
};
template <> struct Word<1> {
  using T = uint8_t;
  static __device__ __forceinline__ T load(const void* p) {
    uint16_t v;
    asm volatile("ld.global.u8 %0, [%1];\n" : "=h"(v) : "l"(p));
    return static_cast<T>(v);
  }
};

// the word width's kernel: f(std::integral_constant<int, W>) for W one of
// 16, 8, 4, 2, 1
template <typename F>
inline cudaError_t by_width(int W, F&& f) {
  switch (W) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 2>{});
    default: return f(std::integral_constant<int, 1>{});
  }
}

// the widest of 16, 8, 4, 2, 1 that divides a (an address or a length)
inline int widest(uintptr_t a) {
  return (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4
       : (a & 1) == 0 ? 2 : 1;
}


// n threads in blocks of at most kWriteThreads, whole warps, one block up
// to kWriteThreads
inline void write_grid(int64_t n, dim3* grid, dim3* block) {
  const int64_t warps = (n + 31) / 32;
  const int64_t threads = warps * 32 < kWriteThreads ? warps * 32
                                                     : kWriteThreads;
  *block = dim3(static_cast<unsigned>(threads));
  *grid = dim3(static_cast<unsigned>((n + threads - 1) / threads));
}

// K15h/K15i: one thread a word, and at least `least` threads: one block
// up to kWriteThreads threads; past that blocks of 128-1024 threads, as
// many as cover the words and at least two an SM where 128-thread blocks
// allow it
inline void word_grid(int64_t words, int least, dim3* grid, dim3* block) {
  const int64_t n = words > least ? words : least;
  if (n <= kWriteThreads) return write_grid(n, grid, block);
  int64_t t = ((n + 2 * kSMs - 1) / (2 * kSMs) + 31) / 32 * 32;
  t = t < 128 ? 128 : t > kWriteThreads ? kWriteThreads : t;
  *block = dim3(static_cast<unsigned>(t));
  *grid = dim3(static_cast<unsigned>((n + t - 1) / t));
}

}  // namespace p2t
