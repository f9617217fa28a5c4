// A bf16 x integer-weight product for many rows (R up to 128 a block) on
// the tensor cores' warpgroup instruction (wgmma):
//
//   y[r, n] = (sum_k x[r, k] * q[k, n]) * scale[n]     (no scale: the sum)
//
// x (R, K) bf16 row-major; q the integer weight in a format policy's
// layout (`Int8W` below: (K, N) int8, K15g's and K14's); fp32 accumulation,
// the scale in the fp32 epilogue, y of type To.  The body is a template
// over the weight format, the output type and the block's column count;
// the scale is nullable.  K15g (probe_quant_matmul.cu, variant 5: bf16 x
// int8 -> f32, no scale, at R 128) runs it today; K14 (int8) and K10
// (nibble planes) can take it at R >= 40 through a format policy each.
//
// Bound: at K15g's probe shape (R 128, K 4096, N 14336) the int8 weight is
// 58.7 MB and the f32 output 7.3 MB: 19.7 us at 3.35 TB/s; the 15.0 G
// operations take 15.2 us at 989 TFLOP/s.  Bytes set the bound, but the
// tensor cores must run at more than three quarters of their peak to stay
// under it.  quant_matmul.cuh's few-row body, stretched to 128 rows (0.1199
// ms on an H100 80GB HBM3 at 700 W), re-staged all of x in every
// 128-column block, held 128 fp32 accumulators a thread beside 4 K steps of
// weights in flight, and sent a (2, R, N) fp32 split-K partial through
// global memory to a second launch.  Two mma.sync designs came first: a
// bf16 copy of each int8 tile in shared memory read by ldmatrix.trans
// (0.0742 ms; shared memory carried ~245 bytes an MMA against the ~256 it
// serves), then the product transposed with the weight as the A operand
// converted in registers (0.0641 ms, and the same at R 64: bound by issuing
// the MMAs).  So here:
//   - the product runs transposed, y^T = q^T x^T, on wgmma m64n128k16: A
//     (64 weight columns x 16 k) from registers, B (16 k x 128 rows of x)
//     from shared memory through a descriptor, 64 fp32 accumulators a
//     thread.  A block is kWG warpgroups: all 128 rows x 64·kWG columns (128
//     or 256; the wrapper's rule picks the one that fills the SMs best), so
//     x crosses L2 once per column block and cluster rank;
//   - K walks in tiles of 64 through a 4-stage cp.async ring that holds the
//     x tile, in the canonical K-major layout without swizzle (8-row x
//     16-byte core matrices, 128 bytes apart along K and 1024 along the
//     rows), and the raw int8 weight tile (rows padded by 16 bytes);
//   - the A fragments come straight from the int8 tile: one ldmatrix.trans
//     of 16-bit units gives a thread the bytes of k 2t, 2t+1 (and 2t+8,
//     2t+9) at columns 2g, 2g+1, so the MMA's row g stands for column 2g
//     and row g + 8 for column 2g + 1, and a byte pair becomes a bf16 pair
//     in registers (q + 128 in the fp32 2^23 + 128 + q by a byte permute,
//     2^23 + 128 off in one add, exactly, the high halves kept); wgmma
//     reads x without the warps' ldmatrix, and runs while the warps convert
//     the next fragments;
//   - where the column blocks leave SMs idle the rule splits K across the
//     C blocks of a thread-block cluster (C <= 4): each block sums its K
//     slice, leaves its fp32 partial in its own shared memory (over the
//     ring), and after a cluster barrier block r sums a share of the
//     elements over ranks 0 .. C-1 in that order through distributed shared
//     memory: no partial crosses global memory, no second launch, no
//     atomics (two launches give the same bits), as flash_attention_bwd.cuh's
//     dK/dV; otherwise the accumulators go out directly.
// With the products off the critical path the stream is the limit: R 64
// (half of x's copies: rows past R are not read) runs 17% faster than R
// 128.  Sharing x's tiles across a cluster's column blocks (TMA multicast)
// is the next step.
// Contract: any R >= 1 (rows past R are zero-filled and not written), any
// K (a ragged last tile is zero-filled; x is copied 16 bytes at a time when
// K % 8 == 0 and x is 16-byte aligned, else element by element), N a
// multiple of 4 and the weight 16-byte aligned (16-byte copies of the
// weight when N % 16 == 0, else 4-byte).
#pragma once

#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"

namespace {
namespace rows {

namespace cg = cooperative_groups;

using p2t::cp_async16;
using p2t::cp_async4;
using p2t::cp_async_commit;
using p2t::cp_async_wait;
using p2t::from_float;
using p2t::ldmatrix_x4_trans;

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;               // x rows a block: wgmma's N
constexpr int kBK = 64;                // k values per tile
constexpr int kStages = 4;             // cp.async ring depth
constexpr int kMaxCluster = 4;         // K slices summed in a cluster

// kWG warpgroups of 64 weight columns each
template <int kWG>
struct Tile {
  static constexpr int kBN = 64 * kWG;            // output columns a block
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kWStride = kBN + 16;       // bytes per weight row
  static constexpr int kXBytes = 2 * kBM * kBK;   // x in core matrices
  static constexpr int kStage = kXBytes + kBK * kWStride;  // x, then int8
  static constexpr int kBytes = kStages * kStage;
  // the cluster's exchange: fp32 [kBM][kAccStride] over the ring
  static constexpr int kAccStride = kBN + 4;
  static_assert(4 * kBM * kAccStride <= kBytes, "exchange over the ring");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// int8 bytes i and i + 2 of u (flipped: q + 128) → their bf16 pair (byte i
// in the low half), exactly: u's byte sits in the fp32 2^23 + u, one add
// takes 2^23 + 128 off, and the high halves of the two fp32 values are the
// bf16s (an integer of at most 8 significant bits has zero low halves)
__device__ __forceinline__ uint32_t int8_pair(uint32_t u, int i) {
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542 + i)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The int8 weight (K, N): a tile is kBK rows of kBN bytes.  stage() copies
// rows [k0, k0 + kBK) x columns [n0, n0 + kBN) into [kBK][kStride] bytes
// (zeros past K and N).  frags() turns one ldmatrix.x4.trans of 16-bit
// units over k rows 0-31 of 16 columns (matrices: k 0-7, 8-15, 16-23,
// 24-31) into the A fragments of two k16 steps: register r of a matrix
// holds bytes (k 2t, col 2g), (k 2t, col 2g+1), (k 2t+1, col 2g), (k 2t+1,
// col 2g+1), so the MMA's row g is column 2g (bytes 0, 2) and row g + 8
// column 2g + 1 (bytes 1, 3).
struct Int8W {
  template <int kBN, int kStride, int kNThreads>
  __device__ static void stage(int8_t* dst, const void* w, int k0, int n0,
                               int K, int N, bool vec, int tid) {
    const int8_t* wb = static_cast<const int8_t*>(w);
    if (vec) {                 // N % 16 == 0: a chunk is in or out whole
      constexpr int kChunks = kBN / 16;
#pragma unroll
      for (int it = 0; it < kBK * kChunks / kNThreads; ++it) {
        const int i = tid + it * kNThreads;
        const int r = i / kChunks, c = 16 * (i % kChunks);
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(dst + r * kStride + c,
                   ok ? wb + (int64_t)(k0 + r) * N + n0 + c : wb,
                   ok ? 16 : 0);
      }
    } else {                   // N % 4 == 0
      constexpr int kChunks = kBN / 4;
      for (int i = tid; i < kBK * kChunks; i += kNThreads) {
        const int r = i / kChunks, c = 4 * (i % kChunks);
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async4(dst + r * kStride + c,
                  ok ? wb + (int64_t)(k0 + r) * N + n0 + c : wb, ok ? 4 : 0);
      }
    }
  }
  __device__ static void frags(const uint32_t (&m)[4], uint32_t (&a0)[4],
                               uint32_t (&a1)[4]) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = m[i] ^ 0x80808080u;
    a0[0] = int8_pair(u[0], 0);
    a0[1] = int8_pair(u[0], 1);
    a0[2] = int8_pair(u[1], 0);
    a0[3] = int8_pair(u[1], 1);
    a1[0] = int8_pair(u[2], 0);
    a1[1] = int8_pair(u[2], 1);
    a1[2] = int8_pair(u[3], 0);
    a1[3] = int8_pair(u[3], 1);
  }
};

// byte offset of x's element (row r, k c) in a staged tile: core matrix
// (r / 8, c / 8), 128 bytes each, 8 of them along K (a 1024-byte row group)
__device__ __forceinline__ int x_offset(int r, int c) {
  return ((r >> 3) * (kBK / 8) + (c >> 3)) * 128 + (r & 7) * 16 +
         (c & 7) * 2;
}

// rows [r0, r0 + kBM) x k [k0, k0 + kBK) of x → the tile's core matrices,
// zeros past R and K; vec: K % 8 == 0 and x 16-byte aligned (cp.async),
// else element by element (synchronous)
template <int kNThreads>
__device__ __forceinline__ void stage_x(unsigned char* dst, const bf16* x,
                                        int r0, int k0, int R, int K,
                                        bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int it = 0; it < kBM * (kBK / 8) / kNThreads; ++it) {
      const int i = tid + it * kNThreads;
      const int r = i / (kBK / 8), c = 8 * (i % (kBK / 8));
      const bool ok = r0 + r < R && k0 + c < K;
      cp_async16(dst + x_offset(r, c),
                 ok ? x + (int64_t)(r0 + r) * K + k0 + c : x, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kBM * kBK; i += kNThreads) {
      const int r = i / kBK, c = i % kBK;
      *reinterpret_cast<bf16*>(dst + x_offset(r, c)) =
          r0 + r < R && k0 + c < K ? x[(int64_t)(r0 + r) * K + k0 + c]
                                   : __float2bfloat16(0.f);
    }
  }
}

// a shared-memory matrix descriptor without swizzle: the start address,
// the byte offset between core matrices along K (leading) and along the
// rows (stride)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lead,
                                              uint32_t stride) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32);
}

// d (the warpgroup's 64 weight columns x 128 rows, fp32) += a (64 x 16
// bf16, registers: warp w's fragment holds columns 16w ..) · b (16 x 128
// bf16 of x, K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// grid (C, column blocks, row blocks), clusters of the C blocks that split
// one output tile's K; block `rank` sums K tiles [rank·per, (rank+1)·per)
template <class W, typename To, int kWG>
__global__ void __launch_bounds__(128 * kWG, 1)
mm_rows_kernel(const bf16* __restrict__ x, const void* __restrict__ w,
               const float* __restrict__ scale, To* __restrict__ out, int R,
               int K, int N) {
  using T = Tile<kWG>;
  constexpr int kBN = T::kBN;
  extern __shared__ __align__(128) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;
  const int rank = blockIdx.x;                  // == cluster.block_rank()
  const int n0 = blockIdx.y * kBN, r0 = blockIdx.z * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;      // warpgroup, its warp
  const int ntiles = (K + kBK - 1) / kBK;
  const int per = (ntiles + C - 1) / C;
  const int kt0 = rank * per;
  const int nt = max(0, min(ntiles, kt0 + per) - kt0);
  const bool vec_x = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_w = N % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  // tile i of this block's slice → ring stage i % kStages
  auto xs_of = [&](int i) { return smem + (i % kStages) * T::kStage; };
  auto w8_of = [&](int i) {
    return reinterpret_cast<int8_t*>(smem + (i % kStages) * T::kStage +
                                     T::kXBytes);
  };
  auto load = [&](int i) {
    const int k0 = (kt0 + i) * kBK;
    stage_x<T::kThreads>(xs_of(i), x, r0, k0, R, K, vec_x, tid);
    W::template stage<kBN, T::kWStride, T::kThreads>(w8_of(i), w, k0, n0, K,
                                                     N, vec_w, tid);
  };

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load(s);
    cp_async_commit();
  }
  // Tile i landed (and is made visible to wgmma's reads) → the copy of
  // tile i + kStages - 1 starts (into the stage tile i - 1 left, whose
  // wgmmas have completed), then tile i: per 32 k, one ldmatrix.trans of
  // the warp's 16 columns, two A fragments, two wgmmas.
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (i + kStages - 1 < nt) load(i + kStages - 1);
    cp_async_commit();
    const unsigned char* xs = xs_of(i);
    const int8_t* ws = w8_of(i);
#pragma unroll
    for (int kp = 0; kp < kBK / 32; ++kp) {
      uint32_t m[4], a[2][4];
      ldmatrix_x4_trans(m, ws + (32 * kp + (lane & 7) + 8 * (lane >> 3)) *
                                   T::kWStride + 64 * wg + 16 * wq);
      W::frags(m, a[0], a[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_m64n128k16(acc, a[h],
                         smem_desc(xs + 256 * (2 * kp + h), 128, 1024));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  cp_async_wait<0>();

  // acc[4j + e]: column 64wg + 16wq + 2g + (e >> 1), row 8j + 2t + (e & 1)
  const int cl = 64 * wg + 16 * wq + 2 * g;
  if (C == 1) {
    const int col = n0 + cl;
    if (col >= N) return;                 // N % 4 == 0: col + 1 < N too
    const float s0 = scale ? scale[col] : 1.f;
    const float s1 = scale ? scale[col + 1] : 1.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * j + 2 * t + h;
        if (row >= R) continue;
        const float y0 = acc[4 * j + h], y1 = acc[4 * j + 2 + h];
        To* o = out + (int64_t)row * N + col;
        if constexpr (std::is_same<To, float>::value) {
          *reinterpret_cast<float2*>(o) =
              scale ? make_float2(y0 * s0, y1 * s1) : make_float2(y0, y1);
        } else {
          o[0] = from_float<To>(scale ? y0 * s0 : y0);
          o[1] = from_float<To>(scale ? y1 * s1 : y1);
        }
      }
    return;
  }

  __syncthreads();                 // every warp is done with the ring
  float* xs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(xs + (8 * j + 2 * t + h) * T::kAccStride +
                                 cl) =
          make_float2(acc[4 * j + h], acc[4 * j + 2 + h]);
  cluster.sync();                  // every block's partial is in place

  // block `rank` sums every C-th run of kThreads float4s over the ranks in
  // order 0 .. C-1
  constexpr int kPer = kBN / 4;                 // float4s per row
  for (int i = rank * T::kThreads + tid; i < kBM * kPer;
       i += C * T::kThreads) {
    const int row = i / kPer, c = 4 * (i % kPer);
    float* src = xs + row * T::kAccStride + c;
    float4 s =
        *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, 0));
    for (int q = 1; q < C; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, q));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int col = n0 + c;
    if (r0 + row < R && col < N) {              // N % 4 == 0: all 4 or none
      if (scale) {
        s.x *= scale[col];
        s.y *= scale[col + 1];
        s.z *= scale[col + 2];
        s.w *= scale[col + 3];
      }
      To* o = out + (int64_t)(r0 + row) * N + col;
      if constexpr (std::is_same<To, float>::value) {
        *reinterpret_cast<float4*>(o) = s;
      } else {
        o[0] = from_float<To>(s.x);
        o[1] = from_float<To>(s.y);
        o[2] = from_float<To>(s.z);
        o[3] = from_float<To>(s.w);
      }
    }
  }
  cluster.sync();                  // no block leaves while others read it
}

template <class W, typename To, int kWG>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   void* out, int R, int K, int N, int C,
                   cudaStream_t stream) {
  using T = Tile<kWG>;
  cudaError_t e = cudaFuncSetAttribute(
      mm_rows_kernel<W, To, kWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (N + T::kBN - 1) / T::kBN, (R + kBM - 1) / kBM);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mm_rows_kernel<W, To, kWG>,
                         static_cast<const bf16*>(x), w, scale,
                         static_cast<To*>(out), R, K, N);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The body with weight format W and output type To: bn output columns a
// block (128 or 256) and K split over a cluster of C blocks (1 .. 4, at
// most one K tile of 64 each); cudaErrorInvalidValue for anything else.
// The caller's rule picks bn and C (kernels/probe_quant_matmul.py
// mix_tiling).
template <class W, typename To>
int run(const void* x, const void* w, const float* scale, void* out, int R,
        int K, int N, int bn, int C, cudaStream_t s) {
  if (R <= 0 || K <= 0 || N <= 0 || N % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 || C < 1 ||
      C > kMaxCluster || C > (K + kBK - 1) / kBK ||
      (R + kBM - 1) / kBM > 65535 || (N + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 128: return (int)launch<W, To, 2>(x, w, scale, out, R, K, N, C, s);
    case 256: return (int)launch<W, To, 4>(x, w, scale, out, R, K, N, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rows
}  // namespace
