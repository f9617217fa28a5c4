// K10 and K14: weight-quantized matmul for the few-row products of serving,
//
//   y[r, n] = (sum_k bf16(x[r, k]) * w[k, n]) * scale[n]
//
// x (R, K) f32 or bf16, rounded to bf16 as it is staged; w int4 nibble
// planes (K/8, N) int32, nibble j of word [k8, n] holding w[k8 + j*K/8, n]
// (K10), or int8 (K, N) (K14); scale (N,) f32; fp32 accumulation, the scale
// in the fp32 epilogue, y in x's dtype.  The stacked entry points of the
// wrapper pass the layer's base pointer into an (L, ...) buffer.
//
// Replaces prot2text_tpu/kernels/quant_matmul.py quant_matmul_int4_planes
// (_mm_i4p_kernel) and quant_matmul_int4_planes_stacked
// (_mm_i4p_stacked_kernel) for K10, quant_matmul_int8 (_mm_i8_kernel) and
// quant_matmul_int8_stacked (_mm_i8_stacked_kernel) for K14.  The TPU
// kernels walked an (N/bn, K/bk) grid in order, carrying the row block's
// sum in VMEM; the stacked variants existed because a Pallas operand must be
// a materialized buffer.  Here a pointer offset selects the layer, and
// blocks run in no order, so a split of K across blocks is summed by a
// second, deterministic pass.
//
// Bound: bytes.  At R <= 40 rows the weights dominate: Qwen3-14B's gate/up/
// down read 44.6 MB (int4) or 89.1 MB (int8), 13.3 or 26.6 us at 3.35 TB/s,
// the int4 LM head 389 MB (116 us).  The products, 2*R*K*N operations, are
// far below the tensor cores' rate at these rows, so the design streams the
// weights once and keeps the arithmetic off the CUDA cores.
// Design: the product is computed transposed, y^T = W^T x^T, on the bf16
// tensor cores (mma.sync m16n8k16, fp32 accumulators): a warp owns 32
// output columns (two MMA tiles of 16 rows) and up to 8 tiles of 8
// activation rows (the MMA's 8 columns), and walks K.  Its A fragments are
// built in registers straight from the loaded weights, which makes the
// loads wide and coalesced: which output column an MMA row stands for, and
// in which order the sum runs over k, are free, so thread (g, t) owns the
// four adjacent columns 4g .. 4g+3 (MMA rows g and g + 8 of tile 0 are
// columns 4g and 4g+1, of tile 1 columns 4g+2 and 4g+3) and loads them with
// one 16-byte word-row load per step (int4: word row 4*step + t, whose
// nibble pairs (j, j+4) become two bf16 values with one subtraction, two
// MMAs per tile) or four 4-byte loads (int8:
// rows 16*step + 4t .. + 3) — a warp reads 128 (int4) or 32 (int8)
// contiguous bytes of each of 4 rows.  x is staged in shared memory as
// bf16 in the same k order, so each B fragment is one 16-byte (int4) or
// 8-byte (int8) conflict-free load.  int4/int8 values are exact in bf16,
// so only x's rounding and the order of the fp32 sums separate the result
// from the plain version.  K is split across blocks until about six blocks
// per SM are resident (the loads in flight set the rate); the splits'
// partial sums go to an fp32 scratch buffer and a second kernel adds them
// in split order (no atomics: the result does not change from run to
// run).
#include "common.cuh"

namespace {

using p2t::from_float;
using p2t::to_float;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpCols = 32;                       // two MMA tiles of 16
constexpr int kBlockCols = kWarps * kWarpCols;      // 128 columns per block
constexpr int kTileRows = 8;                        // MMA N: activation rows
constexpr int kStageK = 256;                        // k values staged per fill
constexpr int kUnroll = 8;                          // K steps loaded ahead

// A K step: int4 covers 4 word rows = 32 k values (two MMAs per tile);
// int8 covers 16 k rows (one MMA per tile).  Shared-memory row strides are
// padded so that the B-fragment loads of a warp hit distinct banks.
template <bool kInt4>
struct Fmt {
  static constexpr int kStepK = kInt4 ? 32 : 16;
  static constexpr int kStageSteps = kStageK / kStepK;
  static constexpr int kRowStride = kStageK + (kInt4 ? 32 : 16);  // bf16
};

__device__ __forceinline__ uint32_t pack_bf16(int lo, int hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                                 static_cast<float>(hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// nibbles j and j + 4 of w (j = s / 4) as two exact bf16 values: bits
// 0x4300 | (nibble ^ 8) are the bf16 of 128 + (value + 8), and subtracting
// 136 leaves the value (every step is exact in bf16)
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, int s) {
  const uint32_t t =
      (((w >> s) & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&t),
      __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ int byte_at(uint32_t w, int c) {
  return static_cast<int32_t>(w << (24 - 8 * c)) >> 24;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One K step's weights of thread (g, t), columns nc .. nc + 3 (nc = n0 +
// 4g): int4 — v[c] is the word of column nc + c at word row 4*step + t;
// int8 — v[i] holds byte c = row 16*step + 4t + i of column nc + c.
// Out-of-range rows and columns load 0.  kVec: N % 4 == 0 and the buffer
// 16-byte aligned, so a thread's 4 columns are in or out together.
template <bool kInt4, bool kVec>
__device__ __forceinline__ void load_step(const void* __restrict__ w,
                                          int step, int nc, int t, int K,
                                          int N, uint32_t (&v)[4]) {
  if (kInt4) {
    const int k8 = 4 * step + t;
    const int32_t* p = static_cast<const int32_t*>(w) + (int64_t)k8 * N + nc;
    if (kVec) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (k8 < K / 8 && nc < N) u = *reinterpret_cast<const uint4*>(p);
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = (k8 < K / 8 && nc + c < N) ? static_cast<uint32_t>(p[c]) : 0u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 16 * step + 4 * t + i;
      const int8_t* p = static_cast<const int8_t*>(w) + (int64_t)k * N + nc;
      if (kVec) {
        v[i] = (k < K && nc < N) ? *reinterpret_cast<const uint32_t*>(p)
                                 : 0u;
      } else {
        uint32_t u = 0u;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k < K && nc + c < N)
            u |= static_cast<uint32_t>(static_cast<uint8_t>(p[c])) << (8 * c);
        v[i] = u;
      }
    }
  }
}

template <typename T, bool kInt4, bool kVec, int kRT>
__global__ void __launch_bounds__(kThreads)
quant_mma_kernel(const T* __restrict__ x, const void* __restrict__ w,
                 const float* __restrict__ scale, T* __restrict__ out,
                 float* __restrict__ partial, int R, int K, int N,
                 int steps_per_split) {
  using F = Fmt<kInt4>;
  constexpr int kRows = kRT * kTileRows;
  __shared__ __align__(16) __nv_bfloat16 xs[kRows * F::kRowStride];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kRows;
  const int nc = blockIdx.y * kBlockCols + warp * kWarpCols + 4 * g;
  const int K8 = K / 8;
  const int nsteps = (K + F::kStepK - 1) / F::kStepK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(nsteps, s_begin + steps_per_split);

  float acc[kRT][2][4];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][h][c] = 0.f;

  for (int sb = s_begin; sb < s_end; sb += F::kStageSteps) {
    const int ns = min(F::kStageSteps, s_end - sb);
    // stage x[r0 .. r0 + kRows, the fill's k values] as bf16 in the order
    // the B fragments read it: int4 [row][word row][nibble pairs (j, j+4)]
    // (k = word row + j*K/8), int8 [row][k]; the global index runs fastest
    // across threads
    for (int e = threadIdx.x; e < kRows * kStageK; e += kThreads) {
      const int r = e / kStageK;
      const int q = e % kStageK;
      int k, pos;
      if (kInt4) {
        const int k8l = q % (kStageK / 8), j = q / (kStageK / 8);
        const int k8 = 4 * sb + k8l;
        k = k8 < K8 ? k8 + j * K8 : K;
        pos = k8l * 8 + 2 * (j % 4) + j / 4;     // nibbles 0,4,1,5,2,6,3,7
      } else {
        k = 16 * sb + q;
        pos = q;
      }
      float v = 0.f;
      if (r0 + r < R && k < K) v = to_float(x[(int64_t)(r0 + r) * K + k]);
      xs[r * F::kRowStride + pos] = __float2bfloat16(v);
    }
    __syncthreads();
    for (int s0 = 0; s0 < ns; s0 += kUnroll) {
      uint32_t wv[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (s0 + u < ns)
          load_step<kInt4, kVec>(w, sb + s0 + u, nc, t, K, N, wv[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s0 + u >= ns) break;
        const int sl = s0 + u;
        const uint32_t* v = wv[u];
        // A fragments of tile h (columns 4g+2h, 4g+2h+1), MMA m: int4 —
        // nibble pairs (2m, 2m+4) and (2m+1, 2m+5) of the two columns'
        // words; int8 — rows 4t, 4t+1 and 4t+2, 4t+3 of the two columns
        uint32_t a[2][kInt4 ? 2 : 1][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (kInt4) {
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              a[h][m][0] = nibble_pair(v[2 * h], 8 * m);
              a[h][m][1] = nibble_pair(v[2 * h + 1], 8 * m);
              a[h][m][2] = nibble_pair(v[2 * h], 8 * m + 4);
              a[h][m][3] = nibble_pair(v[2 * h + 1], 8 * m + 4);
            }
          } else {
            a[h][0][0] = pack_bf16(byte_at(v[0], 2 * h), byte_at(v[1], 2 * h));
            a[h][0][1] = pack_bf16(byte_at(v[0], 2 * h + 1),
                                   byte_at(v[1], 2 * h + 1));
            a[h][0][2] = pack_bf16(byte_at(v[2], 2 * h), byte_at(v[3], 2 * h));
            a[h][0][3] = pack_bf16(byte_at(v[2], 2 * h + 1),
                                   byte_at(v[3], 2 * h + 1));
          }
        }
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const __nv_bfloat16* xr = &xs[(i * kTileRows + g) * F::kRowStride];
          if (kInt4) {
            const uint4 b =
                *reinterpret_cast<const uint4*>(xr + (4 * sl + t) * 8);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mma_bf16(acc[i][h], a[h][0][0], a[h][0][1], a[h][0][2],
                       a[h][0][3], b.x, b.y);
              mma_bf16(acc[i][h], a[h][1][0], a[h][1][1], a[h][1][2],
                       a[h][1][3], b.z, b.w);
            }
          } else {
            const uint2 b =
                *reinterpret_cast<const uint2*>(xr + 16 * sl + 4 * t);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              mma_bf16(acc[i][h], a[h][0][0], a[h][0][1], a[h][0][2],
                       a[h][0][3], b.x, b.y);
          }
        }
      }
    }
    __syncthreads();
  }
  // tile h's accumulator: (c0, c1) = column nc + 2h, rows 2t and 2t + 1 of
  // the row tile; (c2, c3) = column nc + 2h + 1, the same rows
  float* p = gridDim.z > 1 ? partial + (int64_t)blockIdx.z * R * N : nullptr;
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + i * kTileRows + 2 * t + (c & 1);
        const int n = nc + 2 * h + (c >> 1);
        if (r >= R || n >= N) continue;
        if (p)
          p[(int64_t)r * N + n] = acc[i][h][c];
        else
          out[(int64_t)r * N + n] = from_float<T>(acc[i][h][c] * scale[n]);
      }
}

// out[r, n] = (sum over splits, in order, of partial) * scale[n]
template <typename T>
__global__ void __launch_bounds__(256)
quant_matmul_reduce_kernel(const float* __restrict__ partial,
                           const float* __restrict__ scale,
                           T* __restrict__ out, int R, int N, int splits) {
  const int64_t total = (int64_t)R * N;
  for (int64_t i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * 256) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * total + i];
    out[i] = from_float<T>(s * scale[i % N]);
  }
}

template <typename T, bool kInt4, bool kVec, int kRT>
void launch_rt(const void* x, const void* w, const float* scale, void* out,
               float* partial, int R, int K, int N, int splits, int per,
               cudaStream_t stream) {
  constexpr int kRows = kRT * kTileRows;
  const dim3 grid((R + kRows - 1) / kRows,
                  (N + kBlockCols - 1) / kBlockCols, splits);
  quant_mma_kernel<T, kInt4, kVec, kRT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, scale, static_cast<T*>(out), partial, R,
      K, N, per);
}

template <typename T, bool kInt4, bool kVec>
void launch_vec(const void* x, const void* w, const float* scale, void* out,
                float* partial, int R, int K, int N, int splits, int per,
                cudaStream_t stream) {
  // the fewest row tiles per block that hold R (at most 8: 64 rows)
  if (R <= 8)
    launch_rt<T, kInt4, kVec, 1>(x, w, scale, out, partial, R, K, N, splits,
                                 per, stream);
  else if (R <= 16)
    launch_rt<T, kInt4, kVec, 2>(x, w, scale, out, partial, R, K, N, splits,
                                 per, stream);
  else if (R <= 32)
    launch_rt<T, kInt4, kVec, 4>(x, w, scale, out, partial, R, K, N, splits,
                                 per, stream);
  else if (R <= 40)           // a γ-4 verify round at B 8
    launch_rt<T, kInt4, kVec, 5>(x, w, scale, out, partial, R, K, N, splits,
                                 per, stream);
  else
    launch_rt<T, kInt4, kVec, 8>(x, w, scale, out, partial, R, K, N, splits,
                                 per, stream);
}

template <typename T, bool kInt4>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   void* out, float* partial, int R, int K, int N,
                   int splits, cudaStream_t stream) {
  const int nsteps = (K + Fmt<kInt4>::kStepK - 1) / Fmt<kInt4>::kStepK;
  const int per = (nsteps + splits - 1) / splits;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    launch_vec<T, kInt4, true>(x, w, scale, out, partial, R, K, N, splits,
                               per, stream);
  else
    launch_vec<T, kInt4, false>(x, w, scale, out, partial, R, K, N, splits,
                                per, stream);
  if (splits > 1) {
    const int64_t total = (int64_t)R * N;
    const int64_t blocks64 = (total + 255) / 256;
    const int blocks = (int)(blocks64 < 4096 ? blocks64 : 4096);
    quant_matmul_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
        partial, scale, static_cast<T*>(out), R, N, splits);
  }
  return cudaGetLastError();
}

}  // namespace

// bits 4 (w: (K/8, N) int32 nibble planes) or 8 (w: (K, N) int8); splits
// >= 1 slices of K (in steps of 32 k values for int4, 16 for int8), with
// `partial` an (splits, R, N) fp32 scratch buffer when splits > 1 (the
// wrapper picks splits and allocates it)
extern "C" int p2t_quant_matmul(const void* x, const void* w,
                                const void* scale, void* out, void* partial,
                                int R, int K, int N, int bits, int splits,
                                int dtype, void* stream) {
  const int step_k = bits == 4 ? 32 : 16;
  if (R <= 0 || K <= 0 || N <= 0 || splits <= 0 || splits > 65535 ||
      (bits != 4 && bits != 8) || (bits == 4 && K % 8 != 0) ||
      (splits > 1 && partial == nullptr) ||
      (N + kBlockCols - 1) / kBlockCols > 65535 ||
      splits > (K + step_k - 1) / step_k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(partial);
  if (dtype == p2t::kFloat32)
    return (int)(bits == 4 ? launch<float, true>(x, w, sc, out, pt, R, K, N,
                                                 splits, s)
                           : launch<float, false>(x, w, sc, out, pt, R, K, N,
                                                  splits, s));
  if (dtype == p2t::kBFloat16)
    return (int)(bits == 4 ? launch<__nv_bfloat16, true>(x, w, sc, out, pt,
                                                         R, K, N, splits, s)
                           : launch<__nv_bfloat16, false>(x, w, sc, out, pt,
                                                          R, K, N, splits, s));
  return (int)cudaErrorInvalidValue;
}
