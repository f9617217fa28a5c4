// The ragged route of the weight-quantized matmul (K10, K11a, K11b, K14
// and the probes K15a-e): the shapes the few-row TMA body
// (quant_matmul.cuh) cannot describe, at every row count, and the int4
// and int8 fragment builders that both bodies share,
//
//   y[r, n] = (sum_k bf16(x[r, k]) * q[k, n]) * scale[n]
//
// with q stored as
//   kPlanes (K10)  (K/8, N) int32 nibble planes: nibble j of word [k8, n]
//                  holds q[k8 + j*K/8, n], two's complement;
//   kPairs  (K11b) (K/8, N) int32 bf16-pair words: bits [4p, 4p+4) hold
//                  q[k8 + 2p*K/8, n] + 8 and bits [16+4p, 20+4p) hold
//                  q[k8 + (2p+1)*K/8, n] + 8;
//   kBytes  (K11a) (K/2, N) int8 split-half bytes: the low nibble of byte
//                  [k2, n] holds q[k2, n], the high one q[k2 + K/2, n], two's
//                  complement (K even);
//   kInt8   (K14)  (K, N) int8;
// scale (N,) f32 (nullptr: none); fp32 accumulation, the scale in the fp32
// epilogue, y in x's dtype.
//
// A shape takes this route where TMA cannot describe its weight: a row
// stride that is not a multiple of 16 bytes (N % 4 != 0 for the int32
// words, N % 16 != 0 for the byte formats), an int4 K off the 64-value
// tile, an int8 K off the 8-value row of x, an unaligned base, or an x
// slice past a block's shared memory (kernels/quant_matmul.py few_fit and
// rows_fit are the rule).  No model projection of the port takes it.
// It is the body the port ran at every few-row call before the TMA body:
// a warp owns 32 output columns (two mma.sync m16n8k16 tiles of 16 rows,
// the product transposed) and up to 8 tiles of 8 activation rows, loads
// its weights straight from global memory into registers (kVec: one
// 16-byte load a step where N % 4 == 0 and the weight is 16-byte aligned,
// else byte loads), and stages x in shared memory 256 k values at a time;
// K is split across blocks and the splits' fp32 partials are summed in
// split order by quant_matmul_reduce_kernel, a second launch (no atomics,
// so the result does not change from run to run).
//
// The fragment builders.  Thread (g, t) of a warp owns the four adjacent
// columns 4g .. 4g+3 (MMA rows g and g + 8 of tile 0 are columns 4g and
// 4g+1, of tile 1 columns 4g+2 and 4g+3).  The int4 formats: a 32-k step
// is one word row ("quarter row") of 4 columns; the k values of MMA m at kk
// 2t, 2t+1, 2t+8, 2t+9 are planes (2m, 2m+4, 2m+1, 2m+5) of that word row,
// plane j being the rows [j*K/8, (j+1)*K/8).  Planes take nibble pairs (j,
// j+4) with one shift and mask; pairs hold planes (2p, 2p+1) side by side,
// so two masked shifts and a byte permute give the same (j, j+4) pairs;
// split-half bytes hold planes j and j + 4 in the low and high nibble of
// byte row j*K/8 + the word row (j < 4).  The bias: bits 0x4300 | u are the
// bf16 of 128 + u for u < 16 (planes and bytes flip bit 3 first: u =
// value + 8), and one bf16x2 subtraction of 136 leaves the value exactly.
// So the three int4 formats build the same fragments from the same
// integers.  (JAX's TPU pairs kernel subtracts 136 * rowsum(x) in its fp32
// epilogue instead; these kernels are exact.)
#pragma once

#include "common.cuh"

namespace {

using p2t::from_float;
using p2t::mma_bf16;

enum Format : int { kPlanes = 0, kPairs = 1, kBytes = 2, kInt8 = 3 };

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpCols = 32;                       // two MMA tiles of 16
constexpr int kBlockCols = kWarps * kWarpCols;      // 128 columns per block
constexpr int kTileRows = 8;                        // MMA N: activation rows
constexpr int kStageK = 256;                        // k values staged per fill

// A K step: the int4 formats cover 4 quarter rows = 32 k values (two MMAs
// per tile); int8 covers 16 k rows (one MMA per tile).
template <int kF>
struct Fmt {
  static constexpr bool kInt4 = kF != kInt8;
  static constexpr int kStepK = kInt4 ? 32 : 16;
  static constexpr int kMmas = kInt4 ? 2 : 1;
};

template <int kF>
__host__ __device__ constexpr int num_steps(int K) {
  return (K + Fmt<kF>::kStepK - 1) / Fmt<kF>::kStepK;
}

// x as staged: bf16 x is copied, f32 x rounded
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t pack_bf16(int lo, int hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                                 static_cast<float>(hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// t holds u0 in bits [0, 4) and u1 in bits [16, 20): bits 0x4300 | u are
// the bf16 of 128 + u, so subtracting 136 gives the two exact bf16 values
// u0 - 8 and u1 - 8
__device__ __forceinline__ uint32_t biased_pair(uint32_t t) {
  t |= 0x43004300u;
  const __nv_bfloat162 v = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&t),
      __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// planes: nibbles j and j + 4 of w (j = s / 4), bit 3 flipped to add 8
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, int s) {
  return biased_pair(((w >> s) & 0x000F000Fu) ^ 0x00080008u);
}

// pairs: planes (2m, 2m+4) into *lo and (2m+1, 2m+5) into *hi — the
// planes format's nibble pairs (2m, 2m+4) and (2m+1, 2m+5)
__device__ __forceinline__ void pair_planes(uint32_t w, int m, uint32_t* lo,
                                            uint32_t* hi) {
  const uint32_t t0 = (w >> (4 * m)) & 0x000F000Fu;      // planes 2m, 2m+1
  const uint32_t t1 = (w >> (4 * m + 8)) & 0x000F000Fu;  // planes 2m+4, 2m+5
  *lo = biased_pair(__byte_perm(t0, t1, 0x5410));
  *hi = biased_pair(__byte_perm(t0, t1, 0x7632));
}

// split-half bytes: the low and high nibble of byte c of w (planes j and
// j + 4), bit 3 flipped to add 8
__device__ __forceinline__ uint32_t byte_nibbles(uint32_t w, int c) {
  const uint32_t b = w >> (8 * c);
  return biased_pair(((b & 0xFu) | ((b & 0xF0u) << 12)) ^ 0x00080008u);
}

__device__ __forceinline__ int byte_at(uint32_t w, int c) {
  return static_cast<int32_t>(w << (24 - 8 * c)) >> 24;
}

// 4 bytes of row k of an (rows, N) int8 buffer, columns nc .. nc + 3 (0
// where out of range); kVec: N % 4 == 0 and the buffer 16-byte aligned
template <bool kVec>
__device__ __forceinline__ uint32_t load_row4(const int8_t* __restrict__ w,
                                              int k, bool valid, int nc,
                                              int N) {
  const int8_t* p = w + (int64_t)k * N + nc;
  if (kVec) return (valid && nc < N) ? *reinterpret_cast<const uint32_t*>(p)
                                     : 0u;
  uint32_t u = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (valid && nc + c < N)
      u |= static_cast<uint32_t>(static_cast<uint8_t>(p[c])) << (8 * c);
  return u;
}

// One K step's weights of thread (g, t), columns nc .. nc + 3 (nc = n0 +
// 4g), quarter row k8 = 4*step + t: planes and pairs — v[c] is the word of
// column nc + c at word row k8; split-half bytes — v[j] holds byte c = row
// j*Kq + k8 of column nc + c (Kq = ceil(K/8)); int8 — v[i] holds byte c =
// row 16*step + 4t + i of column nc + c.  Out-of-range rows and columns
// load 0.  kVec: N % 4 == 0 and the buffer 16-byte aligned, so a thread's 4
// columns are in or out together.
template <int kF, bool kVec>
__device__ __forceinline__ void load_step(const void* __restrict__ w,
                                          int step, int nc, int t, int K,
                                          int N, uint32_t (&v)[4]) {
  if constexpr (kF == kPlanes || kF == kPairs) {
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
  } else if constexpr (kF == kBytes) {
    const int8_t* wb = static_cast<const int8_t*>(w);
    const int K2 = K / 2, Kq = (K2 + 3) / 4, k8 = 4 * step + t;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = load_row4<kVec>(wb, j * Kq + k8, k8 < Kq && j * Kq + k8 < K2,
                             nc, N);
  } else {
    const int8_t* wb = static_cast<const int8_t*>(w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 16 * step + 4 * t + i;
      v[i] = load_row4<kVec>(wb, k, k < K, nc, N);
    }
  }
}

// A fragments of tile h (columns 4g+2h, 4g+2h+1), MMA m: int4 — planes
// (2m, 2m+4) and (2m+1, 2m+5) of the two columns at the quarter row;
// int8 — rows 4t, 4t+1 and 4t+2, 4t+3 of the two columns
template <int kF>
__device__ __forceinline__ void a_frags(const uint32_t (&v)[4], int h,
                                        uint32_t (&a)[Fmt<kF>::kMmas][4]) {
#pragma unroll
  for (int m = 0; m < Fmt<kF>::kMmas; ++m) {
    if constexpr (kF == kPlanes) {
      a[m][0] = nibble_pair(v[2 * h], 8 * m);
      a[m][1] = nibble_pair(v[2 * h + 1], 8 * m);
      a[m][2] = nibble_pair(v[2 * h], 8 * m + 4);
      a[m][3] = nibble_pair(v[2 * h + 1], 8 * m + 4);
    } else if constexpr (kF == kPairs) {
      pair_planes(v[2 * h], m, &a[m][0], &a[m][2]);
      pair_planes(v[2 * h + 1], m, &a[m][1], &a[m][3]);
    } else if constexpr (kF == kBytes) {
      a[m][0] = byte_nibbles(v[2 * m], 2 * h);
      a[m][1] = byte_nibbles(v[2 * m], 2 * h + 1);
      a[m][2] = byte_nibbles(v[2 * m + 1], 2 * h);
      a[m][3] = byte_nibbles(v[2 * m + 1], 2 * h + 1);
    } else {
      a[m][0] = pack_bf16(byte_at(v[0], 2 * h), byte_at(v[1], 2 * h));
      a[m][1] = pack_bf16(byte_at(v[0], 2 * h + 1), byte_at(v[1], 2 * h + 1));
      a[m][2] = pack_bf16(byte_at(v[2], 2 * h), byte_at(v[3], 2 * h));
      a[m][3] = pack_bf16(byte_at(v[2], 2 * h + 1), byte_at(v[3], 2 * h + 1));
    }
  }
}

// x value staged at position q of a fill that starts at step sb: its k (K
// when it lies past the end: staged as 0) and its position in the row
template <int kF>
__device__ __forceinline__ void stage_slot(int q, int sb, int K, int* k,
                                           int* pos) {
  if constexpr (Fmt<kF>::kInt4) {
    // [quarter row][planes (j, j+4)]: planes 0,4,1,5,2,6,3,7; plane j of
    // quarter row k8 is k = (j % 4)*Kq + k8, + K/2 for j >= 4 (Kq = K/8
    // when K % 8 == 0)
    const int K2 = K / 2, Kq = (K2 + 3) / 4;
    const int k8l = q % (kStageK / 8), j = q / (kStageK / 8);
    const int k8 = 4 * sb + k8l, row = (j % 4) * Kq + k8;
    *k = k8 < Kq && row < K2 ? row + (j / 4) * K2 : K;
    *pos = k8l * 8 + 2 * (j % 4) + j / 4;
  } else {
    *k = 16 * sb + q;
    *pos = q;
  }
}

// The policy of format kF for the body below: the k values of a K step
// (kStepK) and its MMAs per tile (kMmas), the steps loaded ahead (kUnroll),
// the x values staged per fill (kStage) and the padding of a staged row
// (kPad, bf16 elements, so that the B-fragment loads of a warp hit distinct
// banks).  load() reads one step's weights of a thread, frags() builds tile h's A
// fragments, slot() places x value q of a fill that starts at step sb.
template <int kF, bool kVec>
struct FormatPolicy : Fmt<kF> {
  static constexpr int kUnroll = 8;             // K steps loaded ahead
  static constexpr int kStage = kStageK;
  static constexpr int kPad = Fmt<kF>::kInt4 ? 32 : 16;
  __device__ static void load(const void* w, int step, int nc, int t, int K,
                              int N, uint32_t (&v)[4]) {
    load_step<kF, kVec>(w, step, nc, t, K, N, v);
  }
  __device__ static void frags(const uint32_t (&v)[4], int h,
                               uint32_t (&a)[Fmt<kF>::kMmas][4]) {
    a_frags<kF>(v, h, a);
  }
  __device__ static void slot(int q, int sb, int K, int* k, int* pos) {
    stage_slot<kF>(q, sb, K, k, pos);
  }
};

// kRT row tiles and kW warps of 32 columns per block; x of type T, the
// output of type To; scale == nullptr: no scale
template <class P, typename T, typename To, int kRT, int kW>
__global__ void __launch_bounds__(kW * 32)
quant_mma_kernel(const T* __restrict__ x, const void* __restrict__ w,
                 const float* __restrict__ scale, To* __restrict__ out,
                 float* __restrict__ partial, int R, int K, int N,
                 int steps_per_split) {
  constexpr int kNThreads = kW * 32;
  constexpr int kRows = kRT * kTileRows;
  constexpr int kStride = P::kStage + P::kPad;
  constexpr int kFill = P::kStage / P::kStepK;      // steps per fill
  __shared__ __align__(16) __nv_bfloat16 xs[kRows * kStride];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kRows;
  const int nc = blockIdx.y * (kW * kWarpCols) + warp * kWarpCols + 4 * g;
  const int nsteps = (K + P::kStepK - 1) / P::kStepK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(nsteps, s_begin + steps_per_split);

  float acc[kRT][2][4];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][h][c] = 0.f;

  for (int sb = s_begin; sb < s_end; sb += kFill) {
    const int ns = min(kFill, s_end - sb);
    // stage x[r0 .. r0 + kRows, the fill's k values] as bf16 in the order
    // the B fragments read it; the global index runs fastest across threads
    for (int e = threadIdx.x; e < kRows * P::kStage; e += kNThreads) {
      const int r = e / P::kStage;
      int k, pos;
      P::slot(e % P::kStage, sb, K, &k, &pos);
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (r0 + r < R && k < K) v = to_bf16(x[(int64_t)(r0 + r) * K + k]);
      xs[r * kStride + pos] = v;
    }
    __syncthreads();
    for (int s0 = 0; s0 < ns; s0 += P::kUnroll) {
      uint32_t wv[P::kUnroll][4];
#pragma unroll
      for (int u = 0; u < P::kUnroll; ++u)
        if (s0 + u < ns) P::load(w, sb + s0 + u, nc, t, K, N, wv[u]);
#pragma unroll
      for (int u = 0; u < P::kUnroll; ++u) {
        if (s0 + u >= ns) break;
        const int sl = s0 + u;
        uint32_t a[2][P::kMmas][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) P::frags(wv[u], h, a[h]);
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const __nv_bfloat16* xr =
              &xs[(i * kTileRows + g) * kStride + P::kStepK * sl];
          uint32_t b[P::kMmas][2];
          if constexpr (P::kMmas == 2) {
            const uint4 u4 = *reinterpret_cast<const uint4*>(xr + 8 * t);
            b[0][0] = u4.x; b[0][1] = u4.y; b[1][0] = u4.z; b[1][1] = u4.w;
          } else {
            const uint2 u2 = *reinterpret_cast<const uint2*>(xr + 4 * t);
            b[0][0] = u2.x; b[0][1] = u2.y;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int m = 0; m < P::kMmas; ++m)
              mma_bf16(acc[i][h], a[h][m], b[m][0], b[m][1]);
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
          out[(int64_t)r * N + n] = from_float<To>(
              scale ? acc[i][h][c] * scale[n] : acc[i][h][c]);
      }
}

// out[r, n] = (sum over splits, in order, of partial) * scale[n]; no scale
// (nullptr): the sum
template <typename To>
__global__ void __launch_bounds__(256)
quant_matmul_reduce_kernel(const float* __restrict__ partial,
                           const float* __restrict__ scale,
                           To* __restrict__ out, int R, int N, int splits) {
  const int64_t total = (int64_t)R * N;
  for (int64_t i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * 256) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * total + i];
    out[i] = from_float<To>(scale ? s * scale[i % N] : s);
  }
}

template <typename To>
void launch_reduce(const float* partial, const float* scale, To* out, int R,
                   int N, int splits, cudaStream_t stream) {
  const int64_t total = (int64_t)R * N;
  const int64_t blocks64 = (total + 255) / 256;
  const int blocks = (int)(blocks64 < 4096 ? blocks64 : 4096);
  quant_matmul_reduce_kernel<To><<<blocks, 256, 0, stream>>>(
      partial, scale, out, R, N, splits);
}

template <class P, typename T, typename To, int kRT, int kW>
void launch_rt(const void* x, const void* w, const float* scale, void* out,
               float* partial, int R, int K, int N, int splits, int per,
               cudaStream_t stream) {
  constexpr int kRows = kRT * kTileRows, kCols = kW * kWarpCols;
  const dim3 grid((R + kRows - 1) / kRows, (N + kCols - 1) / kCols, splits);
  quant_mma_kernel<P, T, To, kRT, kW><<<grid, kW * 32, 0, stream>>>(
      static_cast<const T*>(x), w, scale, static_cast<To*>(out), partial, R,
      K, N, per);
}

// the body with policy P, then the split-K reduction; the fewest row tiles
// that hold R (at most 8: 64 rows)
template <class P, typename T, typename To, int kW = kWarps>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   void* out, float* partial, int R, int K, int N,
                   int splits, cudaStream_t stream) {
  const int nsteps = (K + P::kStepK - 1) / P::kStepK;
  const int per = (nsteps + splits - 1) / splits;
  if (R <= 8)
    launch_rt<P, T, To, 1, kW>(x, w, scale, out, partial, R, K, N,
                                      splits, per, stream);
  else if (R <= 16)
    launch_rt<P, T, To, 2, kW>(x, w, scale, out, partial, R, K, N,
                                      splits, per, stream);
  else if (R <= 32)
    launch_rt<P, T, To, 4, kW>(x, w, scale, out, partial, R, K, N,
                                      splits, per, stream);
  else if (R <= 40)           // a γ-4 verify round at B 8
    launch_rt<P, T, To, 5, kW>(x, w, scale, out, partial, R, K, N,
                                      splits, per, stream);
  else
    launch_rt<P, T, To, 8, kW>(x, w, scale, out, partial, R, K, N,
                                      splits, per, stream);
  if (splits > 1)
    launch_reduce<To>(partial, scale, static_cast<To*>(out), R, N, splits,
                      stream);
  return cudaGetLastError();
}

// the checks every entry makes, then the launch in x's dtype; splits >= 1
// slices of K (in steps of Fmt::kStepK k values), with `partial` an
// (splits, R, N) fp32 scratch buffer when splits > 1 (the wrapper picks
// splits and allocates it)
template <int kF>
int run(const void* x, const void* w, const void* scale, void* out,
        void* partial, int R, int K, int N, int splits, int dtype,
        void* stream) {
  const int k_mult = kF == kPlanes || kF == kPairs ? 8 : kF == kBytes ? 2 : 1;
  if (R <= 0 || K <= 0 || N <= 0 || K % k_mult != 0 || splits <= 0 ||
      splits > 65535 || (splits > 1 && partial == nullptr) ||
      (N + kBlockCols - 1) / kBlockCols > 65535 ||
      splits > num_steps<kF>(K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(partial);
  // vec: N % 4 == 0 and the weight 16-byte aligned (wide weight loads)
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (dtype == p2t::kFloat32)
    return (int)(vec ? launch<FormatPolicy<kF, true>, float, float>(
                           x, w, sc, out, pt, R, K, N, splits, s)
                     : launch<FormatPolicy<kF, false>, float, float>(
                           x, w, sc, out, pt, R, K, N, splits, s));
  if (dtype == p2t::kBFloat16) {
    using bf16 = __nv_bfloat16;
    return (int)(vec ? launch<FormatPolicy<kF, true>, bf16, bf16>(
                           x, w, sc, out, pt, R, K, N, splits, s)
                     : launch<FormatPolicy<kF, false>, bf16, bf16>(
                           x, w, sc, out, pt, R, K, N, splits, s));
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
