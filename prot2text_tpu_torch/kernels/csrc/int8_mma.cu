// K15f: int8 x int8 matmul on the int8 tensor cores, exact,
//
//   y[r, n] = sum_k x[r, k] * w[k, n]          (int32, no scale)
//
// x (R, K) int8, w (K, N) int8 row-major, y (R, N) int32.
//
// Replaces scripts/bench_int8_mxu.py mm_i8i8 (`:102`, body `_i8_kernel`
// `:85`), the TPU probe of whether an int8 x int8 product runs at the int8
// rate.  The TPU kernel walked an (N/bn, K/bk) grid in order, carrying an
// int32 sum in VMEM.
//
// Bound: at the probe's R 128, bytes.  The weight (4096, 14336) is 58.7 MB
// and the int32 output 7.3 MB: 19.9 us at 3.35 TB/s; its 15.0 G operations
// take 7.6 us at the int8 dense rate (1979 TOP/s).  A product reaches the
// int8 rate only from about 2R operations per weight byte = 590, R ~ 300.
// Design: the ragged route's layout (csrc/quant_matmul_ragged.cuh), on
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: the product is computed
// transposed, y^T = w^T x^T; a warp owns 32 output columns (two MMA tiles of
// 16 rows) and up to 16 tiles of 8 x rows (the MMA's 8 columns), so at R 128
// one block holds every row and the weight streams once.  Thread (g, t) owns
// columns 4g .. 4g+3 of its warp; a K step covers 32 k values: the thread
// loads 4 bytes (its 4 columns) of rows 32 step + 8t + i, i < 8, and a 4x4
// byte transpose (__byte_perm) turns each 4 rows x 4 columns into one A
// register per column (MMA k 4t .. 4t+3 are rows 8t .. 8t+3, MMA k 16 + 4t
// .. are rows 8t + 4 ..), so a B fragment is 8 contiguous bytes of an x row,
// staged in shared memory in plain k order.  int32 accumulation is exact
// and order-free: a split of K across blocks is summed into the same
// integers by quant_matmul_ragged.cuh's second pass.
#include "quant_matmul_ragged.cuh"

namespace {

constexpr int kI8Stage = 256;          // k values (bytes) staged per fill
constexpr int kI8Stride = kI8Stage + 32;   // bytes: conflict-free 8B reads
constexpr int kI8Unroll = 4;           // K steps loaded ahead

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows v[0..3] (4 bytes each: columns 0..3) -> columns c[0..3] (4 bytes
// each: rows 0..3)
__device__ __forceinline__ void transpose4(const uint32_t* v, uint32_t* c) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

template <int kRT>
__global__ void __launch_bounds__(kThreads)
int8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                int32_t* __restrict__ out, int32_t* __restrict__ partial,
                int R, int K, int N, int steps_per_split) {
  constexpr int kRows = kRT * kTileRows;
  __shared__ __align__(16) int8_t xs[kRows * kI8Stride];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kRows;
  const int nc = blockIdx.y * kBlockCols + warp * kWarpCols + 4 * g;
  const int nsteps = (K + 31) / 32;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(nsteps, s_begin + steps_per_split);

  int acc[kRT][2][4];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][h][c] = 0;

  constexpr int kFill = kI8Stage / 32;
  for (int sb = s_begin; sb < s_end; sb += kFill) {
    const int ns = min(kFill, s_end - sb);
    // stage x[r0 .. r0 + kRows, 32 sb .. + kI8Stage) in 16-byte pieces (K %
    // 16 == 0: a piece is in or out whole)
    for (int e = threadIdx.x; e < kRows * (kI8Stage / 16); e += kThreads) {
      const int r = e / (kI8Stage / 16), q = e % (kI8Stage / 16);
      const int k = 32 * sb + 16 * q;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < R && k < K)
        v = *reinterpret_cast<const uint4*>(x + (int64_t)(r0 + r) * K + k);
      *reinterpret_cast<uint4*>(&xs[r * kI8Stride + 16 * q]) = v;
    }
    __syncthreads();
    for (int s0 = 0; s0 < ns; s0 += kI8Unroll) {
      uint32_t wv[kI8Unroll][8];
#pragma unroll
      for (int u = 0; u < kI8Unroll; ++u) {
        if (s0 + u >= ns) break;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = 32 * (sb + s0 + u) + 8 * t + i;
          wv[u][i] = load_row4<true>(w, k, k < K, nc, N);
        }
      }
#pragma unroll
      for (int u = 0; u < kI8Unroll; ++u) {
        if (s0 + u >= ns) break;
        const int sl = s0 + u;
        uint32_t lo[4], hi[4];           // columns 0..3: rows 0..3, 4..7
        transpose4(&wv[u][0], lo);
        transpose4(&wv[u][4], hi);
        uint32_t a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {    // tile h: columns 2h, 2h + 1
          a[h][0] = lo[2 * h];
          a[h][1] = lo[2 * h + 1];
          a[h][2] = hi[2 * h];
          a[h][3] = hi[2 * h + 1];
        }
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const uint2 b = *reinterpret_cast<const uint2*>(
              &xs[(i * kTileRows + g) * kI8Stride + 32 * sl + 8 * t]);
#pragma unroll
          for (int h = 0; h < 2; ++h) mma_s8(acc[i][h], a[h], b.x, b.y);
        }
      }
    }
    __syncthreads();
  }
  int32_t* dst = gridDim.z > 1 ? partial + (int64_t)blockIdx.z * R * N : out;
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + i * kTileRows + 2 * t + (c & 1);
        const int n = nc + 2 * h + (c >> 1);
        if (r < R && n < N) dst[(int64_t)r * N + n] = acc[i][h][c];
      }
}

template <int kRT>
void launch_i8_rt(const int8_t* x, const int8_t* w, int32_t* out,
                  int32_t* partial, int R, int K, int N, int splits, int per,
                  cudaStream_t stream) {
  constexpr int kRows = kRT * kTileRows;
  const dim3 grid((R + kRows - 1) / kRows,
                  (N + kBlockCols - 1) / kBlockCols, splits);
  int8_mma_kernel<kRT><<<grid, kThreads, 0, stream>>>(x, w, out, partial, R,
                                                      K, N, per);
}

}  // namespace

// x (R, K) int8, w (K, N) int8, out (R, N) int32; K % 16 == 0, N % 4 == 0,
// x and w 16-byte aligned; splits >= 1 slices of K in steps of 32, with
// `partial` an (splits, R, N) int32 scratch buffer when splits > 1
extern "C" int p2t_int8_mma(const void* x, const void* w, void* out,
                            void* partial, int R, int K, int N, int splits,
                            void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || splits <= 0 ||
      splits > 65535 || (splits > 1 && partial == nullptr) ||
      splits > (K + 31) / 32 || (N + kBlockCols - 1) / kBlockCols > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* pt = static_cast<int32_t*>(partial);
  const int per = ((K + 31) / 32 + splits - 1) / splits;
  if (R <= 32)
    launch_i8_rt<4>(xi, wi, o, pt, R, K, N, splits, per, s);
  else
    launch_i8_rt<16>(xi, wi, o, pt, R, K, N, splits, per, s);
  if (splits > 1)
    launch_reduce<int32_t, int32_t>(pt, nullptr, o, R, N, splits, s);
  return (int)cudaGetLastError();
}
