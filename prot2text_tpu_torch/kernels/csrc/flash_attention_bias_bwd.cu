// K6b: flash-attention backward (dQ, dK, dV) with an arbitrary fp32
// additive bias, from K6's O and log-sum-exp.
//
// Replaces prot2text_tpu/kernels/flash_attention.py flash_attention_tpu,
// backward (_flash_bwd with _bwd_dq_kernel and _bwd_dkv_kernel).  Semantics
// kept: P = exp(q·kᵀ + bias - lse) (q arrives pre-scaled); with Δ =
// rowsum(dO∘O) (computed beside the kernels, as XLA computes it beside the
// TPU kernels), dS = P∘(dO·Vᵀ - Δ), dQ = dS·K, dK = dSᵀ·Q, dV =
// Pᵀ·dO, summed over each GQA group for dK/dV; outputs rounded to the input
// dtype once.  The bias gets no gradient (the TPU custom VJP returns None
// for it).  The bias is read through broadcast strides, shape (B|1, 1|H,
// Sq|1, Skv): no (B, H, Sq, Skv) copy is made.  The TPU kernel padded Sq
// and Skv to its grid with a -1e30 bias; here the ragged edge tiles are
// zero-filled and their P set to 0 explicitly.
//
// Bound: at ESMC-600M's SFT shape (B 1, H 18, S 512, D 64, 443 valid keys)
// the products of the unmasked pairs (q·kᵀ and dO·vᵀ recomputed by both
// kernels, dS·K, dSᵀ·Q, Pᵀ·dO) are 2.6 GFLOP, 2.6 us at 989 TFLOP/s bf16;
// q/k/v/o/dO and the three gradients are 9.4 MB, 2.8 us at 3.35 TB/s, so
// bytes bound it, by a hair.
//
// Two bodies, by dtype:
//   - bf16 runs the tensor-core body of flash_attention_bwd.cuh with its
//     bias mask (`bwd::BiasMask`): mma.sync bf16 products with fp32 sums, S,
//     dP, P and dS in registers (P and dS rounded to bf16 where they enter
//     dV, dK and dQ: ROADMAP §3 records the difference by design), the
//     walked tiles and the fp32 bias tiles staged by cp.async (one row of
//     bias for a bias of one row, `BiasMask<true>`), a tile whose bias is at
//     most -2e30 everywhere skipped whole by a block vote (copies and
//     products), dK/dV summed over a thread-block cluster's blocks through
//     distributed shared memory, no atomics.  Δ comes from a kernel of its
//     own (`bwd_delta_kernel`: one fp32 dot a row, in place of the four
//     elementwise and reduction launches of a torch expression), and dQ
//     and dK/dV go to two streams that the wrapper forks and joins, so they
//     run side by side: each has one block an SM or fewer at ESMC's rep 1
//     (144 blocks at S 512).  It needs q/k/v/o/dO and the
//     gradients 16-byte aligned (base pointers and strides) and returns
//     cudaErrorMisalignedAddress otherwise; it never falls back.
//   - f32 runs the SIMT body below, K5's first layout: all products and
//     sums in fp32 CUDA-core FMAs on tiles staged in shared memory as fp32
//     [row][D+1] (the +1 padding keeps both the row-wise and the
//     column-wise reads of a tile free of bank conflicts), 256 threads,
//     each owning a 4x4 micro-tile of the 64x64 score block and a 4 x D/16
//     slice of the output tile; a dQ block owns one (batch, query head,
//     64-row tile) and walks every key tile, a dK/dV block one (batch, kv
//     head, 64-key tile) and loops over the group's query heads and every
//     query tile, writing its rows once (a fixed order, no atomics); no
//     tile is skipped.  The f32 callers (the f32 plumbing checks at 1e-4)
//     get full fp32 arithmetic, which TF32 tensor cores would not give.
#include "common.cuh"
#include "flash_attention_bwd.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

struct BiasBwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const float* dout;
  const float* lse;     // (B, H, Sq) contiguous
  const float* delta;   // (B, H, Sq) contiguous, rowsum(dO∘O)
  float* dq;
  float* dk;
  float* dv;
  // element strides (batch, head, sequence); the head dim is contiguous
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  // bias strides (batch, head, query row), 0 where broadcast; columns are
  // contiguous
  int64_t b_sb, b_sh, b_sq;
  int H, Hkv, Sq, Skv;
};

template <int D>
struct Smem {
  static constexpr int kTile = kBQ * (D + 1);   // one fp32 [64][D+1] tile
  static constexpr int kScore = kBQ * (kBK + 1);  // one [64][65] score tile
  static constexpr size_t kDq =
      sizeof(float) * (4 * kTile + kScore + 2 * kBQ);
  static constexpr size_t kDkv =
      sizeof(float) * (4 * kTile + 2 * kScore + 2 * kBQ);
};

// rows [row0, row0 + 64) of a (seq, D) slice with row stride `ss` → fp32
// [64][D+1] in shared memory; rows at or past n_rows are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t ss, int row0, int n_rows) {
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = row0 + r;
    dst[r * (D + 1) + d] = s < n_rows ? src[s * ss + d] : 0.f;
  }
}

// P of (row, col) from the recomputed logit s: exp(s + bias - lse) inside
// the Sq x Skv block, 0 on the ragged edge tiles.  `bias` points at this
// (batch, head)'s plane.
__device__ __forceinline__ float prob(const BiasBwdParams& p,
                                      const float* bias, int row, int col,
                                      float s, float lse) {
  return (row < p.Sq && col < p.Skv)
             ? expf(s + bias[row * p.b_sq + col] - lse) : 0.f;
}

// s = A·Bᵀ and dp = C·Eᵀ over the head dim for this thread's 4x4 micro-tile
// (rows rg + 16i of A/C, rows cg + 16j of B/E), all [64][D+1] fp32 tiles.
template <int D>
__device__ __forceinline__ void two_score_tiles(
    const float* A, const float* Bt, const float* C, const float* E,
    float (&s)[4][4], float (&dp)[4][4], int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4], c[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(rg + 16 * i) * (D + 1) + d];
      c[i] = C[(rg + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = Bt[(cg + 16 * j) * (D + 1) + d];
      e[j] = E[(cg + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
}

// dQ: one block per (batch*head, 64-row query tile)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bias_bwd_dq_kernel(const BiasBwdParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + Smem<D>::kTile;
  float* Ks = dOs + Smem<D>::kTile;
  float* Vs = Ks + Smem<D>::kTile;
  float* dSs = Vs + Smem<D>::kTile;
  float* lse_s = dSs + Smem<D>::kScore;
  float* delta_s = lse_s + kBQ;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;

  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* dout = p.dout + b * p.do_sb + h * p.do_sh;
  const float* k = p.k + b * p.k_sb + hk * p.k_sh;
  const float* v = p.v + b * p.v_sb + hk * p.v_sh;
  const float* bias = p.bias + b * p.b_sb + h * p.b_sh;
  float* dq = p.dq + b * p.dq_sb + h * p.dq_sh;
  const float* lse = p.lse + (int64_t)bh * p.Sq;
  const float* delta = p.delta + (int64_t)bh * p.Sq;

  load_tile<D>(Qs, q, p.q_ss, q0, p.Sq);
  load_tile<D>(dOs, dout, p.do_ss, q0, p.Sq);
  if (tid < kBQ) {
    const bool in = q0 + tid < p.Sq;
    lse_s[tid] = in ? lse[q0 + tid] : 0.f;
    delta_s[tid] = in ? delta[q0 + tid] : 0.f;
  }

  const int rg = tid / 16, cg = tid % 16;
  constexpr int kDJ = D / 16;
  float acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.Skv; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    load_tile<D>(Ks, k, p.k_ss, k0, p.Skv);
    load_tile<D>(Vs, v, p.v_ss, k0, p.Skv);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_score_tiles<D>(Qs, Ks, dOs, Vs, s, dp, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        const float pr = prob(p, bias, q0 + r, k0 + c, s[i][j], lse_s[r]);
        dSs[r * (kBK + 1) + c] = pr * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS·K
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float a[4], kb[kDJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dSs[(rg + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) kb[j] = Ks[c * (D + 1) + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDJ; ++j) acc[i][j] = fmaf(a[i], kb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row < p.Sq) {
#pragma unroll
      for (int j = 0; j < kDJ; ++j)
        dq[row * p.dq_ss + cg + 16 * j] = acc[i][j];
    }
  }
}

// dK, dV: one block per (batch*kv_head, 64-key tile), summing over the
// rep query heads of the group
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bias_bwd_dkv_kernel(const BiasBwdParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + Smem<D>::kTile;
  float* Qs = Vs + Smem<D>::kTile;
  float* dOs = Qs + Smem<D>::kTile;
  float* Ps = dOs + Smem<D>::kTile;
  float* dSs = Ps + Smem<D>::kScore;
  float* lse_s = dSs + Smem<D>::kScore;
  float* delta_s = lse_s + kBQ;

  const int bk = blockIdx.x;
  const int b = bk / p.Hkv;
  const int hk = bk - b * p.Hkv;
  const int rep = p.H / p.Hkv;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x;

  const float* k = p.k + b * p.k_sb + hk * p.k_sh;
  const float* v = p.v + b * p.v_sb + hk * p.v_sh;
  float* dk = p.dk + b * p.dk_sb + hk * p.dk_sh;
  float* dv = p.dv + b * p.dv_sb + hk * p.dv_sh;

  const int rg = tid / 16, cg = tid % 16;
  constexpr int kDJ = D / 16;
  float acc_k[4][kDJ], acc_v[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  load_tile<D>(Ks, k, p.k_ss, k0, p.Skv);
  load_tile<D>(Vs, v, p.v_ss, k0, p.Skv);
  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const int bh = b * p.H + h;
    const float* q = p.q + b * p.q_sb + h * p.q_sh;
    const float* dout = p.dout + b * p.do_sb + h * p.do_sh;
    const float* bias = p.bias + b * p.b_sb + h * p.b_sh;
    const float* lse = p.lse + (int64_t)bh * p.Sq;
    const float* delta = p.delta + (int64_t)bh * p.Sq;
    for (int q0 = 0; q0 < p.Sq; q0 += kBQ) {
      __syncthreads();   // the previous tile's readers are done
      load_tile<D>(Qs, q, p.q_ss, q0, p.Sq);
      load_tile<D>(dOs, dout, p.do_ss, q0, p.Sq);
      if (tid < kBQ) {
        const bool in = q0 + tid < p.Sq;
        lse_s[tid] = in ? lse[q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[q0 + tid] : 0.f;
      }
      __syncthreads();

      // rows r = query rows (rg + 16i), cols c = key rows (cg + 16j)
      float s[4][4], dp[4][4];
      two_score_tiles<D>(Qs, Ks, dOs, Vs, s, dp, rg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + 16 * j;
          const float pr = prob(p, bias, q0 + r, k0 + c, s[i][j], lse_s[r]);
          Ps[r * (kBK + 1) + c] = pr;
          dSs[r * (kBK + 1) + c] = pr * (dp[i][j] - delta_s[r]);
        }
      }
      __syncthreads();

      // dV += Pᵀ·dO, dK += dSᵀ·Q; this thread: key rows rg + 16i,
      // head-dim cols cg + 16j
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pa[4], sa[4], ob[kDJ], qb[kDJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Ps[r * (kBK + 1) + rg + 16 * i];
          sa[i] = dSs[r * (kBK + 1) + rg + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kDJ; ++j) {
          ob[j] = dOs[r * (D + 1) + cg + 16 * j];
          qb[j] = Qs[r * (D + 1) + cg + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDJ; ++j) {
            acc_v[i][j] = fmaf(pa[i], ob[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sa[i], qb[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + rg + 16 * i;
    if (row < p.Skv) {
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        dk[row * p.dk_ss + cg + 16 * j] = acc_k[i][j];
        dv[row * p.dv_ss + cg + 16 * j] = acc_v[i][j];
      }
    }
  }
}

template <int D>
cudaError_t launch(const BiasBwdParams& p, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_bias_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::kDq);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(
      flash_bias_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::kDkv);
  if (e != cudaSuccess) return e;
  const dim3 grid_dq(B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_bias_bwd_dq_kernel<D>
      <<<grid_dq, kThreads, Smem<D>::kDq, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_dkv(B * p.Hkv, (p.Skv + kBK - 1) / kBK);
  flash_bias_bwd_dkv_kernel<D>
      <<<grid_dkv, kThreads, Smem<D>::kDkv, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_d(int D, const BiasBwdParams& p, int B, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    case 128: return launch<128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// the entry point's arguments → either body's parameters (the same field
// names; pointers cast to the body's element type); strides: q, k, v, dout,
// dq, dk, dv, each (b, h, s), then the bias (b, h, q), in elements
template <class P>
P make_params(const void* q, const void* k, const void* v, const void* bias,
              const void* dout, const void* lse, const void* delta, void* dq,
              void* dk, void* dv, const int64_t* st, int H, int Hkv, int Sq,
              int Skv) {
  P p = {};
  p.q = static_cast<decltype(p.q)>(q);
  p.k = static_cast<decltype(p.k)>(k);
  p.v = static_cast<decltype(p.v)>(v);
  p.bias = static_cast<const float*>(bias);
  p.dout = static_cast<decltype(p.dout)>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<decltype(p.dq)>(dq);
  p.dk = static_cast<decltype(p.dk)>(dk);
  p.dv = static_cast<decltype(p.dv)>(dv);
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_ss = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_ss = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_ss = st[8];
  p.do_sb = st[9]; p.do_sh = st[10]; p.do_ss = st[11];
  p.dq_sb = st[12]; p.dq_sh = st[13]; p.dq_ss = st[14];
  p.dk_sb = st[15]; p.dk_sh = st[16]; p.dk_ss = st[17];
  p.dv_sb = st[18]; p.dv_sh = st[19]; p.dv_ss = st[20];
  p.b_sb = st[21]; p.b_sh = st[22]; p.b_sq = st[23];
  p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv;
  return p;
}

// Δ[row] = sum_d dO[row, d]·O[row, d] in fp32 over bf16 rows of (B, H, S,
// D) views, kC = D / 8 threads a row, 16 bytes each, summed by shuffles
// (kC divides 32, so a row's threads share a warp)
template <int kC>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const __nv_bfloat16* __restrict__ dout,
                 const __nv_bfloat16* __restrict__ o,
                 float* __restrict__ delta, int64_t do_sb, int64_t do_sh,
                 int64_t do_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
                 int H, int S, int rows) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int row = i / kC, c = i % kC;
  float acc = 0.f;
  if (row < rows) {
    const int b = row / (H * S), hs = row - b * H * S;
    const int h = hs / S, s = hs - h * S;
    float a[8], x[8];
    p2t::load8(dout + b * do_sb + h * do_sh + s * do_ss + 8 * c, a);
    p2t::load8(o + b * o_sb + h * o_sh + s * o_ss + 8 * c, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(a[e], x[e], acc);
  }
#pragma unroll
  for (int off = kC / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) delta[row] = acc;
}

template <int kC>
int launch_delta(const void* dout, const void* o, void* delta,
                 const int64_t* st, int H, int S, int rows,
                 cudaStream_t stream) {
  const int64_t threads = (int64_t)rows * kC;
  bwd_delta_kernel<kC><<<(unsigned)((threads + 255) / 256), 256, 0,
                         stream>>>(
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(o), static_cast<float*>(delta),
      st[0], st[1], st[2], st[3], st[4], st[5], H, S, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 Δ = rowsum(dO∘O) → delta (B, H, S) contiguous; strides: dout, o (b,
// h, s) in elements, every base and stride 16-byte aligned
extern "C" int p2t_flash_bwd_delta(const void* dout, const void* o,
                                   void* delta, const int64_t* st, int B,
                                   int H, int S, int D, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 ||
      !p2t::aligned16(dout, st[0], st[1], st[2]) ||
      !p2t::aligned16(o, st[3], st[4], st[5]))
    return (int)cudaErrorInvalidValue;
  const int rows = B * H * S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_delta<2>(dout, o, delta, st, H, S, rows, s);
    case 32: return launch_delta<4>(dout, o, delta, st, H, S, rows, s);
    case 64: return launch_delta<8>(dout, o, delta, st, H, S, rows, s);
    case 128: return launch_delta<16>(dout, o, delta, st, H, S, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16: the tensor-core body, dQ on `stream` and dK/dV on `stream_kv`,
// which the caller orders after `stream`'s work before the call and joins
// back after it; f32: the SIMT body on `stream` (stream_kv unused).
// strides: q, k, v, dout, dq, dk, dv (b, h, s) and bias (b, h, q), in
// elements
extern "C" int p2t_flash_bias_bwd(const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dk,
                                  void* dv, const int64_t* strides, int B,
                                  int H, int Hkv, int Sq, int Skv, int D,
                                  int dtype, void* stream, void* stream_kv) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == p2t::kBFloat16) {
    const bwd::Params p = make_params<bwd::Params>(
        q, k, v, bias, dout, lse, delta, dq, dk, dv, strides, H, Hkv, Sq,
        Skv);
    cudaStream_t skv = static_cast<cudaStream_t>(stream_kv);
    return (int)(p.b_sq == 0
                     ? bwd::run<bwd::BiasMask<true>>(D, p, B, s, skv)
                     : bwd::run<bwd::BiasMask<false>>(D, p, B, s, skv));
  }
  if (dtype == p2t::kFloat32)
    return (int)dispatch_d(
        D, make_params<BiasBwdParams>(q, k, v, bias, dout, lse, delta, dq,
                                      dk, dv, strides, H, Hkv, Sq, Skv),
        B, s);
  return (int)cudaErrorInvalidValue;
}
