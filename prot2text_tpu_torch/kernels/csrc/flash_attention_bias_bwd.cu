// K6b: flash-attention backward (dQ, dK, dV) with an arbitrary fp32
// additive bias, from K6's O and log-sum-exp.
//
// Replaces prot2text_tpu/kernels/flash_attention.py flash_attention_tpu,
// backward (_flash_bwd with _bwd_dq_kernel and _bwd_dkv_kernel).  Semantics
// kept: P = exp(q·kᵀ + bias - lse) in fp32 (q arrives pre-scaled), NOT
// rounded to the value dtype (the TPU dK/dV kernel multiplies the fp32 P
// into dV; only the forward rounds P before P·V); with Δ = rowsum(dO∘O)
// (one torch expression in the wrapper, as XLA computes it beside the TPU
// kernels), dS = P∘(dO·Vᵀ - Δ), dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO; all
// products and sums in fp32, outputs rounded to the input dtype once.  The
// bias gets no gradient (the TPU custom VJP returns None for it).  The bias
// is read through broadcast strides, shape (B|1, 1|H, Sq|1, Skv): no
// (B, H, Sq, Skv) copy is made.  The TPU kernel padded Sq and Skv to its
// grid with a -1e30 bias; here the ragged edge tiles are zero-filled and
// their P set to 0 explicitly.
//
// Layout as K5 (csrc/flash_attention_bwd.cu): a dQ block owns one (batch,
// query head, 64-row tile) and walks every key tile; a dK/dV block owns one
// (batch, kv head, 64-key tile), loops over the `rep` query heads of its
// group and every query tile, and writes its rows once: no atomics, and the
// group sum has a fixed order.  No tile is skipped: the bias is arbitrary.
//
// Bound: at ESMC-600M's SFT shape (B=1, H=18, S=512, D=64) the five
// products (q·kᵀ and dO·vᵀ recomputed by both kernels, dS·K, dSᵀ·Q, Pᵀ·dO)
// are 10·B·H·S²·D = 3.0 GFLOP over ~9 MB of q/k/v/dO/bias: compute-bound
// on paper, latency-bound in practice (18 x 8 blocks per kernel on 132
// SMs).  This first version is deliberately simple, like K5: fp32 CUDA-core
// FMAs on tiles staged in shared memory as fp32 [row][D+1] (the +1 padding
// keeps both the row-wise and the column-wise reads of a tile free of bank
// conflicts), 256 threads, each owning a 4x4 micro-tile of the 64x64
// score block and a 4 x D/16 slice of the output tile.  wgmma + TMA, and
// splitting the dK/dV loop over more blocks, are the follow-up.
#include "common.cuh"

namespace {

using p2t::from_float;
using p2t::to_float;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

struct BiasBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const void* dout;
  const float* lse;     // (B, H, Sq) contiguous
  const float* delta;   // (B, H, Sq) contiguous, rowsum(dO∘O)
  void* dq;
  void* dk;
  void* dv;
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
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t ss, int row0, int n_rows) {
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = row0 + r;
    dst[r * (D + 1) + d] = s < n_rows ? to_float(src[s * ss + d]) : 0.f;
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
template <typename T, int D>
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

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* bias = p.bias + b * p.b_sb + h * p.b_sh;
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const float* lse = p.lse + (int64_t)bh * p.Sq;
  const float* delta = p.delta + (int64_t)bh * p.Sq;

  load_tile<T, D>(Qs, q, p.q_ss, q0, p.Sq);
  load_tile<T, D>(dOs, dout, p.do_ss, q0, p.Sq);
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
    load_tile<T, D>(Ks, k, p.k_ss, k0, p.Skv);
    load_tile<T, D>(Vs, v, p.v_ss, k0, p.Skv);
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
        dq[row * p.dq_ss + cg + 16 * j] = from_float<T>(acc[i][j]);
    }
  }
}

// dK, dV: one block per (batch*kv_head, 64-key tile), summing over the
// rep query heads of the group
template <typename T, int D>
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

  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;

  const int rg = tid / 16, cg = tid % 16;
  constexpr int kDJ = D / 16;
  float acc_k[4][kDJ], acc_v[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  load_tile<T, D>(Ks, k, p.k_ss, k0, p.Skv);
  load_tile<T, D>(Vs, v, p.v_ss, k0, p.Skv);
  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const int bh = b * p.H + h;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const float* bias = p.bias + b * p.b_sb + h * p.b_sh;
    const float* lse = p.lse + (int64_t)bh * p.Sq;
    const float* delta = p.delta + (int64_t)bh * p.Sq;
    for (int q0 = 0; q0 < p.Sq; q0 += kBQ) {
      __syncthreads();   // the previous tile's readers are done
      load_tile<T, D>(Qs, q, p.q_ss, q0, p.Sq);
      load_tile<T, D>(dOs, dout, p.do_ss, q0, p.Sq);
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
        dk[row * p.dk_ss + cg + 16 * j] = from_float<T>(acc_k[i][j]);
        dv[row * p.dv_ss + cg + 16 * j] = from_float<T>(acc_v[i][j]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const BiasBwdParams& p, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_bias_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::kDq);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(
      flash_bias_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::kDkv);
  if (e != cudaSuccess) return e;
  const dim3 grid_dq(B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_bias_bwd_dq_kernel<T, D>
      <<<grid_dq, kThreads, Smem<D>::kDq, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_dkv(B * p.Hkv, (p.Skv + kBK - 1) / kBK);
  flash_bias_bwd_dkv_kernel<T, D>
      <<<grid_dkv, kThreads, Smem<D>::kDkv, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const BiasBwdParams& p, int B, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, s);
    case 32: return launch<T, 32>(p, B, s);
    case 64: return launch<T, 64>(p, B, s);
    case 128: return launch<T, 128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: q, k, v, dout, dq, dk, dv (b, h, s) and bias (b, h, q), in
// elements
extern "C" int p2t_flash_bias_bwd(const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dk,
                                  void* dv, const int64_t* strides, int B,
                                  int H, int Hkv, int Sq, int Skv, int D,
                                  int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  BiasBwdParams p;
  p.q = q; p.k = k; p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.do_sb = strides[9]; p.do_sh = strides[10]; p.do_ss = strides[11];
  p.dq_sb = strides[12]; p.dq_sh = strides[13]; p.dq_ss = strides[14];
  p.dk_sb = strides[15]; p.dk_sh = strides[16]; p.dk_ss = strides[17];
  p.dv_sb = strides[18]; p.dv_sh = strides[19]; p.dv_ss = strides[20];
  p.b_sb = strides[21]; p.b_sh = strides[22]; p.b_sq = strides[23];
  p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == p2t::kBFloat16)
    return (int)dispatch_d<__nv_bfloat16>(D, p, B, s);
  if (dtype == p2t::kFloat32) return (int)dispatch_d<float>(D, p, B, s);
  return (int)cudaErrorInvalidValue;
}
