// K5: masked flash-attention backward (dQ, dK, dV) from K1's O and
// log-sum-exp, for per-row contiguous key runs.
//
// Replaces prot2text_tpu/kernels/flash_attention.py flash_attention_masked,
// backward (_flash_masked_bwd_impl with _bwd_masked_dq_kernel and
// _bwd_masked_dkv_kernel).  Semantics kept: the valid keys of batch row b
// are [kv_start[b], kv_start[b] + kv_len[b]), optionally also causal on
// SEQUENCE index (col <= row); P is recomputed as exp(Q·Kᵀ - lse) and masked
// EXPLICITLY (an empty row carries lse = -1e30 and must give zero
// gradients, which exp underflow would not guarantee); with Δ = rowsum(dO∘O)
// (one torch expression in the wrapper, as XLA computes it beside the TPU
// kernels), dS = P∘(dO·Vᵀ - Δ), dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO.
//
// bf16 runs the tensor-core body of flash_attention_bwd.cuh (its header
// states the bound and the design).  f32 (the legacy full fine-tune, the
// plumbing checks) runs the SIMT body below: all products and sums in fp32,
// outputs rounded once.  GQA without repeat_kv: the TPU path repeated k/v
// to H heads and let repeat_kv's transpose sum dK/dV over each group.  Here
// a dK/dV block owns one (batch, kv head, 64-key tile), loops over the
// `rep` query heads of its group and the query tiles that can see the tile,
// and writes its rows once: no atomics, and the group sum has a fixed order
// (deterministic).  A dQ block owns one (batch, query head, 64-row tile)
// and loops over the key tiles of its rows' run.  Tiles wholly outside the
// run or above the causal diagonal are skipped: they only ever contribute
// zeros.  Any Sq/Skv: ragged edge tiles are zero-filled and masked here.
// The SIMT tiles are fp32 [row][D+1] in shared memory (the +1 padding keeps
// both the row-wise and the column-wise reads free of bank conflicts), 256
// threads, each owning a 4x4 micro-tile of the 64x64 score block and a 4 x
// D/16 slice of the output tile; the causal grid puts the heaviest tiles
// first.
#include "common.cuh"
#include "flash_attention_bwd.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
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
  int H, Hkv, Sq, Skv;
  const int32_t* kv_start;
  const int32_t* kv_len;
  int causal;
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

__device__ __forceinline__ bool visible(const BwdParams& p, int row, int col,
                                        int start, int len) {
  return row < p.Sq && col >= start && col < start + len && col < p.Skv &&
         (!p.causal || col <= row);
}

// s = A·Bᵀ and dp = C·Dᵀ over the head dim for this thread's 4x4 micro-tile
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
flash_masked_bwd_dq_kernel(const BwdParams p) {
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
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;

  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* dout = p.dout + b * p.do_sb + h * p.do_sh;
  const float* k = p.k + b * p.k_sb + hk * p.k_sh;
  const float* v = p.v + b * p.v_sb + hk * p.v_sh;
  float* dq = p.dq + b * p.dq_sb + h * p.dq_sh;
  const float* lse = p.lse + (int64_t)bh * p.Sq;
  const float* delta = p.delta + (int64_t)bh * p.Sq;

  const int start = p.kv_start[b];
  const int len = p.kv_len[b];
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const int kv_lo = max(start, 0);
  int kv_hi = min(start + len, p.Skv);
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);

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

  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
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
        const float pr = visible(p, q0 + r, k0 + c, start, len)
                             ? expf(s[i][j] - lse_s[r]) : 0.f;
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
flash_masked_bwd_dkv_kernel(const BwdParams p) {
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

  const int start = p.kv_start[b];
  const int len = p.kv_len[b];
  const int kv_lo = max(start, 0);
  const int kv_hi = min(start + len, p.Skv);
  // the tile holds a valid key: block-uniform, so the barriers below are
  // reached by every thread or by none
  const bool active = k0 < kv_hi && k0 + kBK > kv_lo;
  // causal: rows below the tile's first valid key see none of it
  const int q_begin = p.causal ? (max(k0, kv_lo) / kBQ) * kBQ : 0;

  const int rg = tid / 16, cg = tid % 16;
  constexpr int kDJ = D / 16;
  float acc_k[4][kDJ], acc_v[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  if (active) {
    load_tile<D>(Ks, k, p.k_ss, k0, p.Skv);
    load_tile<D>(Vs, v, p.v_ss, k0, p.Skv);
    for (int g = 0; g < rep; ++g) {
      const int h = hk * rep + g;
      const int bh = b * p.H + h;
      const float* q = p.q + b * p.q_sb + h * p.q_sh;
      const float* dout = p.dout + b * p.do_sb + h * p.do_sh;
      const float* lse = p.lse + (int64_t)bh * p.Sq;
      const float* delta = p.delta + (int64_t)bh * p.Sq;
      for (int q0 = q_begin; q0 < p.Sq; q0 += kBQ) {
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
            const float pr = visible(p, q0 + r, k0 + c, start, len)
                                 ? expf(s[i][j] - lse_s[r]) : 0.f;
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
cudaError_t launch(const BwdParams& p, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_masked_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::kDq);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(
      flash_masked_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::kDkv);
  if (e != cudaSuccess) return e;
  const dim3 grid_dq(B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_masked_bwd_dq_kernel<D>
      <<<grid_dq, kThreads, Smem<D>::kDq, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_dkv(B * p.Hkv, (p.Skv + kBK - 1) / kBK);
  flash_masked_bwd_dkv_kernel<D>
      <<<grid_dkv, kThreads, Smem<D>::kDkv, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_d(int D, const BwdParams& p, int B, cudaStream_t s) {
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
// dq, dk, dv, each (b, h, s), in elements
template <class P>
P make_params(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* kv_start,
              const void* kv_len, void* dq, void* dk, void* dv,
              const int64_t* st, int H, int Hkv, int Sq, int Skv,
              int causal) {
  P p = {};
  p.q = static_cast<decltype(p.q)>(q);
  p.k = static_cast<decltype(p.k)>(k);
  p.v = static_cast<decltype(p.v)>(v);
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
  p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv;
  p.kv_start = static_cast<const int32_t*>(kv_start);
  p.kv_len = static_cast<const int32_t*>(kv_len);
  p.causal = causal;
  return p;
}

}  // namespace

// bf16: the tensor-core body; f32: the SIMT body
extern "C" int p2t_flash_masked_bwd(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* kv_start, const void* kv_len,
                                    void* dq, void* dk, void* dv,
                                    const int64_t* strides, int B, int H,
                                    int Hkv, int Sq, int Skv, int D,
                                    int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == p2t::kBFloat16)
    return (int)bwd::run<bwd::RunMask>(
        D, make_params<bwd::Params>(q, k, v, dout, lse, delta, kv_start,
                                    kv_len, dq, dk, dv, strides, H, Hkv, Sq,
                                    Skv, causal),
        B, s);
  if (dtype == p2t::kFloat32)
    return (int)dispatch_d(
        D, make_params<BwdParams>(q, k, v, dout, lse, delta, kv_start,
                                  kv_len, dq, dk, dv, strides, H, Hkv, Sq,
                                  Skv, causal),
        B, s);
  return (int)cudaErrorInvalidValue;
}
