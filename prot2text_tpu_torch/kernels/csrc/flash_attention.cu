// K1: masked flash-attention forward with in-kernel masks from per-row
// contiguous key runs, returning O and the log-sum-exp.
//
// Replaces prot2text_tpu/kernels/flash_attention.py flash_attention_masked,
// forward (_fwd_masked_kernel / _flash_masked_fwd_impl).  Semantics kept:
// the valid keys of batch row b are [kv_start[b], kv_start[b] + kv_len[b]),
// optionally also causal on SEQUENCE index (col <= row); masked logits take
// weight exactly 0 (not by underflow), so a row with no valid key gives o =
// 0 and lse = -1e30 + log(1); q arrives pre-scaled; logits and the running
// max/sum are fp32; the weights are rounded to the value dtype before P·V.
// GQA: query head h reads kv head h / (H / Hkv), so repeat_kv never
// materialises.  Any Sq/Skv: the ragged edge tiles are zero-filled and
// masked here (the TPU path padded to 128).
//
// Bound: at the Llama-3.1-8B prefill (B=4, H=32, Hkv=8, S=1024, D=128,
// ragged causal runs) the two limits lie close: 25 us for the bytes (84 MB
// of q/k/v/o at 3.35 TB/s), 21 us for the products (21 GFLOP of unmasked
// pairs at 989 TFLOP/s bf16).  Off the tensor cores the products alone
// take 310 us (67 TFLOP/s fp32), so the bf16 body uses them.
//
// Two bodies, by dtype:
//   - bf16 runs the tensor-core body of flash_attention_fwd.cuh with its
//     run mask (`fwd::RunMask`): mma.sync bf16 products, S and P in
//     registers, K/V staged in bf16 by cp.async, the tiles outside the
//     row's run and above the causal diagonal skipped.  It needs every
//     operand 16-byte aligned (base pointers and strides) and returns
//     cudaErrorMisalignedAddress otherwise; it never falls back.
//   - f32 runs the SIMT body below, unchanged since it was first written:
//     fp32 CUDA-core FMAs on tiles staged in shared memory as fp32, so the
//     f32 callers (the legacy arc's f32 training, the f32 plumbing checks
//     at 1e-4) get full fp32 arithmetic, which TF32 tensor cores would not
//     give.  One block per (batch*head, 64-row q tile), 64-column K/V
//     tiles walked with an online softmax, tiles outside the row's run or
//     above the causal diagonal skipped; each thread owns a 4x4 score
//     micro-tile and a 4 x D/16 output micro-tile; K and Q are stored
//     transposed (+1 padding) so the inner loops read shared memory without
//     bank conflicts.
#include "common.cuh"
#include "flash_attention_fwd.cuh"

namespace {

using p2t::from_float;
using p2t::round_to;
using p2t::to_float;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kv_start;
  const int32_t* kv_len;
  void* o;
  float* lse;          // (B, H, Sq)
  // element strides (batch, head, sequence); the head dim is contiguous
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int H, Hkv, Sq, Skv;
  int causal;
};

template <int D>
struct Smem {
  static constexpr int kQt = D * (kBQ + 1);   // Q tile, transposed [D][BQ+1]
  static constexpr int kKt = D * (kBK + 1);   // K tile, transposed [D][BK+1]
  static constexpr int kV = kBK * D;          // V tile [BK][D]
  static constexpr int kP = kBQ * (kBK + 1);  // scores / weights [BQ][BK+1]
  static constexpr size_t kBytes =
      sizeof(float) * (kQt + kKt + kV + kP + 3 * kBQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_masked_fwd_kernel(const FlashParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ float smem[];
  float* Qt = smem;
  float* Kt = Qt + Smem<D>::kQt;
  float* Vs = Kt + Smem<D>::kKt;
  float* Ps = Vs + Smem<D>::kV;
  float* m_s = Ps + Smem<D>::kP;
  float* l_s = m_s + kBQ;
  float* alpha_s = l_s + kBQ;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int start = p.kv_start[b];
  const int len = p.kv_len[b];
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const int kv_lo = max(start, 0);
  int kv_hi = min(start + len, p.Skv);
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    Qt[d * (kBQ + 1) + r] = s < p.Sq ? to_float(q[s * p.q_ss + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // micro-tile owner: rows rg + 16*i, score cols cg + 16*j, out cols cg+16*j
  const int rg = tid / 16, cg = tid % 16;
  constexpr int kDJ = D / 16;
  float acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;

  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int s = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (s < p.Skv) {
        kx = to_float(k[s * p.k_ss + d]);
        vx = to_float(v[s * p.v_ss + d]);
      }
      Kt[d * (kBK + 1) + c] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    // S = Q·Kᵀ (fp32)
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qt[d * (kBQ + 1) + rg + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Kt[d * (kBK + 1) + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(rg + 16 * i) * (kBK + 1) + cg + 16 * j] = sc[i][j];
    __syncthreads();

    // online softmax, 4 threads per row (adjacent lanes of one warp)
    {
      const int r = tid / 4, sub = tid % 4;
      const int row = q0 + r;
      float* prow = Ps + r * (kBK + 1);
      const float m_prev = m_s[r];
      float mx = kNegInf;
#pragma unroll
      for (int kk = 0; kk < kBK / 4; ++kk) {
        const int c = sub + 4 * kk, col = k0 + c;
        const bool ok = col >= start && col < start + len && col < p.Skv &&
                        (!p.causal || col <= row);
        mx = fmaxf(mx, ok ? prow[c] : kNegInf);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK / 4; ++kk) {
        const int c = sub + 4 * kk, col = k0 + c;
        const bool ok = col >= start && col < start + len && col < p.Skv &&
                        (!p.causal || col <= row);
        const float w = ok ? expf(prow[c] - m_new) : 0.f;
        sum += w;
        prow[c] = round_to<T>(w);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (sub == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P·V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[rg + 16 * i];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float pa[4], vb[kDJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(rg + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) vb[j] = Vs[c * D + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    const int row = q0 + r;
    if (row < p.Sq) {
      const float l = l_s[r];
      const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
      for (int j = 0; j < kDJ; ++j)
        o[row * p.o_ss + cg + 16 * j] = from_float<T>(acc[i][j] * inv);
    }
  }
  if (tid < kBQ && q0 + tid < p.Sq) {
    const float l = l_s[tid];
    p.lse[(int64_t)bh * p.Sq + q0 + tid] = m_s[tid] + logf(l == 0.f ? 1.f : l);
  }
}

template <typename T, int D>
cudaError_t launch(const FlashParams& p, int B, cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_masked_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_masked_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const FlashParams& p, int B, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, s);
    case 32: return launch<T, 32>(p, B, s);
    case 64: return launch<T, 64>(p, B, s);
    case 128: return launch<T, 128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s) in elements
extern "C" int p2t_flash_masked_fwd(const void* q, const void* k,
                                    const void* v, const void* kv_start,
                                    const void* kv_len, void* o, void* lse,
                                    const int64_t* strides, int B, int H,
                                    int Hkv, int Sq, int Skv, int D,
                                    int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  FlashParams p;
  p.q = q; p.k = k; p.v = v;
  p.kv_start = static_cast<const int32_t*>(kv_start);
  p.kv_len = static_cast<const int32_t*>(kv_len);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == p2t::kBFloat16) {
    fwd::Params f =
        fwd::make_params(q, k, v, o, lse, strides, H, Hkv, Sq, Skv);
    f.kv_start = p.kv_start;
    f.kv_len = p.kv_len;
    f.causal = causal;
    return (int)fwd::run<fwd::RunMask>(D, f, B, s);
  }
  if (dtype == p2t::kFloat32) return (int)dispatch_d<float>(D, p, B, s);
  return (int)cudaErrorInvalidValue;
}
