// K6 forward: flash attention with an arbitrary fp32 additive bias,
// returning O and the log-sum-exp.
//
// Replaces prot2text_tpu/kernels/flash_attention.py flash_attention_tpu,
// forward (_fwd_kernel / _flash_fwd).  Semantics kept: logits = q·kᵀ +
// bias in fp32 (q arrives pre-scaled); the bias is read through broadcast
// strides, shape (B, 1|H, Sq|1, Skv), so no (B, H, Sq, Skv) copy is ever
// made; the running max starts at -1e30 as in the TPU kernel, so a row
// whose logits all lie below that (a bias of finfo(f32).min everywhere)
// gets zero weights and o = 0, lse = -1e30, exactly as the TPU kernel gives;
// no other row is special-cased; the weights are rounded to the value
// dtype before P·V.  Sq != Skv is allowed (the serving prefix install
// attends [seeded prefix ‖ suffix] columns).  GQA: query head h reads kv
// head h / (H / Hkv), so repeat_kv never materialises.  The TPU kernel
// padded Sq and Skv to its 128 grid with -1e30 bias; here the ragged edge
// tiles are zero-filled and their columns excluded from the softmax.
//
// Bound: at the serving prefix install (R=8, H=40, Hkv=8, Sq=512,
// Skv=256+512, D=128) the unmasked pairs are 36.9 GFLOP (37 us at 989
// TFLOP/s bf16) over 122 MB of q/k/v/bias/o (36 us at 3.35 TB/s); 43% of
// the (query, key) pairs are masked (the causal suffix and left pads).
//
// Two bodies, by dtype:
//   - bf16 runs the tensor-core body of flash_attention_fwd.cuh with its
//     bias mask (`fwd::BiasMask`): mma.sync bf16 products, S and P in
//     registers, K/V in bf16 and the bias tile in fp32 staged by cp.async
//     (one row of it for a bias of one row, `BiasMask<true>`), a key tile
//     whose bias is at most -2e30 for every row of the block skipped whole
//     (copies and products); the install's masked pairs are mostly such
//     tiles.  It needs q/k/v 16-byte aligned (base pointers and strides)
//     and returns cudaErrorMisalignedAddress otherwise; it never falls
//     back.
//   - f32 runs the SIMT body below, unchanged since it was first written:
//     fp32 CUDA-core FMAs on tiles staged in shared memory as fp32, so the
//     f32 callers (the f32 plumbing checks at 1e-4) get full fp32
//     arithmetic, which TF32 tensor cores would not give.  K1's SIMT
//     design: one block per (batch*head, 64-row q tile), 64-column K/V
//     tiles walked with an online softmax, each thread a 4x4 score
//     micro-tile and a 4 x D/16 output micro-tile, K and Q stored
//     transposed (+1 padding); no tile is skipped.
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

struct BiasParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* o;
  float* lse;          // (B, H, Sq)
  // element strides (batch, head, sequence); the head dim is contiguous
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  // bias strides (batch, head, query row), 0 where broadcast; columns are
  // contiguous
  int64_t b_sb, b_sh, b_sq;
  int H, Hkv, Sq, Skv;
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
flash_bias_fwd_kernel(const BiasParams p) {
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
  const float* bias = p.bias + b * p.b_sb + h * p.b_sh;

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

  for (int k0 = 0; k0 < p.Skv; k0 += kBK) {
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

    // + bias, online softmax, 4 threads per row (adjacent lanes of a warp);
    // rows past Sq and columns past Skv (the ragged edges) take no weight
    {
      const int r = tid / 4, sub = tid % 4;
      const int row = q0 + r;
      const bool row_ok = row < p.Sq;
      const float* brow = bias + (row_ok ? row : 0) * p.b_sq;
      float* prow = Ps + r * (kBK + 1);
      const float m_prev = m_s[r];
      float mx = kNegInf;
#pragma unroll
      for (int kk = 0; kk < kBK / 4; ++kk) {
        const int c = sub + 4 * kk, col = k0 + c;
        const bool ok = row_ok && col < p.Skv;
        const float x = ok ? prow[c] + brow[col] : kNegInf;
        prow[c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK / 4; ++kk) {
        const int c = sub + 4 * kk, col = k0 + c;
        const bool ok = row_ok && col < p.Skv;
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
        for (int j = 0; j < kDJ; ++j)
          acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
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
cudaError_t launch(const BiasParams& p, int B, cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bias_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_bias_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const BiasParams& p, int B, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, s);
    case 32: return launch<T, 32>(p, B, s);
    case 64: return launch<T, 64>(p, B, s);
    case 128: return launch<T, 128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: q, k, v, o (b, h, s) and bias (b, h, q) in elements
extern "C" int p2t_flash_bias_fwd(const void* q, const void* k,
                                  const void* v, const void* bias, void* o,
                                  void* lse, const int64_t* strides, int B,
                                  int H, int Hkv, int Sq, int Skv, int D,
                                  int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  BiasParams p;
  p.q = q; p.k = k; p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.b_sb = strides[12]; p.b_sh = strides[13]; p.b_sq = strides[14];
  p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == p2t::kBFloat16) {
    fwd::Params f =
        fwd::make_params(q, k, v, o, lse, strides, H, Hkv, Sq, Skv);
    f.bias = p.bias;
    f.b_sb = p.b_sb; f.b_sh = p.b_sh; f.b_sq = p.b_sq;
    return (int)(p.b_sq == 0 ? fwd::run<fwd::BiasMask<true>>(D, f, B, s)
                             : fwd::run<fwd::BiasMask<false>>(D, f, B, s));
  }
  if (dtype == p2t::kFloat32) return (int)dispatch_d<float>(D, p, B, s);
  return (int)cudaErrorInvalidValue;
}
