// K2: grouped-query decode attention over layer `li` of the stacked
// (L, B, Hkv, T, D) KV cache, for one new token per row.
//
// Replaces prot2text_tpu/kernels/decode_attention.py decode_attention_stacked
// (_kernel).  Semantics kept: q is pre-scaled; logits are fp32; cache
// columns with kv_mask == 0 take no weight and are never read (the JAX
// kernel gives them finfo(f32).min, whose weight is exactly 0 once the
// always-valid current column sets the max); the current token's k/v are
// one extra logit column; the cache is read-only (the slot write is K3,
// after the layer loop); softmax weights are rounded to the cache dtype
// before P·V, the sum of weights stays fp32.  The TPU kernel read the layer
// by scalar-prefetch block indexing; here the wrapper passes a pointer
// offset into the stacked buffer, so no per-layer copy exists either.
//
// Bound: bytes.  A step reads each valid column of B*Hkv*T*D*2*itemsize
// bytes per layer once (17 MB, 5.1 us at 3.35 TB/s, at B=4, Hkv=8,
// T=1280 with ~1040 valid columns a row, D=128, bf16) for ~2 FLOP per
// byte.  bf16 runs the column-split cluster body of
// decode_attention_split.cuh (policies CacheCols, Bf16Cache and NoWrite;
// its header states the design and the rule for the cluster size).  f32
// runs the SIMT body below: one block per (b, kv head) handles all `rep`
// query heads of the group, so every K/V row is read once for the group;
// an online softmax walks T in chunks of 256 columns (one column per thread
// for q·k with 16-byte loads; one head-dim element per thread for P·V,
// coalesced across the warp); masked columns are not read at all.  It
// fills only B*Hkv of the 132 SMs: f32 models (`--model_dtype fp32`) are
// for checking, not for speed.
#include <float.h>

#include "common.cuh"
#include "decode_attention_split.cuh"

namespace {

using p2t::load8;
using p2t::warp_max;
using p2t::warp_sum;

constexpr int kThreads = 256;
constexpr int kChunk = kThreads;     // cache columns per softmax chunk
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = kWarps;      // query heads per kv head (GQA group)

template <int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const float* __restrict__ qg,    // (B, Hkv, rep, D), pre-scaled
    const float* __restrict__ ck,    // layer slice (B, Hkv, T, D)
    const float* __restrict__ cv,
    const int32_t* __restrict__ kv_mask,  // (B, T) 0/1
    const float* __restrict__ k_new, // (B, Hkv, D)
    const float* __restrict__ v_new,
    float* __restrict__ out,         // (B, Hkv, rep, D)
    int Hkv, int rep, int T_len) {
  static_assert(kThreads % D == 0 && D % 8 == 0, "unsupported head_dim");
  constexpr int kGroups = kThreads / D;        // head rows in flight per d
  constexpr int kRows = (kMaxRep + kGroups - 1) / kGroups;

  __shared__ float q_s[kMaxRep][D];
  __shared__ float p_s[kMaxRep][kChunk];
  __shared__ float red_s[kMaxRep][kWarps];
  __shared__ float m_s[kMaxRep], l_s[kMaxRep], alpha_s[kMaxRep];
  __shared__ int valid_s[kChunk];

  const int bg = blockIdx.x;                   // b * Hkv + kv head
  const int b = bg / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  const float* q = qg + (int64_t)bg * rep * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i / D][i % D] = q[i];
  __syncthreads();

  // The current token's column starts the online softmax: m = its logit,
  // l = exp(0) = 1, acc = its v.  Warp r computes head r's logit.
  if (warp < rep) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32)
      s = fmaf(q_s[warp][d], k_new[(int64_t)bg * D + d], s);
    s = warp_sum(s);
    if (lane == 0) {
      m_s[warp] = s;
      l_s[warp] = 1.f;
    }
  }
  __syncthreads();

  const int d = tid % D;
  const int g0 = tid / D;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = g0 + kGroups * i;
    acc[i] = r < rep ? v_new[(int64_t)bg * D + d] : 0.f;
  }

  const float* kb = ck + (int64_t)bg * T_len * D;
  const float* vb = cv + (int64_t)bg * T_len * D;
  const int32_t* mb = kv_mask + (int64_t)b * T_len;

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int t = t0 + tid;
    const bool valid = t < T_len && mb[t] != 0;
    valid_s[tid] = valid;
    float s[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) s[r] = 0.f;
    if (valid) {
      const float* krow = kb + (int64_t)t * D;
#pragma unroll 2
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kf[8];
        load8(krow + d0, kf);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
#pragma unroll
            for (int e = 0; e < 8; ++e) s[r] = fmaf(q_s[r][d0 + e], kf[e], s[r]);
          }
        }
      }
    }
    // chunk max per head → new running max and the rescale factor
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        const float x = warp_max(valid ? s[r] : -FLT_MAX);
        if (lane == 0) red_s[r][warp] = x;
      }
    }
    __syncthreads();
    if (tid < rep) {
      float cm = red_s[tid][0];
      for (int w = 1; w < kWarps; ++w) cm = fmaxf(cm, red_s[tid][w]);
      const float m_new = fmaxf(m_s[tid], cm);
      alpha_s[tid] = expf(m_s[tid] - m_new);
      m_s[tid] = m_new;
    }
    __syncthreads();
    // weights (explicitly 0 where masked) and their chunk sums
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        const float p = valid ? expf(s[r] - m_s[r]) : 0.f;
        p_s[r][tid] = p;
        const float ps = warp_sum(p);
        if (lane == 0) red_s[r][warp] = ps;
      }
    }
    __syncthreads();
    if (tid < rep) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red_s[tid][w];
      l_s[tid] = l_s[tid] * alpha_s[tid] + sum;
    }
    // acc = acc * alpha + P·V over the chunk's valid columns
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = g0 + kGroups * i;
      if (r < rep) acc[i] *= alpha_s[r];
    }
    const int n = min(kChunk, T_len - t0);
    for (int c = 0; c < n; ++c) {
      if (!valid_s[c]) continue;             // block-uniform branch
      const float v = vb[(int64_t)(t0 + c) * D + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = g0 + kGroups * i;
        if (r < rep) acc[i] = fmaf(p_s[r][c], v, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = g0 + kGroups * i;
    if (r < rep)
      out[((int64_t)bg * rep + r) * D + d] = acc[i] / l_s[r];
  }
}

template <int D>
cudaError_t launch(const void* qg, const void* ck, const void* cv,
                   const void* kv_mask, const void* k_new, const void* v_new,
                   void* out, int B, int Hkv, int rep, int T_len,
                   cudaStream_t stream) {
  decode_attention_kernel<D><<<B * Hkv, kThreads, 0, stream>>>(
      static_cast<const float*>(qg), static_cast<const float*>(ck),
      static_cast<const float*>(cv), static_cast<const int32_t*>(kv_mask),
      static_cast<const float*>(k_new), static_cast<const float*>(v_new),
      static_cast<float*>(out), Hkv, rep, T_len);
  return cudaGetLastError();
}

cudaError_t dispatch_d(int D, const void* qg, const void* ck, const void* cv,
                       const void* kv_mask, const void* k_new,
                       const void* v_new, void* out, int B, int Hkv, int rep,
                       int T_len, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(qg, ck, cv, kv_mask, k_new, v_new, out, B, Hkv, rep, T_len, s);
    case 32: return launch<32>(qg, ck, cv, kv_mask, k_new, v_new, out, B, Hkv, rep, T_len, s);
    case 64: return launch<64>(qg, ck, cv, kv_mask, k_new, v_new, out, B, Hkv, rep, T_len, s);
    case 128: return launch<128>(qg, ck, cv, kv_mask, k_new, v_new, out, B, Hkv, rep, T_len, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ck/cv: the layer's (B, Hkv, T, D) slice.  bf16 runs the split body, f32
// the SIMT body.
extern "C" int p2t_decode_attention(const void* qg, const void* ck,
                                    const void* cv, const void* kv_mask,
                                    const void* k_new, const void* v_new,
                                    void* out, int B, int Hkv, int rep,
                                    int T_len, int D, int dtype,
                                    void* stream) {
  if (B <= 0 || Hkv <= 0 || rep <= 0 || rep > kMaxRep || T_len <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == p2t::kBFloat16)
    return (int)split::run<split::CacheCols>(
        D,
        split::make_params(qg, ck, cv, kv_mask, nullptr, nullptr, nullptr,
                           out, Hkv, rep, T_len, 0),
        split::Bf16Cache{static_cast<const split::bf16*>(k_new),
                         static_cast<const split::bf16*>(v_new)},
        split::NoWrite{}, B, s);
  if (dtype == p2t::kFloat32)
    return (int)dispatch_d(D, qg, ck, cv, kv_mask, k_new, v_new, out, B, Hkv,
                           rep, T_len, s);
  return (int)cudaErrorInvalidValue;
}
