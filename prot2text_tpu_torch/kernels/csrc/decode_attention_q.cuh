// Grouped-query attention of G query tokens per row over layer `li` of the
// stacked int8 (L, B, Hkv, T, D) KV cache with per-(head, token) fp32
// scales, fused with the in-place write of the G current tokens' int8 k/v
// and scales at columns [slots[b], slots[b] + G) — the SIMT body of K7
// (G = 1, csrc/decode_attention_write_q.cu), K8 (a G-token speculative
// chunk, csrc/decode_attention_verify.cu), K9b and K9c for f32 q and for
// calls past the cluster-split body's 32 query rows, its only users: bf16
// K7-K9c within them run decode_attention_split.cuh's Int8Cache policy.
// K9b/K9c add a read-only int8 shared-prefix operand (L, 1, Hkv, Pc, D)
// with scales (L, 1, Hkv, Pc), gated per row by pmask.
//
// Numerics (the TPU kernels' rounding points): int8 → float is exact; a
// cache column's logit is the fp32 q·k_int times its k scale; its softmax
// weight times its v scale is rounded to bf16 before it meets v_int; the
// current token's (or chunk's) own columns stay fp32.  K7/K9b dequantize
// the current key before the dot (q·(kq·ks)), K8/K9c scale the dot
// ((q·kq)·ks), as the TPU kernels do.  Query row i of a block is query
// token i / rep; chunk column g is visible to it when g <= i / rep
// (causal inside the chunk; G = 1 is always visible).  The softmax runs
// over [prefix ‖ cache ‖ chunk] in one online pass.  Columns with
// kv_mask == 0 (or pmask == 0) are never read, so a stale or scratch
// column contributes exactly nothing.
//
// Bound: bytes.  One call reads each valid int8 cache column of every
// (b, kv head) (2·D bytes + 8 bytes of scales) for ~4·rows FLOP per byte
// (G·rep = 25 rows at the serving verify shape, 5 for decode), far below
// the card's ~295 FLOP/byte ridge.  Design, simple first: one block per
// (b, kv head, tile of 8 query rows) — K4's first design with int8 rows
// read 16 bytes per thread (one column per thread for q·k, one head-dim
// element per thread for P·V, both on fp32 FMAs) and the scales folded in
// per column.  It reaches ~1% of the bound at the serving shape: 64 blocks
// on 132 SMs, every column walked in series, and a verify call with 25
// rows runs 4 row tiles, each re-reading the slab (from L2 at the serving
// shape: a (b, head) slab is ~0.5 MB) — what the split body's Int8Cache
// policy does away with for bf16 K7-K9c within 32 rows.  Only
// row tile 0 writes the G new rows, after its last read; the written
// columns have kv_mask 0, so no block of the same slab reads them, and no
// other block touches the slab.  Registers (ptxas -v on sm_90a, logged by
// chip_smoke.py): 64 at D 128 without a prefix, 70 with one.
#pragma once

#include <float.h>

#include "common.cuh"

namespace {

using p2t::to_float;
using p2t::warp_max;
using p2t::warp_sum;

constexpr int kQThreads = 256;
constexpr int kQChunk = kQThreads;        // columns per softmax chunk
constexpr int kQWarps = kQThreads / 32;
constexpr int kQRows = kQWarps;           // query rows per block
constexpr int kQMaxG = 32;                // chunk tokens (G)
constexpr int kQMaxRows = 256;            // G·rep

template <typename T>
struct QParams {
  const T* qg;              // (B, Hkv, G·rep, D) pre-scaled, row g·rep + r
  int8_t* ck;               // layer slice (B, Hkv, T, D), G rows written
  int8_t* cv;
  float* sk;                // layer slice (B, Hkv, T), G entries written
  float* sv;
  const int32_t* kv_mask;   // (B, T) 0/1
  const float* kq;          // (B, Hkv, G, D) exact-integer fp32
  const float* vq;
  const float* ks;          // (B, Hkv, G)
  const float* vs;
  const int32_t* slots;     // (B,) first written column per row
  const int8_t* pk;         // prefix layer slice (Hkv, Pc, D); K9b/K9c
  const int8_t* pv;
  const float* psk;         // (Hkv, Pc)
  const float* psv;
  const int32_t* pmask;     // (B, Pc) 0/1
  T* out;                   // (B, Hkv, G·rep, D)
  int Hkv, rep, G, T_len, Pc;
  int dequant_first;        // 1: q·(kq·ks) (K7/K9b); 0: (q·kq)·ks
};

// 16 consecutive int8 values → fp32 with one 16-byte load (16B aligned)
__device__ __forceinline__ void load16_i8(const int8_t* p, float* out) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(b[i]);
}

template <typename T, int D, bool kPrefix>
__global__ void __launch_bounds__(kQThreads)
decode_attention_q_kernel(const QParams<T> p) {
  static_assert(kQThreads % D == 0 && D % 16 == 0, "unsupported head_dim");
  constexpr int kGroups = kQThreads / D;     // head rows in flight per d
  constexpr int kAcc = (kQRows + kGroups - 1) / kGroups;

  __shared__ float q_s[kQRows][D];
  __shared__ float p_s[kQRows][kQChunk];
  __shared__ float ln_s[kQRows][kQMaxG];
  __shared__ float red_s[kQRows][kQWarps];
  __shared__ float m_s[kQRows], l_s[kQRows], alpha_s[kQRows];
  __shared__ int valid_s[kQChunk];

  const int bg = blockIdx.x;                 // b * Hkv + kv head
  const int b = bg / p.Hkv;
  const int h = bg - b * p.Hkv;
  const int GR = p.G * p.rep;
  const int row0 = blockIdx.y * kQRows;      // this block's query rows
  const int nr = min(kQRows, GR - row0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Pc = kPrefix ? p.Pc : 0;
  const int n_cols = Pc + p.T_len;           // [prefix ‖ cache]

  const T* q = p.qg + ((int64_t)bg * GR + row0) * D;
  for (int i = tid; i < nr * D; i += kQThreads)
    q_s[i / D][i % D] = to_float(q[i]);
  __syncthreads();

  // the chunk's own columns start the online softmax: warp r computes row
  // r's logits against the G current keys (fp32), keeps the visible ones
  const float* kqb = p.kq + (int64_t)bg * p.G * D;
  const float* vqb = p.vq + (int64_t)bg * p.G * D;
  const float* ksb = p.ks + (int64_t)bg * p.G;
  const float* vsb = p.vs + (int64_t)bg * p.G;
  if (warp < nr) {
    const int gmax = (row0 + warp) / p.rep;  // last visible chunk column
    float m = -FLT_MAX;
    for (int g = 0; g < p.G; ++g) {
      float s = 0.f;
      if (p.dequant_first) {
        for (int d = lane; d < D; d += 32)
          s = fmaf(q_s[warp][d], kqb[g * D + d] * ksb[g], s);
        s = warp_sum(s);
      } else {
        for (int d = lane; d < D; d += 32)
          s = fmaf(q_s[warp][d], kqb[g * D + d], s);
        s = warp_sum(s) * ksb[g];
      }
      const bool vis = g <= gmax;
      if (lane == 0) ln_s[warp][g] = vis ? s : -FLT_MAX;
      if (vis) m = fmaxf(m, s);
    }
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
      for (int g = 0; g < p.G; ++g)
        if (ln_s[warp][g] != -FLT_MAX) l += expf(ln_s[warp][g] - m);
      m_s[warp] = m;
      l_s[warp] = l;
    }
  }
  __syncthreads();

  const int d = tid % D;
  const int g0 = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = g0 + kGroups * i;
    float a = 0.f;
    if (r < nr) {
      for (int g = 0; g < p.G; ++g) {
        if (ln_s[r][g] == -FLT_MAX) continue;
        const float w = expf(ln_s[r][g] - m_s[r]) * vsb[g];
        a = fmaf(w, vqb[g * D + d], a);
      }
    }
    acc[i] = a;
  }

  int8_t* kb = p.ck + (int64_t)bg * p.T_len * D;
  int8_t* vb = p.cv + (int64_t)bg * p.T_len * D;
  float* skb = p.sk + (int64_t)bg * p.T_len;
  float* svb = p.sv + (int64_t)bg * p.T_len;
  const int32_t* mb = p.kv_mask + (int64_t)b * p.T_len;
  const int8_t* pkb = kPrefix ? p.pk + (int64_t)h * Pc * D : nullptr;
  const int8_t* pvb = kPrefix ? p.pv + (int64_t)h * Pc * D : nullptr;
  const float* pskb = kPrefix ? p.psk + (int64_t)h * Pc : nullptr;
  const float* psvb = kPrefix ? p.psv + (int64_t)h * Pc : nullptr;
  const int32_t* pmb = kPrefix ? p.pmask + (int64_t)b * Pc : nullptr;

  for (int t0 = 0; t0 < n_cols; t0 += kQChunk) {
    const int t = t0 + tid;
    bool valid = false;
    const int8_t* krow = nullptr;
    float kscale = 0.f, vscale = 0.f;
    if (t < n_cols) {
      if (kPrefix && t < Pc) {
        valid = pmb[t] != 0;
        krow = pkb + (int64_t)t * D;
        if (valid) { kscale = pskb[t]; vscale = psvb[t]; }
      } else {
        valid = mb[t - Pc] != 0;
        krow = kb + (int64_t)(t - Pc) * D;
        if (valid) { kscale = skb[t - Pc]; vscale = svb[t - Pc]; }
      }
    }
    valid_s[tid] = valid;
    float s[kQRows];
#pragma unroll
    for (int r = 0; r < kQRows; ++r) s[r] = 0.f;
    if (valid) {
#pragma unroll 2
      for (int d0 = 0; d0 < D; d0 += 16) {
        float kf[16];
        load16_i8(krow + d0, kf);
#pragma unroll
        for (int r = 0; r < kQRows; ++r) {
          if (r < nr) {
#pragma unroll
            for (int e = 0; e < 16; ++e)
              s[r] = fmaf(q_s[r][d0 + e], kf[e], s[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kQRows; ++r) s[r] *= kscale;
    }
    // chunk max per row → new running max and the rescale factor
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
      if (r < nr) {
        const float x = warp_max(valid ? s[r] : -FLT_MAX);
        if (lane == 0) red_s[r][warp] = x;
      }
    }
    __syncthreads();
    if (tid < nr) {
      float cm = red_s[tid][0];
      for (int w = 1; w < kQWarps; ++w) cm = fmaxf(cm, red_s[tid][w]);
      const float m_new = fmaxf(m_s[tid], cm);
      alpha_s[tid] = expf(m_s[tid] - m_new);
      m_s[tid] = m_new;
    }
    __syncthreads();
    // weights (explicitly 0 where masked); the v scale is folded in and
    // the product rounded to bf16 before P·V, the sum stays unscaled fp32
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
      if (r < nr) {
        const float w = valid ? expf(s[r] - m_s[r]) : 0.f;
        p_s[r][tid] = p2t::round_to<__nv_bfloat16>(w * vscale);
        const float ws = warp_sum(w);
        if (lane == 0) red_s[r][warp] = ws;
      }
    }
    __syncthreads();
    if (tid < nr) {
      float sum = 0.f;
      for (int w = 0; w < kQWarps; ++w) sum += red_s[tid][w];
      l_s[tid] = l_s[tid] * alpha_s[tid] + sum;
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = g0 + kGroups * i;
      if (r < nr) acc[i] *= alpha_s[r];
    }
    const int n = min(kQChunk, n_cols - t0);
    for (int c = 0; c < n; ++c) {
      if (!valid_s[c]) continue;             // block-uniform branch
      const int tc = t0 + c;
      const int8_t* vrow = (kPrefix && tc < Pc) ? pvb + (int64_t)tc * D
                                                : vb + (int64_t)(tc - Pc) * D;
      const float v = static_cast<float>(vrow[d]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int r = g0 + kGroups * i;
        if (r < nr) acc[i] = fmaf(p_s[r][c], v, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = g0 + kGroups * i;
    if (r < nr)
      p.out[((int64_t)bg * GR + row0 + r) * D + d] =
          p2t::from_float<T>(acc[i] / l_s[r]);
  }

  // row tile 0 stores the G current tokens' int8 k/v and their scales at
  // columns slots[b] + g of its own (b, kv head) slab, after its last read
  // (the loop's final barrier).  Out-of-range columns are not written (the
  // wrappers check the slots; the serving engine never produces one).
  if (blockIdx.y != 0) return;
  const int slot = p.slots[b];
  for (int i = tid; i < 2 * p.G * D; i += kQThreads) {
    const int half = i / (p.G * D);          // 0: k, 1: v
    const int j = i - half * p.G * D;
    const int g = j / D;
    const int col = slot + g;
    if (col < 0 || col >= p.T_len) continue;
    const float x = half ? vqb[j] : kqb[j];
    (half ? vb : kb)[(int64_t)col * D + (j - g * D)] =
        static_cast<int8_t>(__float2int_rn(x));
  }
  for (int i = tid; i < 2 * p.G; i += kQThreads) {
    const int g = i % p.G;
    const int col = slot + g;
    if (col < 0 || col >= p.T_len) continue;
    if (i < p.G) skb[col] = ksb[g];
    else svb[col] = vsb[g];
  }
}

template <typename T, int D>
cudaError_t launch_q(const QParams<T>& p, int B, cudaStream_t stream) {
  const dim3 grid(B * p.Hkv, (p.G * p.rep + kQRows - 1) / kQRows);
  if (p.Pc > 0)
    decode_attention_q_kernel<T, D, true><<<grid, kQThreads, 0, stream>>>(p);
  else
    decode_attention_q_kernel<T, D, false><<<grid, kQThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_q(const void* qg, void* ck, void* cv, void* sk, void* sv,
                  const void* kv_mask, const void* kq, const void* vq,
                  const void* ks, const void* vs, const void* slots,
                  const void* pk, const void* pv, const void* psk,
                  const void* psv, const void* pmask, void* out, int B,
                  int Hkv, int rep, int G, int T_len, int Pc, int D,
                  int dequant_first, cudaStream_t s) {
  QParams<T> p;
  p.qg = static_cast<const T*>(qg);
  p.ck = static_cast<int8_t*>(ck);
  p.cv = static_cast<int8_t*>(cv);
  p.sk = static_cast<float*>(sk);
  p.sv = static_cast<float*>(sv);
  p.kv_mask = static_cast<const int32_t*>(kv_mask);
  p.kq = static_cast<const float*>(kq);
  p.vq = static_cast<const float*>(vq);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.slots = static_cast<const int32_t*>(slots);
  p.pk = static_cast<const int8_t*>(pk);
  p.pv = static_cast<const int8_t*>(pv);
  p.psk = static_cast<const float*>(psk);
  p.psv = static_cast<const float*>(psv);
  p.pmask = static_cast<const int32_t*>(pmask);
  p.out = static_cast<T*>(out);
  p.Hkv = Hkv; p.rep = rep; p.G = G; p.T_len = T_len; p.Pc = Pc;
  p.dequant_first = dequant_first;
  switch (D) {
    case 16: return launch_q<T, 16>(p, B, s);
    case 32: return launch_q<T, 32>(p, B, s);
    case 64: return launch_q<T, 64>(p, B, s);
    case 128: return launch_q<T, 128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// argument check + dtype dispatch shared by the two C entry points
inline int q_entry(const void* qg, void* ck, void* cv, void* sk, void* sv,
                   const void* kv_mask, const void* kq, const void* vq,
                   const void* ks, const void* vs, const void* slots,
                   const void* pk, const void* pv, const void* psk,
                   const void* psv, const void* pmask, void* out, int B,
                   int Hkv, int rep, int G, int T_len, int Pc, int D,
                   int dtype, int dequant_first, void* stream) {
  if (B <= 0 || Hkv <= 0 || rep <= 0 || G <= 0 || G > kQMaxG ||
      G * rep > kQMaxRows || T_len <= 0 || Pc < 0 ||
      (Pc > 0 && (pk == nullptr || pv == nullptr || psk == nullptr ||
                  psv == nullptr || pmask == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == p2t::kBFloat16)
    return (int)run_q<__nv_bfloat16>(qg, ck, cv, sk, sv, kv_mask, kq, vq, ks,
                                     vs, slots, pk, pv, psk, psv, pmask, out,
                                     B, Hkv, rep, G, T_len, Pc, D,
                                     dequant_first, s);
  if (dtype == p2t::kFloat32)
    return (int)run_q<float>(qg, ck, cv, sk, sv, kv_mask, kq, vq, ks, vs,
                             slots, pk, pv, psk, psv, pmask, out, B, Hkv,
                             rep, G, T_len, Pc, D, dequant_first, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
