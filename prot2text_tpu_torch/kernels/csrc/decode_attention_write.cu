// K4 and K9a: grouped-query decode attention over layer `li` of the stacked
// (L, B, Hkv, T, D) KV cache, fused with the in-place write of each row's
// current k/v into its own cache slot `slots[b]`; K9a adds a read-only
// shared-prefix operand (L, 1, Hkv, Pc, D), or (L, Pc, 1, Hkv, D) beside a
// tbkd (L, T, B, Hkv, D) cache, that every row may attend.
//
// Replaces prot2text_tpu/kernels/decode_attention.py
// decode_attention_stacked_write (_kernel_write, K4) and
// decode_attention_stacked_write_prefix (_kernel_write_p, K9a).  Semantics
// kept: q is pre-scaled; logits are fp32; columns with kv_mask == 0 (and,
// K9a, prefix columns with pmask == 0) are excluded; the current token's
// k/v are one extra logit column; the softmax runs over [prefix ‖ cache ‖
// current] in one pass; weights are rounded to the cache dtype before P·V
// and their sum stays fp32.  The TPU kernels read-modified-wrote a 16-row
// tile group through an aliased output; here each row's slot row of its
// own (b, kv head) slab is written after the last read of that slab, so
// the write cannot race a read (no other row touches that slab, and the
// slot column is masked anyway).  Masked columns are never read at all, so
// a stale, scratch or uninitialised column cannot leak a NaN into the
// output.  Slots may repeat across rows (every inactive serving row writes
// the scratch column T - 1): each row owns its slab.
//
// Bound: bytes.  A step reads the valid cache columns of every (b, kv head)
// once per layer (B=8, Hkv=8, ~700 valid columns, D=128, bf16: ~18 MB,
// 5.3 us at 3.35 TB/s) for ~2 FLOP per byte, plus 2*B*Hkv*D*2 bytes of
// writes.  bf16 runs the column-split cluster body of
// decode_attention_split.cuh (K4 with the policies CacheCols, Bf16Cache
// and SlotWrite, K9a with PrefixCols, Bf16Cache and SlotWrite; its header
// states the design).  f32 runs the SIMT body below: one block per (b, kv head)
// handles all `rep` query heads of the group, an online softmax walks the
// columns in chunks of 256 (one column per thread for q·k with 16-byte
// loads, one head-dim element per thread for P·V), and the slot row is
// written after the loop's last barrier.  It fills only B*Hkv of the 132
// SMs: f32 models (`--model_dtype fp32`) are for checking, not for speed.
#include <float.h>

#include "common.cuh"
#include "decode_attention_split.cuh"

namespace {

using p2t::load8;
using p2t::warp_max;
using p2t::warp_sum;

constexpr int kThreads = 256;
constexpr int kChunk = kThreads;     // columns per softmax chunk
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = kWarps;      // query heads per kv head (GQA group)

struct WriteParams {
  const float* qg;      // (B, Hkv, rep, D), pre-scaled
  float* ck;            // layer slice (B, Hkv, T, D) or (T, B, Hkv, D),
  float* cv;            // slot row written
  const int32_t* kv_mask;   // (B, T) 0/1
  const float* k_new;   // (B, Hkv, D)
  const float* v_new;
  const int32_t* slots; // (B,) slot per row
  const float* pk;      // prefix layer slice; K9a only
  const float* pv;
  const int32_t* pmask; // (B, Pc) 0/1; K9a only
  float* out;           // (B, Hkv, rep, D)
  int Hkv, rep, T_len, Pc;
  int64_t slab_stride;  // the cache's: (b, kv head) slab to slab, bktd T·D,
  int64_t col_stride;   // tbkd D; column to column, bktd D, tbkd B·Hkv·D
  int64_t pfx_head_stride;  // the prefix's: kv head to kv head, bktd Pc·D,
  int64_t pfx_col_stride;   // tbkd D; column to column, bktd D, tbkd Hkv·D
};

template <int D, bool kPrefix>
__global__ void __launch_bounds__(kThreads)
decode_attention_write_kernel(const WriteParams p) {
  static_assert(kThreads % D == 0 && D % 8 == 0, "unsupported head_dim");
  constexpr int kGroups = kThreads / D;        // head rows in flight per d
  constexpr int kRows = (kMaxRep + kGroups - 1) / kGroups;

  __shared__ float q_s[kMaxRep][D];
  __shared__ float p_s[kMaxRep][kChunk];
  __shared__ float red_s[kMaxRep][kWarps];
  __shared__ float m_s[kMaxRep], l_s[kMaxRep], alpha_s[kMaxRep];
  __shared__ int valid_s[kChunk];

  const int bg = blockIdx.x;                   // b * Hkv + kv head
  const int b = bg / p.Hkv;
  const int h = bg - b * p.Hkv;
  const int rep = p.rep;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Pc = kPrefix ? p.Pc : 0;
  const int n_cols = Pc + p.T_len;             // [prefix ‖ cache]

  const float* q = p.qg + (int64_t)bg * rep * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i / D][i % D] = q[i];
  __syncthreads();

  // the current token's column starts the online softmax: m = its logit,
  // l = exp(0) = 1, acc = its v.  Warp r computes head r's logit.
  if (warp < rep) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32)
      s = fmaf(q_s[warp][d], p.k_new[(int64_t)bg * D + d], s);
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
    acc[i] = r < rep ? p.v_new[(int64_t)bg * D + d] : 0.f;
  }

  float* kb = p.ck + bg * p.slab_stride;
  float* vb = p.cv + bg * p.slab_stride;
  const int32_t* mb = p.kv_mask + (int64_t)b * p.T_len;
  const float* pkb = kPrefix ? p.pk + h * p.pfx_head_stride : nullptr;
  const float* pvb = kPrefix ? p.pv + h * p.pfx_head_stride : nullptr;
  const int32_t* pmb = kPrefix ? p.pmask + (int64_t)b * Pc : nullptr;

  for (int t0 = 0; t0 < n_cols; t0 += kChunk) {
    const int t = t0 + tid;
    bool valid = false;
    const float* krow = nullptr;
    if (t < n_cols) {
      if (kPrefix && t < Pc) {
        valid = pmb[t] != 0;
        krow = pkb + t * p.pfx_col_stride;
      } else {
        valid = mb[t - Pc] != 0;
        krow = kb + (t - Pc) * p.col_stride;
      }
    }
    valid_s[tid] = valid;
    float s[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) s[r] = 0.f;
    if (valid) {
#pragma unroll 2
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kf[8];
        load8(krow + d0, kf);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              s[r] = fmaf(q_s[r][d0 + e], kf[e], s[r]);
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
        const float w = valid ? expf(s[r] - m_s[r]) : 0.f;
        p_s[r][tid] = w;
        const float ws = warp_sum(w);
        if (lane == 0) red_s[r][warp] = ws;
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
    const int n = min(kChunk, n_cols - t0);
    for (int c = 0; c < n; ++c) {
      if (!valid_s[c]) continue;             // block-uniform branch
      const int tc = t0 + c;
      const float* vrow = (kPrefix && tc < Pc) ? pvb + tc * p.pfx_col_stride
                                               : vb + (tc - Pc) * p.col_stride;
      const float v = vrow[d];
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
      p.out[((int64_t)bg * rep + r) * D + d] = acc[i] / l_s[r];
  }

  // every read of this (b, kv head) slab ended at the loop's last barrier:
  // store the current token's k/v into row slots[b] of the layer.  An
  // out-of-range slot is not written (the wrappers' plain versions raise
  // on it; the serving engine never produces one).
  const int slot = p.slots[b];
  if (slot >= 0 && slot < p.T_len) {
    for (int i = tid; i < 2 * D; i += kThreads) {
      if (i < D)
        kb[slot * p.col_stride + i] = p.k_new[(int64_t)bg * D + i];
      else
        vb[slot * p.col_stride + i - D] = p.v_new[(int64_t)bg * D + i - D];
    }
  }
}

template <int D>
cudaError_t launch(const WriteParams& p, int B, cudaStream_t stream) {
  const dim3 grid(B * p.Hkv);
  if (p.Pc > 0)
    decode_attention_write_kernel<D, true><<<grid, kThreads, 0, stream>>>(p);
  else
    decode_attention_write_kernel<D, false><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_d(int D, const WriteParams& p, int B, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    case 128: return launch<128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ck/cv: the layer's slice at element strides slab_stride (from one (b, kv
// head) slab to the next) and col_stride (from one column to the next):
// (T·D, D) for a bktd (B, Hkv, T, D) slice, (D, B·Hkv·D) for a tbkd
// (T, B, Hkv, D) one; pk/pv: the layer's prefix slice at element strides
// pfx_head_stride (kv head to kv head) and pfx_col_stride (column to
// column): (Pc·D, D) for a bktd (1, Hkv, Pc, D) slice, (D, Hkv·D) for a
// tbkd (Pc, 1, Hkv, D) one; pmask (B, Pc); all four ignored when Pc == 0
// (K4).  bf16 runs the split body (K4: CacheCols, K9a: PrefixCols; both
// SlotWrite), f32 the SIMT body.
extern "C" int p2t_decode_attention_write(
    const void* qg, void* ck, void* cv, const void* kv_mask,
    const void* k_new, const void* v_new, const void* slots, const void* pk,
    const void* pv, const void* pmask, void* out, int B, int Hkv, int rep,
    int T_len, int Pc, int D, int64_t slab_stride, int64_t col_stride,
    int64_t pfx_head_stride, int64_t pfx_col_stride, int dtype,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || rep <= 0 || rep > kMaxRep || T_len <= 0 ||
      Pc < 0 || (Pc > 0 && (pk == nullptr || pv == nullptr ||
                            pmask == nullptr || pfx_head_stride <= 0 ||
                            pfx_col_stride <= 0)) ||
      slab_stride <= 0 || col_stride <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == p2t::kBFloat16) {
    const split::Params<split::bf16> p = split::make_params(
        qg, ck, cv, kv_mask, pk, pv, pmask, out, Hkv, rep, T_len, Pc,
        slab_stride, col_stride, pfx_head_stride, pfx_col_stride);
    const split::Bf16Cache e = {static_cast<const split::bf16*>(k_new),
                                static_cast<const split::bf16*>(v_new)};
    const split::SlotWrite w = {static_cast<split::bf16*>(ck),
                                static_cast<split::bf16*>(cv),
                                static_cast<const int32_t*>(slots)};
    return (int)(Pc > 0 ? split::run<split::PrefixCols>(D, p, e, w, B, s)
                        : split::run<split::CacheCols>(D, p, e, w, B, s));
  }
  if (dtype == p2t::kFloat32) {
    WriteParams p;
    p.qg = static_cast<const float*>(qg);
    p.ck = static_cast<float*>(ck);
    p.cv = static_cast<float*>(cv);
    p.kv_mask = static_cast<const int32_t*>(kv_mask);
    p.k_new = static_cast<const float*>(k_new);
    p.v_new = static_cast<const float*>(v_new);
    p.slots = static_cast<const int32_t*>(slots);
    p.pk = static_cast<const float*>(pk);
    p.pv = static_cast<const float*>(pv);
    p.pmask = static_cast<const int32_t*>(pmask);
    p.out = static_cast<float*>(out);
    p.Hkv = Hkv; p.rep = rep; p.T_len = T_len; p.Pc = Pc;
    p.slab_stride = slab_stride; p.col_stride = col_stride;
    p.pfx_head_stride = pfx_head_stride; p.pfx_col_stride = pfx_col_stride;
    return (int)dispatch_d(D, p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The clusters of bf16 K4's (prefix 0) or K9a's (prefix 1) split-body
// instantiation at head dim D that the card holds at once, into *n
// (scripts/sweep_decode_split.py; no path calls it)
extern "C" int p2t_decode_split_bf16_resident(int prefix, int D, void* n) {
  int* out = static_cast<int*>(n);
  return (int)(prefix ? split::resident_clusters<split::PrefixCols,
                                                 split::Bf16Cache,
                                                 split::SlotWrite>(D, 1, out)
                      : split::resident_clusters<split::CacheCols,
                                                 split::Bf16Cache,
                                                 split::SlotWrite>(D, 1,
                                                                   out));
}
