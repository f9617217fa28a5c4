// The bf16 flash-attention forward on the tensor cores: one body for K1
// (flash_attention.cu: masked key runs, causal) and K6
// (flash_attention_bias.cu: an additive fp32 bias), which differ only in a
// mask policy (`RunMask`, `BiasMask` below).  The f32 forwards stay on
// those files' SIMT bodies: they compute in full fp32, which the f32
// callers rely on, and TF32 tensor cores would not.
//
// Contract (both policies, as the TPU kernels): q arrives pre-scaled; the
// logits, the running max m and sum l are fp32; m starts at -1e30 and stays
// finite (so no -inf - -inf can arise); the weights are rounded to bf16
// (the value dtype) before P·V, while l sums them unrounded; o = O / l and
// lse = m + log(l), with l taken as 1 where it is 0, so a row that takes no
// key gives o = 0 and lse = -1e30.  GQA: query head h reads kv head
// h / (H / Hkv).  Any Sq and Skv: ragged tiles are zero-filled and their
// columns take no weight.  q/k/v/o are strided (transposes of (B, S, H, D)
// buffers); every base pointer and every stride must be 16-byte aligned,
// which the entry points check (cp.async copies 16 bytes).
//
// Bound: at the shapes of the port's paths the products and the bytes set
// limits of the same size (K6 at the serving prefix install: 36.9 GFLOP of
// unmasked pairs, 37 us at 989 TFLOP/s bf16, over 122 MB, 36 us at 3.35
// TB/s; K1 at the Llama-3.1-8B prefill: 21 us and 25 us), and the fp32 CUDA
// cores (67 TFLOP/s) would take 15 times the product bound.  So the design
// keeps the products on the bf16 tensor cores and every intermediate in
// registers, and spends shared memory only on operands:
//   - a block of 4 warps takes 64 query rows of one (batch, head), 16 a
//     warp, and walks the key tiles of 64 with an online softmax; the
//     registers are capped so that three blocks share an SM (two for K6's
//     full-height bias, whose stages take 37 KB);
//   - Q is staged once; S = Q·Kᵀ is 8 m16n8k16 accumulator tiles per warp
//     (mma.sync, fp32), its A fragments read by ldmatrix; the softmax runs
//     on those fragments, the row max and sum across each quad of lanes by
//     two shuffles; P is rounded to bf16 and repacked from the accumulator
//     layout straight into A fragments; V is read with ldmatrix.trans; O
//     accumulates in registers.  S and P never touch shared memory;
//   - K and V stay bf16 in shared memory, rows padded by 16 bytes so
//     ldmatrix is free of bank conflicts, and arrive by cp.async in two
//     halves: V's copy overlaps S = Q·Kᵀ, the next tile's K overlaps the
//     softmax and P·V;
//   - K6's bias tiles are staged by cp.async too, one tile ahead (read from
//     global memory as each tile was reached, their latency tripled the
//     kernel's time), one row of them where the bias has one row;
//   - tiles that no row sees are skipped: K1's block-level range
//     [kv_start, kv_start + kv_len) ∩ causal (as the SIMT K1) and, per
//     warp, tiles above its rows; K6's block vote on the next tile's staged
//     bias (every value <= -2e30: such a tile adds exactly 0 to l and O and
//     leaves m, whose floor is -1e30, unchanged, as long as |q·k| < 1e30)
//     skips its K and V copies and its products; this drops the causal
//     suffix and the left pads of the prefix install and the key padding
//     of ESMC;
//   - the q tiles run last-first, so the long causal tiles start first.
// wgmma + TMA with a producer warp (warp specialisation) is the follow-up.
#pragma once

#include "common.cuh"

namespace {
namespace fwd {

using p2t::cp_async16;
using p2t::cp_async4;
using p2t::cp_async_rows;
using p2t::cp_async_commit;
using p2t::cp_async_wait;
using p2t::exp2_approx;
using p2t::ldmatrix_x4;
using p2t::ldmatrix_x4_trans;
using p2t::mma_bf16;
using p2t::pack_bf16x2;

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;      // query rows per block, 16 a warp
constexpr int kBK = 64;               // keys per K/V tile
constexpr float kNegInf = -1e30f;     // the running max's floor
constexpr float kSkipBias = -2e30f;   // a bias at or below it adds nothing
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBiasStride = kBK + 8;  // fp32 per staged bias row (+32 bytes)

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;          // (B, H, Sq)
  // element strides (batch, head, sequence); the head dim is contiguous
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int H, Hkv, Sq, Skv;
  // RunMask
  const int32_t* kv_start;
  const int32_t* kv_len;
  int causal;
  // BiasMask: strides (batch, head, query row), 0 where broadcast
  const float* bias;
  int64_t b_sb, b_sh, b_sq;
};

// K1: the keys of batch row b are [kv_start[b], kv_start[b] + kv_len[b])
// within [0, Skv), and with `causal` also col <= row (sequence index).
struct RunMask {
  static constexpr bool kStaged = false;   // nothing beside K/V
  static constexpr int kStageRows = 0;      // rows of each staged tile
  static constexpr int kMinBlocks = 3;      // blocks an SM (caps registers)
  int start, end, causal;

  __device__ RunMask(const Params& p, int b, int) {
    start = max(p.kv_start[b], 0);
    end = min(p.kv_start[b] + p.kv_len[b], p.Skv);
    causal = p.causal;
  }
  // the block's key range: tiles from `lo` (a multiple of kBK) below `hi`
  __device__ void tiles(const Params&, int q_last, int* lo, int* hi) const {
    *lo = start / kBK * kBK;
    *hi = causal ? min(end, q_last + 1) : end;
  }
  __device__ void stage(float*, int, int, int, const Params&) const {}
  // S starts at 0; true when no row of the warp (rows r0 .. r0 + 15) sees
  // a key of the tile
  template <int kNT>
  __device__ bool init(float (&s)[kNT][4], const float*, int k0, int r0, int,
                       int, int, const Params&) const {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    return causal && k0 > r0 + 15;
  }
  // -inf where the key is not visible; nothing on a tile inside the run
  // and below every row's diagonal
  template <int kNT>
  __device__ void apply(float (&s)[kNT][4], int k0, int r0, int g, int t,
                        const Params&) const {
    if (k0 >= start && k0 + kBK <= end && (!causal || k0 + kBK - 1 <= r0))
      return;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = r0 + g + 8 * (e >> 1);
        if (!(col >= start && col < end && (!causal || col <= row)))
          s[j][e] = neg_inf();
      }
  }
};

// K6: logits = q·kᵀ + bias[b|0, h|0, row|0, col], the bias fp32 and read
// through its broadcast strides, columns contiguous.  The block's bias
// tiles (its rows, a key tile's 64 columns) are staged in shared memory by
// cp.async one key tile ahead, so the block can vote on a tile before it
// copies its K and V.  kOne: the bias has one row for every query (B|1,
// H|1, 1, Skv), as ESMC's key padding does; then only that row is staged
// (the same row copied for every query took up to three quarters of the
// kernel's time at ESMC's shapes).
template <bool kOne>
struct BiasMask {
  static constexpr bool kStaged = true;
  static constexpr int kStageRows = kOne ? 1 : kBQ;
  static constexpr int kMinBlocks = kOne ? 3 : 2;
  const float* bias;
  int64_t sq;
  bool vec;            // rows 16-byte aligned: 16-byte copies, else 4-byte

  __device__ BiasMask(const Params& p, int b, int h)
      : bias(p.bias + b * p.b_sb + h * p.b_sh), sq(p.b_sq),
        vec((reinterpret_cast<uintptr_t>(p.bias) & 15) == 0 &&
            ((p.b_sb | p.b_sh | p.b_sq) & 3) == 0) {}
  __device__ void tiles(const Params& p, int, int* lo, int* hi) const {
    *lo = 0;
    *hi = p.Skv;
  }
  // the bias of rows q0 .. q0 + kBQ - 1 (kOne: one row), columns k0 ..
  // k0 + 63 → shared [kBQ][kBiasStride]; rows past Sq and columns past Skv
  // zero-filled
  __device__ void stage(float* bs, int k0, int q0, int tid,
                        const Params& p) const {
    if (vec) {
      constexpr int kChunks = kBK / 4;
#pragma unroll
      for (int it = 0; it < kBQ * kChunks / kThreads; ++it) {
        const int i = tid + it * kThreads;
        if (kOne && i >= kChunks) break;
        const int r = i / kChunks, c = 4 * (i % kChunks);
        const int n = q0 + r < p.Sq ? 4 * min(max(p.Skv - k0 - c, 0), 4) : 0;
        cp_async16(bs + r * kBiasStride + c,
                   n ? bias + (q0 + r) * sq + k0 + c : bias, n);
      }
    } else {
#pragma unroll 8
      for (int it = 0; it < kBQ * kBK / kThreads; ++it) {
        const int i = tid + it * kThreads;
        if (kOne && i >= kBK) break;
        const int r = i / kBK, c = i % kBK;
        const bool ok = q0 + r < p.Sq && k0 + c < p.Skv;
        cp_async4(bs + r * kBiasStride + c,
                  ok ? bias + (q0 + r) * sq + k0 + c : bias, ok ? 4 : 0);
      }
    }
  }
  // S starts at the staged bias of the thread's fragment (the warp's rows
  // rl .. rl + 15 of the block); false: the block's vote on the staged
  // tile decides what is skipped
  template <int kNT>
  __device__ bool init(float (&s)[kNT][4], const float* bs, int, int, int rl,
                       int g, int t, const Params&) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* row =
          bs + (kOne ? 0 : (rl + g + 8 * r) * kBiasStride) + 2 * t;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(row + 8 * j);
        s[j][2 * r] = x.x;
        s[j][2 * r + 1] = x.y;
      }
    }
    return false;
  }
  // this thread's share of the block's vote on a staged tile: true when
  // one of the values it copied itself (so its own wait suffices) is above
  // kSkipBias; rows past Sq and columns past Skv, zero-filled, do not count
  __device__ bool any_live(const float* bs, int k0, int q0, int tid,
                           const Params& p) const {
    bool live = false;
    if (vec) {
      constexpr int kChunks = kBK / 4;
#pragma unroll
      for (int it = 0; it < kBQ * kChunks / kThreads; ++it) {
        const int i = tid + it * kThreads;
        if (kOne && i >= kChunks) break;
        const int r = i / kChunks, c = 4 * (i % kChunks);
        const float4 x =
            *reinterpret_cast<const float4*>(bs + r * kBiasStride + c);
        const int n = q0 + r < p.Sq ? p.Skv - k0 - c : 0;
        live = live || (n > 0 && x.x > kSkipBias) ||
               (n > 1 && x.y > kSkipBias) || (n > 2 && x.z > kSkipBias) ||
               (n > 3 && x.w > kSkipBias);
      }
    } else {
#pragma unroll 8
      for (int it = 0; it < kBQ * kBK / kThreads; ++it) {
        const int i = tid + it * kThreads;
        if (kOne && i >= kBK) break;
        const int r = i / kBK, c = i % kBK;
        live = live || (q0 + r < p.Sq && k0 + c < p.Skv &&
                        bs[r * kBiasStride + c] > kSkipBias);
      }
    }
    return live;
  }
  // -inf on the ragged columns past Skv
  template <int kNT>
  __device__ void apply(float (&s)[kNT][4], int k0, int, int, int t,
                        const Params& p) const {
    if (k0 + kBK <= p.Skv) return;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= p.Skv) s[j][e] = neg_inf();
  }
};

template <int D, class Mask>
struct Layout {
  static constexpr int kStride = D + 8;   // bf16 per shared row (+16 bytes)
  static constexpr int kQ = kBQ * kStride;
  static constexpr int kKV = kBK * kStride;
  // two staged tiles: this key tile's and the next one's
  static constexpr int kBias = 2 * Mask::kStageRows * kBiasStride;
  // Q, K, V (bf16), then the staged tiles (fp32)
  static constexpr size_t kBytes =
      sizeof(bf16) * (kQ + 2 * kKV) + sizeof(float) * kBias;
};

template <int D, class Mask>
__global__ void __launch_bounds__(kThreads, Mask::kMinBlocks)
flash_fwd_kernel(const Params p) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim in {16, 32, 64, 128}");
  using L = Layout<D, Mask>;
  constexpr int kKT = D / 16;     // k steps of Q·Kᵀ
  constexpr int kNT = kBK / 8;    // S accumulator tiles per warp
  constexpr int kDT = D / 8;      // O accumulator tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + L::kQ;
  bf16* Vs = Ks + L::kKV;
  float* Bs = reinterpret_cast<float*>(Vs + L::kKV);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int rl = 16 * warp;                // the warp's first row in the block
  const int r0 = q0 + rl;                  // ... and in the sequence
  const bf16* q = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* k = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + hk * p.v_sh;

  const Mask mask(p, b, h);
  int k_lo, k_hi;
  mask.tiles(p, min(q0 + kBQ, p.Sq) - 1, &k_lo, &k_hi);

  cp_async_rows<D, kBQ, L::kStride, kThreads>(Qs, q, p.q_ss, q0, p.Sq,
                                              tid);
  if (k_lo < k_hi) {
    cp_async_rows<D, kBK, L::kStride, kThreads>(Ks, k, p.k_ss, k_lo, p.Skv,
                                                tid);
    mask.stage(Bs, k_lo, q0, tid, p);
  }
  cp_async_commit();

  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};            // this thread's part of the row sums

  // Per key tile j: K (and stage j) landed → V's copy (and stage j+1's)
  // starts, S = Q·Kᵀ → V landed → the next K's copy starts, softmax and
  // O += P·V.  Each copy overlaps the other half's products.  A staged
  // mask votes at the second barrier on stage j+1: a tile that no row of
  // the block sees is skipped whole, its K and V never copied.
  bool live = true;                     // the block sees a key of the tile
  for (int k0 = k_lo, jt = 0; k0 < k_hi; k0 += kBK, ++jt) {
    const bool more = k0 + kBK < k_hi;
    float* stage = Bs + (jt & 1) * (L::kBias / 2);
    float* next = Bs + ((jt + 1) & 1) * (L::kBias / 2);
    cp_async_wait<0>();                 // K (and the stage) have landed;
    __syncthreads();                    // every warp is done with V
    if (live)
      cp_async_rows<D, kBK, L::kStride, kThreads>(Vs, v, p.v_ss, k0, p.Skv,
                                                  tid);
    if (more) mask.stage(next, k0 + kBK, q0, tid, p);
    cp_async_commit();
    float s[kNT][4];
    // no row of the warp sees the tile
    const bool dead = __all_sync(
        0xffffffffu,
        !live || r0 >= p.Sq || mask.init(s, stage, k0, r0, rl, g, t, p));
    if (!dead) {
      // S += Q·Kᵀ: one x4 ldmatrix gives the B fragments of two key tiles
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        uint32_t qa[4];
        ldmatrix_x4(qa, Qs + (rl + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                 L::kStride +
                             16 * kk + ((lane >> 4) << 3));
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          uint32_t kb[4];
          ldmatrix_x4(kb, Ks + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) *
                                   L::kStride +
                               16 * kk + (((lane >> 3) & 1) << 3));
          mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
          mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
        }
      }
    }
    cp_async_wait<0>();                 // V (and stage j+1) have landed;
    // every warp is done with K and stage j
    bool next_live = more;
    if constexpr (Mask::kStaged)
      next_live = __syncthreads_or(
          more && mask.any_live(next, k0 + kBK, q0, tid, p));
    else
      __syncthreads();
    if (next_live)
      cp_async_rows<D, kBK, L::kStride, kThreads>(Ks, k, p.k_ss, k0 + kBK,
                                                  p.Skv, tid);
    cp_async_commit();
    live = next_live;
    if (dead) continue;
    mask.apply(s, k0, r0, g, t, p);
    // online softmax on the fragments: rows g (e = 0, 1), g + 8 (e = 2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx((s[j][e] - mx[e >> 1]) * kLog2e);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += P·V: key tiles 2kk and 2kk+1 of S are the A fragment of k step
    // kk; one x4 ldmatrix.trans gives the B fragments of two d tiles
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < kDT / 2; ++jp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + (16 * kk + (lane & 7) +
                                    (((lane >> 3) & 1) << 3)) * L::kStride +
                                  16 * jp + ((lane >> 4) << 3));
        mma_bf16(o[2 * jp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * jp + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  bf16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = r0 + g + 8 * r;
    if (row < p.Sq) {
      lr = lr == 0.f ? 1.f : lr;
      const float inv = 1.f / lr;
      bf16* orow = out + (int64_t)row * p.o_ss + 2 * t;
#pragma unroll
      for (int j = 0; j < kDT; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16x2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      if (t == 0) p.lse[(int64_t)bh * p.Sq + row] = m[r] + logf(lr);
    }
  }
}

template <int D, class Mask>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using L = Layout<D, Mask>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D, Mask><<<grid, kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// the fields both entry points fill alike; strides: q, k, v, o as (batch,
// head, sequence) in elements
__host__ inline Params make_params(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const int64_t* st, int H, int Hkv, int Sq,
                                   int Skv) {
  Params f = {};
  f.q = static_cast<const bf16*>(q);
  f.k = static_cast<const bf16*>(k);
  f.v = static_cast<const bf16*>(v);
  f.o = static_cast<bf16*>(o);
  f.lse = static_cast<float*>(lse);
  f.q_sb = st[0]; f.q_sh = st[1]; f.q_ss = st[2];
  f.k_sb = st[3]; f.k_sh = st[4]; f.k_ss = st[5];
  f.v_sb = st[6]; f.v_sh = st[7]; f.v_ss = st[8];
  f.o_sb = st[9]; f.o_sh = st[10]; f.o_ss = st[11];
  f.H = H; f.Hkv = Hkv; f.Sq = Sq; f.Skv = Skv;
  return f;
}

// The body for head dim D; cudaErrorInvalidValue for another D,
// cudaErrorMisalignedAddress for an operand cp.async cannot copy (the
// wrappers raise before that).
template <class Mask>
cudaError_t run(int D, const Params& p, int B, cudaStream_t s) {
  using p2t::aligned16;
  if (!aligned16(p.q, p.q_sb, p.q_sh, p.q_ss) ||
      !aligned16(p.k, p.k_sb, p.k_sh, p.k_ss) ||
      !aligned16(p.v, p.v_sb, p.v_sh, p.v_ss) ||
      !aligned16(p.o, p.o_sb, p.o_sh, p.o_ss))
    return cudaErrorMisalignedAddress;
  switch (D) {
    case 16: return launch<16, Mask>(p, B, s);
    case 32: return launch<32, Mask>(p, B, s);
    case 64: return launch<64, Mask>(p, B, s);
    case 128: return launch<128, Mask>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fwd
}  // namespace
