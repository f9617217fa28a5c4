// The bf16 masked flash-attention backward on the tensor cores: K5's bf16
// route (flash_attention_bwd.cu keeps the SIMT body for f32, which the
// legacy full fine-tune computes in full fp32).  The backward twin of the
// forward body in flash_attention_fwd.cuh, with a mask policy (`RunMask`
// below: K5's key runs, causal) so that K6b can take it with a bias policy.
//
// Contract (as the SIMT body and the TPU kernel): P = exp(Q·Kᵀ - lse),
// masked EXPLICITLY (an empty row carries lse = -1e30 and must give exactly
// zero gradients); Δ = rowsum(dO∘O) comes from the wrapper; dS = P∘(dP - Δ)
// with dP = dO·Vᵀ; dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO, summed over each GQA
// group for dK/dV; q pre-scaled.  Numerics: the five products run on bf16
// tensor cores with fp32 accumulators, so P and dS are rounded to bf16
// where they enter dV, dK and dQ (the TPU kernel multiplies them in fp32);
// P, dS, their masks and Δ stay fp32.  q/k/v/dO are strided (transposes of
// (B, S, H, D) buffers) with every base and stride 16-byte aligned (cp.async
// copies 16 bytes; the wrapper copies a dO that is not).
//
// Bound: at the Qwen3-14B training shape (B 1, H 40, Hkv 8, S 1280, D 128,
// causal, kv_start > 0 and a padded tail) the five products of the causal
// half are ~40 GFLOP: 40 us at 989 TFLOP/s bf16 against ~15 us of bytes, so
// operations.  The SIMT body ran them as fp32 FMAs (67 TFLOP/s at best) on
// fp32 copies of every tile.  So here:
//   - two kernels, dQ then dK/dV, and no atomics: S and dP are recomputed
//     in both (seven products instead of five), and in exchange every sum
//     has a fixed order, so two launches give identical bits;
//   - a block of 4 warps owns 64 rows, 16 a warp (dQ: query rows; dK/dV:
//     key rows), and walks the tiles of 64 on the other side; every product
//     is mma.sync m16n8k16 with A and B fragments read by ldmatrix(.trans)
//     from bf16 tiles in shared memory (rows padded by 16 bytes, free of
//     bank conflicts); S, dP, P and dS live in registers, and P/dS are
//     repacked from the accumulator layout straight into A fragments;
//   - the walked tiles arrive by cp.async double-buffered, the next tile's
//     copy under this tile's products;
//   - the dK/dV grid: one block per (batch, kv head, 64-key tile) walking
//     rep query heads × up to S/64 query tiles was B·Hkv·S/64 = 160 blocks
//     at the training shape (1.2 waves on 132 SMs, the heaviest causal
//     block walking 100 tiles in series).  The rep heads of a key tile are
//     split across the blocks of a thread-block cluster (up to 8; a block
//     takes heads rank, rank + C, ...): 800 blocks there, 20 tiles on the
//     longest path.  Of the two ways to sum the heads' partials (fp32
//     partials in global scratch summed in a fixed order, or smaller key
//     tiles) this takes the first with the scratch in shared memory: each
//     block leaves its fp32 dK/dV partial in its own shared memory, and
//     after a cluster barrier block r sums a share of the elements over
//     ranks 0 .. C-1 in that order through distributed shared memory.  A
//     global scratch would move 2·B·H·S·D·4 bytes (52 MB at the training
//     shape, more than the bytes of the whole backward) and need a launch
//     more; smaller key tiles would still leave the rep heads in series;
//   - tiles that no row sees are skipped (outside the run, above the
//     diagonal), per block and per warp; the heaviest tiles run first (dQ:
//     the last query tiles; dK/dV: the first key tiles), by grid order;
//   - registers are capped for two blocks an SM at D 128 (the shared
//     memory allows two), three below.
// wgmma + TMA with warp specialisation is the follow-up.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace {
namespace bwd {

namespace cg = cooperative_groups;

using p2t::cp_async4;
using p2t::cp_async_commit;
using p2t::cp_async_rows;
using p2t::cp_async_wait;
using p2t::exp2_approx;
using p2t::ldmatrix_x4;
using p2t::ldmatrix_x4_trans;
using p2t::mma_bf16;
using p2t::pack_bf16x2;

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 64;               // query rows per tile
constexpr int kBK = 64;               // key rows per tile
constexpr int kMaxCluster = 8;        // portable cluster size
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;      // (B, H, Sq) contiguous
  const float* delta;    // (B, H, Sq) contiguous, rowsum(dO∘O)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  // element strides (batch, head, sequence); the head dim is contiguous
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  int H, Hkv, Sq, Skv;
  // RunMask
  const int32_t* kv_start;
  const int32_t* kv_len;
  int causal;
};

// K5: the keys of batch row b are [kv_start[b], kv_start[b] + kv_len[b])
// within [0, Skv), and with `causal` also col <= row (sequence index).
struct RunMask {
  int start, end, causal, Sq;

  __device__ RunMask(const Params& p, int b)
      : start(max(p.kv_start[b], 0)),
        end(min(p.kv_start[b] + p.kv_len[b], p.Skv)), causal(p.causal),
        Sq(p.Sq) {}
  // the key tiles a query tile (last row q_last) reaches: [lo, hi), lo a
  // multiple of kBK
  __device__ void key_tiles(int q_last, int* lo, int* hi) const {
    *lo = start / kBK * kBK;
    *hi = causal ? min(end, q_last + 1) : end;
  }
  // the first query row that sees a key at or after k0
  __device__ int first_row(int k0) const {
    return causal ? max(k0, start) : 0;
  }
  // key rows [k0, k0 + n) hold no visible key
  __device__ bool dead_keys(int k0, int n) const {
    return k0 >= end || k0 + n <= start;
  }
  // no query row of [r0, r0 + nr) sees a key of [c0, c0 + nc)
  __device__ bool dead(int r0, int nr, int c0, int nc) const {
    return r0 >= Sq || dead_keys(c0, nc) || (causal && c0 > r0 + nr - 1);
  }
  // every (row, col) of the block is visible
  __device__ bool full(int r0, int nr, int c0, int nc) const {
    return r0 + nr <= Sq && c0 >= start && c0 + nc <= end &&
           (!causal || c0 + nc - 1 <= r0);
  }
  __device__ bool visible(int row, int col) const {
    return row < Sq && col >= start && col < end && (!causal || col <= row);
  }
};

template <int D>
struct Smem {
  static constexpr int kStride = D + 8;       // bf16 per staged row (+16 B)
  static constexpr int kTile = 64 * kStride;  // one staged 64-row tile
  // dQ: Q, dO, then K and V twice; dK/dV: K, V, then Q and dO twice, and
  // lse and Δ twice
  static constexpr size_t kDq = sizeof(bf16) * 6 * kTile;
  static constexpr size_t kDkv = kDq + sizeof(float) * 4 * kBQ;
  // dK/dV's exchange: fp32 [2][kBK][kAccStride] over the Q/dO stages
  static constexpr int kAccStride = D + 8;
  static_assert(sizeof(float) * 2 * kBK * kAccStride <=
                    sizeof(bf16) * 4 * kTile,
                "the exchange must fit the Q/dO stages");
  static constexpr int kMinBlocks = D >= 128 ? 2 : 3;
};

// dQ: one block per (batch·head, 64-row query tile), the last tiles first;
// warp w owns rows q0 + 16w .. q0 + 16w + 15 and walks the key tiles.
template <int D, class Mask>
__global__ void __launch_bounds__(kThreads, Smem<D>::kMinBlocks)
flash_masked_bwd_dq_mma_kernel(const Params p) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim in {16, 32, 64, 128}");
  using S = Smem<D>;
  constexpr int kKT = D / 16;     // k steps over the head dim
  constexpr int kNT = kBK / 8;    // S / dP accumulator tiles per warp
  constexpr int kDT = D / 8;      // dQ accumulator tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + S::kTile;
  bf16* KV = dOs + S::kTile;      // [2 stages][K, V]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int rl = 16 * warp;
  const int r0 = q0 + rl;
  const bf16* q = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* dout = p.dout + b * p.do_sb + h * p.do_sh;
  const bf16* k = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + hk * p.v_sh;

  const Mask mask(p, b);
  int k_lo, k_hi;
  mask.key_tiles(min(q0 + kBQ, p.Sq) - 1, &k_lo, &k_hi);

  cp_async_rows<D, kBQ, S::kStride, kThreads>(Qs, q, p.q_ss, q0, p.Sq, tid);
  cp_async_rows<D, kBQ, S::kStride, kThreads>(dOs, dout, p.do_ss, q0, p.Sq,
                                              tid);
  if (k_lo < k_hi) {
    cp_async_rows<D, kBK, S::kStride, kThreads>(KV, k, p.k_ss, k_lo, p.Skv,
                                                tid);
    cp_async_rows<D, kBK, S::kStride, kThreads>(KV + S::kTile, v, p.v_ss,
                                                k_lo, p.Skv, tid);
  }
  cp_async_commit();

  // lse and Δ of this thread's rows r0 + g and r0 + g + 8
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const bool in = row < p.Sq;
    lse[r] = in ? p.lse[(int64_t)bh * p.Sq + row] : 0.f;
    dlt[r] = in ? p.delta[(int64_t)bh * p.Sq + row] : 0.f;
  }
  float dq[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int k0 = k_lo, it = 0; k0 < k_hi; k0 += kBK, ++it) {
    const bf16* Ks = KV + (it & 1) * 2 * S::kTile;
    const bf16* Vs = Ks + S::kTile;
    cp_async_wait<0>();           // this tile has landed;
    __syncthreads();              // every warp is done with the other stage
    if (k0 + kBK < k_hi) {
      bf16* nk = KV + ((it + 1) & 1) * 2 * S::kTile;
      cp_async_rows<D, kBK, S::kStride, kThreads>(nk, k, p.k_ss, k0 + kBK,
                                                  p.Skv, tid);
      cp_async_rows<D, kBK, S::kStride, kThreads>(nk + S::kTile, v, p.v_ss,
                                                  k0 + kBK, p.Skv, tid);
    }
    cp_async_commit();
    if (mask.dead(r0, 16, k0, kBK)) continue;     // warp-uniform

    // S = Q·Kᵀ and dP = dO·Vᵀ: one x4 ldmatrix gives the B fragments of
    // two key tiles
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      const int a_off = (rl + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                            S::kStride + 16 * kk + ((lane >> 4) << 3);
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, Qs + a_off);
      ldmatrix_x4(da, dOs + a_off);
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        const int b_off = (16 * jp + (lane & 7) + ((lane >> 4) << 3)) *
                              S::kStride + 16 * kk + (((lane >> 3) & 1) << 3);
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, Ks + b_off);
        ldmatrix_x4(vb, Vs + b_off);
        mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * jp], da, vb[0], vb[1]);
        mma_bf16(dp[2 * jp + 1], da, vb[2], vb[3]);
      }
    }
    // P = exp(S - lse), 0 where not visible; dS = P∘(dP - Δ) into s
    const bool full = mask.full(r0, 16, k0, kBK);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pr = exp2_approx((s[j][e] - lse[r]) * kLog2e);
        if (!full &&
            !mask.visible(r0 + g + 8 * r, k0 + 8 * j + 2 * t + (e & 1)))
          pr = 0.f;
        s[j][e] = pr * (dp[j][e] - dlt[r]);
      }
    // dQ += dS·K: key tiles 2kk, 2kk+1 of dS are the A fragment of k step
    // kk; one x4 ldmatrix.trans gives the B fragments of two d tiles
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < kDT / 2; ++jp) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, Ks + (16 * kk + (lane & 7) +
                                    (((lane >> 3) & 1) << 3)) * S::kStride +
                                  16 * jp + ((lane >> 4) << 3));
        mma_bf16(dq[2 * jp], a, kb[0], kb[1]);
        mma_bf16(dq[2 * jp + 1], a, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait<0>();

  bf16* out = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < p.Sq) {
      bf16* orow = out + (int64_t)row * p.dq_ss + 2 * t;
#pragma unroll
      for (int j = 0; j < kDT; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16x2(dq[j][2 * r], dq[j][2 * r + 1]);
    }
  }
}

// dK, dV: grid (C, B·Hkv, key tiles), clusters of the C blocks of one key
// tile, the first key tiles first.  Block `rank` takes the query heads
// rank, rank + C, ... of the group; warp w owns key rows k0 + 16w ..
// k0 + 16w + 15 and walks (head, query tile) pairs, each query tile in two
// halves of 32 rows (so S and dP take 32 registers, beside dK's and dV's
// 2·D/2).  Then the cluster sums the blocks' partials in rank order.
template <int D, class Mask>
__global__ void __launch_bounds__(kThreads, Smem<D>::kMinBlocks)
flash_masked_bwd_dkv_mma_kernel(const Params p) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim in {16, 32, 64, 128}");
  using S = Smem<D>;
  constexpr int kKT = D / 16;
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + S::kTile;
  bf16* QD = Vs + S::kTile;                     // [2 stages][Q, dO]
  float* LD = reinterpret_cast<float*>(QD + 4 * S::kTile);  // [2][lse, Δ]

  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;
  const int rank = blockIdx.x;                  // == cluster.block_rank()
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / p.Hkv;
  const int hk = blockIdx.y - b * p.Hkv;
  const int rep = p.H / p.Hkv;
  const int k0 = blockIdx.z * kBK;
  const int kw = k0 + 16 * warp;                // the warp's first key row
  const bf16* k = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + hk * p.v_sh;

  const Mask mask(p, b);
  // block-uniform: the tile holds a visible key, and the query tiles from
  // q_begin on can see it
  const bool active = !mask.dead_keys(k0, kBK);
  const int q_begin = active ? mask.first_row(k0) / kBQ * kBQ : p.Sq;
  const int nqt = q_begin < p.Sq ? (p.Sq - q_begin + kBQ - 1) / kBQ : 0;
  const int nheads = rank < rep ? (rep - 1 - rank) / C + 1 : 0;
  const int n_it = nqt * nheads;                // (head, query tile) pairs

  // pair i → its head and first query row, staged into buffer i & 1
  auto stage = [&](int i) {
    const int h = hk * rep + rank + C * (i / nqt);
    const int qt0 = q_begin + (i % nqt) * kBQ;
    bf16* qs = QD + (i & 1) * 2 * S::kTile;
    cp_async_rows<D, kBQ, S::kStride, kThreads>(
        qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, qt0, p.Sq, tid);
    cp_async_rows<D, kBQ, S::kStride, kThreads>(
        qs + S::kTile, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, qt0,
        p.Sq, tid);
    // lse and Δ of the tile's rows, 4 bytes a thread (rows past Sq: 0)
    static_assert(2 * kBQ == kThreads, "one lse/Δ value a thread");
    const int row = qt0 + (tid & (kBQ - 1));
    const float* src = (tid < kBQ ? p.lse : p.delta) +
                       (int64_t)(b * p.H + h) * p.Sq;
    cp_async4(LD + (i & 1) * 2 * kBQ + tid, row < p.Sq ? src + row : src,
              row < p.Sq ? 4 : 0);
  };

  if (active) {
    cp_async_rows<D, kBK, S::kStride, kThreads>(Ks, k, p.k_ss, k0, p.Skv,
                                                tid);
    cp_async_rows<D, kBK, S::kStride, kThreads>(Vs, v, p.v_ss, k0, p.Skv,
                                                tid);
  }
  if (n_it > 0) stage(0);
  cp_async_commit();

  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const bool warp_dead = mask.dead_keys(kw, 16);

  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<0>();           // this pair's tiles have landed;
    __syncthreads();              // every warp is done with the other stage
    if (i + 1 < n_it) stage(i + 1);
    cp_async_commit();
    if (warp_dead) continue;      // warp-uniform
    const int qt0 = q_begin + (i % nqt) * kBQ;
    const bf16* Qs = QD + (i & 1) * 2 * S::kTile;
    const bf16* dOs = Qs + S::kTile;
    const float* lse = LD + (i & 1) * 2 * kBQ;
    const float* dlt = lse + kBQ;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qh = 32 * half;                 // the half's first row
      const int qa0 = qt0 + qh;
      if (mask.dead(qa0, 32, kw, 16)) continue;
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: rows the warp's 16 keys, columns the
      // half's 32 queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const int a_off = (16 * warp + (lane & 7) +
                           (((lane >> 3) & 1) << 3)) * S::kStride +
                          16 * kk + ((lane >> 4) << 3);
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, Ks + a_off);
        ldmatrix_x4(va, Vs + a_off);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int b_off = (qh + 16 * jp + (lane & 7) + ((lane >> 4) << 3)) *
                                S::kStride +
                            16 * kk + (((lane >> 3) & 1) << 3);
          uint32_t qb[4], ob[4];
          ldmatrix_x4(qb, Qs + b_off);
          ldmatrix_x4(ob, dOs + b_off);
          mma_bf16(s[2 * jp], ka, qb[0], qb[1]);
          mma_bf16(s[2 * jp + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[2 * jp], va, ob[0], ob[1]);
          mma_bf16(dp[2 * jp + 1], va, ob[2], ob[3]);
        }
      }
      // Pᵀ into s, dSᵀ into dp: element e of tile j is key kw + g + 8(e>>1),
      // query qa0 + 8j + 2t + (e&1)
      const bool full = mask.full(qa0, 32, kw, 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse + qh + 8 * j + 2 * t);
        const float2 d2 =
            *reinterpret_cast<const float2*>(dlt + qh + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = (e & 1) ? l2.y : l2.x;
          const float dv_ = (e & 1) ? d2.y : d2.x;
          float pr = exp2_approx((s[j][e] - lv) * kLog2e);
          if (!full && !mask.visible(qa0 + 8 * j + 2 * t + (e & 1),
                                     kw + g + 8 * (e >> 1)))
            pr = 0.f;
          s[j][e] = pr;
          dp[j][e] = pr * (dp[j][e] - dv_);
        }
      }
      // dV += Pᵀ·dO and dK += dSᵀ·Q over the half's two k steps
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        sa[0] = pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
        sa[1] = pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
        sa[2] = pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        sa[3] = pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int jp = 0; jp < kDT / 2; ++jp) {
          const int b_off = (qh + 16 * kk + (lane & 7) +
                             (((lane >> 3) & 1) << 3)) * S::kStride +
                            16 * jp + ((lane >> 4) << 3);
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, dOs + b_off);
          ldmatrix_x4_trans(qb, Qs + b_off);
          mma_bf16(dv[2 * jp], pa, ob[0], ob[1]);
          mma_bf16(dv[2 * jp + 1], pa, ob[2], ob[3]);
          mma_bf16(dk[2 * jp], sa, qb[0], qb[1]);
          mma_bf16(dk[2 * jp + 1], sa, qb[2], qb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                // every warp is done with the stages

  // this block's partial → fp32 [dK, dV][kBK][kAccStride] over the stages
  float* xs = reinterpret_cast<float*>(QD);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      *reinterpret_cast<float2*>(xs + row * S::kAccStride + 8 * j + 2 * t) =
          make_float2(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<float2*>(xs + (kBK + row) * S::kAccStride + 8 * j +
                                 2 * t) =
          make_float2(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
  cluster.sync();                 // every block's partial is in place

  // block `rank` sums every C-th run of kThreads float4s over the ranks in
  // order 0 .. C-1 and stores them as bf16
  constexpr int kPer = D / 4;                   // float4s per row
  bf16* dk_out = p.dk + b * p.dk_sb + hk * p.dk_sh;
  bf16* dv_out = p.dv + b * p.dv_sb + hk * p.dv_sh;
  for (int i = rank * kThreads + tid; i < 2 * kBK * kPer;
       i += C * kThreads) {
    const int xr = i / kPer, c = 4 * (i % kPer);
    float* src = xs + xr * S::kAccStride + c;
    float4 acc =
        *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, 0));
    for (int r = 1; r < C; ++r) {
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, r));
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int row = k0 + (xr & (kBK - 1));
    if (row < p.Skv) {
      bf16* dst = (xr < kBK ? dk_out + (int64_t)row * p.dk_ss
                            : dv_out + (int64_t)row * p.dv_ss) + c;
      uint2 w;
      w.x = pack_bf16x2(acc.x, acc.y);
      w.y = pack_bf16x2(acc.z, acc.w);
      *reinterpret_cast<uint2*>(dst) = w;
    }
  }
  cluster.sync();                 // no block leaves while others read it
}

template <int D, class Mask>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using S = Smem<D>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_masked_bwd_dq_mma_kernel<D, Mask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kDq);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_masked_bwd_dkv_mma_kernel<D, Mask>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)S::kDkv);
  if (e != cudaSuccess) return e;
  const dim3 grid_dq(B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_masked_bwd_dq_mma_kernel<D, Mask>
      <<<grid_dq, kThreads, S::kDq, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int C = min(p.H / p.Hkv, kMaxCluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B * p.Hkv, (p.Skv + kBK - 1) / kBK);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = S::kDkv;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_masked_bwd_dkv_mma_kernel<D, Mask>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The body for head dim D; cudaErrorInvalidValue for another D,
// cudaErrorMisalignedAddress for an operand cp.async cannot copy (the
// wrapper copies dO and raises on q/k/v before that).
template <class Mask>
cudaError_t run(int D, const Params& p, int B, cudaStream_t s) {
  using p2t::aligned16;
  if (!aligned16(p.q, p.q_sb, p.q_sh, p.q_ss) ||
      !aligned16(p.k, p.k_sb, p.k_sh, p.k_ss) ||
      !aligned16(p.v, p.v_sb, p.v_sh, p.v_ss) ||
      !aligned16(p.dout, p.do_sb, p.do_sh, p.do_ss) ||
      !aligned16(p.dk, p.dk_sb, p.dk_sh, p.dk_ss) ||
      !aligned16(p.dv, p.dv_sb, p.dv_sh, p.dv_ss) ||
      (reinterpret_cast<uintptr_t>(p.dq) & 3) || ((p.dq_sb | p.dq_sh |
                                                   p.dq_ss) & 1))
    return cudaErrorMisalignedAddress;
  switch (D) {
    case 16: return launch<16, Mask>(p, B, s);
    case 32: return launch<32, Mask>(p, B, s);
    case 64: return launch<64, Mask>(p, B, s);
    case 128: return launch<128, Mask>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd
}  // namespace
