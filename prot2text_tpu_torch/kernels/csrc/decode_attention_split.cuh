// The bf16 decode attention whose key columns are split across a
// thread-block cluster: the bf16 route of K2 (decode_attention.cu), K4 and
// K9a (decode_attention_write.cu); their f32 routes keep the SIMT bodies of
// those files.  Two policies make each kernel of the one body:
//   - a column policy names the columns and counts their tiles:
//     `CacheCols` (K2, K4) the slot cache's, `PrefixCols` (K9a) [shared
//     prefix ‖ slot cache];
//   - a write policy: `SlotWrite` (K4, K9a) stores row b's k/v into slot
//     slots[b] after the reads, `NoWrite` (K2) leaves the cache as it is
//     (lockstep generation writes the slot with K3 after the layer loop).
//
// Contract (as the SIMT bodies and the TPU kernels): q pre-scaled, logits
// fp32; masked columns (kv_mask == 0, pmask == 0 for the prefix) take no
// weight and are never read; the current token's k/v are one extra logit
// column; the softmax runs over [prefix ‖ cache ‖ current]; the weights are
// rounded to bf16 before P·V and their sum stays fp32; m starts at -1e30
// and stays finite, so a block whose whole share is masked contributes
// l = 0 and no NaN, and a row with no valid column gives o = v_new.  With
// `SlotWrite`, row b's k/v are then written into slot slots[b] of its own
// (b, kv head) slab, after every read of that slab (a slot whose kv_mask
// is 1 is read as it was before the write).
//
// Bound: bytes.  A call reads each valid cache column of every (b, kv head)
// once (K2 at Llama-3.1-8B's generation shape, B 4, Hkv 8, rep 4, D 128,
// T 1280 with ~1040 valid columns a row: 5.1 us at 3.35 TB/s; K4/K9a at the
// Qwen3-14B serving shape, B 8, Hkv 8, rep 5, T 1936 with ~500-800 valid
// columns a row and, K9a, a 256-column prefix: 5.3-5.6 us) for ~2 FLOP a
// byte.  The SIMT bodies take one block per (b, kv head), 32-64 blocks on
// 132 SMs, and walk all columns in series in chunks of 256 with four
// barriers each, P·V loading one element per column per thread.  So here:
//   - a cluster of kCluster = 4 blocks per (b, kv head), at every shape,
//     splits the column tiles of 64, tile i to block i mod 4; the
//     interleave spreads a row's valid window evenly over the blocks.
//     K4/K9a at B 8, Hkv 8 get 256 blocks, two an SM, each with 3-4 of a
//     serving row's ~14 live tiles.  K2 at B 4, Hkv 8 gets 128 blocks, one
//     an SM; a cluster of 8 there (256 blocks, 2-3 live tiles each)
//     measured slower on the H100 (PERF.md §6; the likely cause, each
//     block's fixed work of q loads, mask scan and merge paid twice as
//     often, is not profiled);
//   - a block first reads the masks of its tiles (every load in flight at
//     once) into a bit set; a tile with no valid column is never copied,
//     and a valid tile's masked columns are zero-filled, never read;
//   - K and V tiles arrive by 16-byte cp.async in a ring of three, two
//     tiles ahead of the one in use;
//   - the products run on the tensor cores from shared memory: warp w takes
//     the tile's keys 16w .. 16w + 15; Sᵀ = K·qᵀ is m16n8k16 with the <= 8
//     query heads of the group as n = 8 (q's B fragments stay in
//     registers); the online softmax runs per warp on the fragments (a
//     head's max over the warp's keys by three shuffles); Pᵀ is rounded to
//     bf16 and turned into B fragments by movmatrix; Oᵀ = Vᵀ·Pᵀ with Vᵀ's A
//     fragments from ldmatrix.trans;
//   - each warp keeps its own (m, l, Oᵀ); the block merges its four warps
//     through shared memory, the leading block (rank 0) folds in the
//     current token's column, and after a cluster barrier block r merges
//     the cluster's partials (in rank order, through distributed shared
//     memory) for head-dim columns [r·D/4, (r+1)·D/4) and writes them: one
//     launch, no scratch;
//   - the slot write (`SlotWrite`) follows that barrier, which follows
//     every block's last read of the slab; a second barrier keeps each
//     block's shared memory alive until the others have read it (K2 needs
//     both barriers too).
// The prefix tiles of a kv head are read by the clusters of all B rows;
// after the first they come from L2 (a layer's prefix is Hkv·Pc·D·2·2
// bytes, 1 MB at Pc 256), the redundancy the TPU kernel avoided by
// fetching the constant-index prefix block once per layer.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace {
namespace split {

namespace cg = cooperative_groups;

using p2t::cp_async16;
using p2t::cp_async_commit;
using p2t::cp_async_wait;
using p2t::exp2_approx;
using p2t::ldmatrix_x4;
using p2t::ldmatrix_x4_trans;
using p2t::mma_bf16;
using p2t::movmatrix_trans;
using p2t::pack_bf16x2;
using p2t::warp_sum;

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCluster = 4;          // blocks per (b, kv head): the rule
constexpr int kBT = 16 * kWarps;     // columns per tile, 16 a warp
constexpr int kStages = 3;           // the copy ring: two tiles ahead
constexpr int kMaxRep = 8;           // query heads per kv head: the mma's n
constexpr int kMaxLocal = 256;       // tiles a block may own
constexpr int kScan = 8;             // mask loads in flight per lane
constexpr float kNegInf = -1e30f;    // the running max's floor
constexpr float kLog2e = 1.4426950408889634f;

// what every kernel of the body reads, and its output
struct Params {
  const bf16* qg;            // (B, Hkv, rep, D), pre-scaled
  const bf16* ck;            // layer slice (B, Hkv, T, D)
  const bf16* cv;
  const int32_t* kv_mask;    // (B, T) 0/1
  const bf16* k_new;         // (B, Hkv, D)
  const bf16* v_new;
  const bf16* pk;            // prefix layer slice (Hkv, Pc, D); PrefixCols
  const bf16* pv;
  const int32_t* pmask;      // (B, Pc) 0/1; PrefixCols
  bf16* out;                 // (B, Hkv, rep, D)
  int Hkv, rep, T_len, Pc;
};

// the C entry points' untyped arguments → Params (pk, pv and pmask may be
// null: CacheCols reads none of them)
inline Params make_params(const void* qg, const void* ck, const void* cv,
                          const void* kv_mask, const void* k_new,
                          const void* v_new, const void* pk, const void* pv,
                          const void* pmask, void* out, int Hkv, int rep,
                          int T_len, int Pc) {
  return {static_cast<const bf16*>(qg), static_cast<const bf16*>(ck),
          static_cast<const bf16*>(cv), static_cast<const int32_t*>(kv_mask),
          static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
          static_cast<const bf16*>(pk), static_cast<const bf16*>(pv),
          static_cast<const int32_t*>(pmask), static_cast<bf16*>(out),
          Hkv, rep, T_len, Pc};
}

// a tile's first key and value rows (row stride D), its mask and its count
// of columns
struct Tile {
  const bf16* k;
  const bf16* v;
  const int32_t* mask;
  int n;
};

// A column policy: `tiles(p)` counts a row's column tiles, `tile<D>(p, b,
// h, i)` gives tile i of row b and kv head h.

// K2, K4: the slot cache's tiles; no prefix pointer is read.
struct CacheCols {
  __host__ __device__ explicit CacheCols(const Params&) {}
  __host__ __device__ int tiles(const Params& p) const {
    return (p.T_len + kBT - 1) / kBT;
  }
  template <int D>
  __device__ Tile tile(const Params& p, int b, int h, int i) const {
    const int c0 = i * kBT;
    const int64_t o = (((int64_t)b * p.Hkv + h) * p.T_len + c0) * D;
    return {p.ck + o, p.cv + o, p.kv_mask + (int64_t)b * p.T_len + c0,
            min(kBT, p.T_len - c0)};
  }
};

// K9a: the prefix's tiles, then the cache's (neither straddles the seam).
struct PrefixCols {
  int nP;                    // prefix tiles

  __host__ __device__ explicit PrefixCols(const Params& p)
      : nP((p.Pc + kBT - 1) / kBT) {}
  __host__ __device__ int tiles(const Params& p) const {
    return nP + CacheCols(p).tiles(p);
  }
  template <int D>
  __device__ Tile tile(const Params& p, int b, int h, int i) const {
    if (i < nP) {
      const int c0 = i * kBT;
      const int64_t o = ((int64_t)h * p.Pc + c0) * D;
      return {p.pk + o, p.pv + o, p.pmask + (int64_t)b * p.Pc + c0,
              min(kBT, p.Pc - c0)};
    }
    return CacheCols(p).tile<D>(p, b, h, i - nP);
  }
};

// A write policy: `write<D>(p, bg, b, rank, tid)` runs after the
// cluster barrier that follows every block's last read of the slab.

// K4, K9a: row b's k/v into slot slots[b] of its own (b, kv head) slab;
// block `rank` writes its head-dim columns.  An out-of-range slot is not
// written (the wrappers' plain versions raise on it; the serving engine
// never produces one).
struct SlotWrite {
  bf16* ck;                  // Params' layer slices, written
  bf16* cv;
  const int32_t* slots;      // (B,)

  template <int D>
  __device__ void write(const Params& p, int bg, int b, int rank,
                        int tid) const {
    constexpr int kCols = D / kCluster;
    const int slot = slots[b];
    if (slot < 0 || slot >= p.T_len) return;
    const int64_t row = ((int64_t)bg * p.T_len + slot) * D;
    for (int i = tid; i < 2 * kCols; i += kThreads) {
      const int d = rank * kCols + (i < kCols ? i : i - kCols);
      if (i < kCols)
        ck[row + d] = p.k_new[(int64_t)bg * D + d];
      else
        cv[row + d] = p.v_new[(int64_t)bg * D + d];
    }
  }
};

// K2: the cache is read-only.
struct NoWrite {
  template <int D>
  __device__ void write(const Params&, int, int, int, int) const {}
};

// tiles rank, rank + kCluster, ... of n: the ones block `rank` owns
__host__ __device__ inline int owned(int n_tiles, int rank) {
  return n_tiles > rank ? (n_tiles - 1 - rank) / kCluster + 1 : 0;
}

template <int D>
struct Layout {
  static constexpr int kStride = D + 8;          // bf16 per staged row
  static constexpr int kTile = kBT * kStride;    // one staged K or V tile
  static constexpr int kOStride = D + 4;         // fp32 per merged O row
  // the ring (bf16), reused after the loop for the warps' partials
  static constexpr size_t kRing = sizeof(bf16) * kStages * 2 * kTile;
  static constexpr size_t kWarpPart =
      sizeof(float) * kWarps * kMaxRep * (kOStride + 2);
  static_assert(kWarpPart <= kRing, "the warps' partials must fit the ring");
  // then the tiles' mask bits, the block's partial (O, m, l) and the
  // current token's logits
  static constexpr size_t kBytes =
      kRing + sizeof(uint2) * kMaxLocal +
      sizeof(float) * (kMaxRep * D + 3 * kMaxRep);
};

// one cluster of kCluster blocks per (b, kv head)
template <int D, class Cols, class Write>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
decode_split_kernel(const Params p, const Write w) {
  static_assert(D % 16 == 0 && D <= 128 && D % kCluster == 0,
                "head_dim in {16, 32, 64, 128}");
  using L = Layout<D>;
  constexpr int kKT = D / 16;            // k steps of Sᵀ; m tiles of Oᵀ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  uint2* bits_s = reinterpret_cast<uint2*>(smem_raw + L::kRing);
  float* bo = reinterpret_cast<float*>(bits_s + kMaxLocal);  // [kMaxRep][D]
  float* bm = bo + kMaxRep * D;
  float* bl = bm + kMaxRep;
  float* snew = bl + kMaxRep;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bg = blockIdx.x / kCluster;  // b * Hkv + kv head
  const int b = bg / p.Hkv;
  const int h = bg - b * p.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Cols cols(p);
  const int n_local = owned(cols.tiles(p), rank);

  // q's B fragments (k = head dim, n = query head g; heads >= rep zero)
  const bf16* q = p.qg + (int64_t)bg * p.rep * D;
  uint32_t qb[kKT][2];
#pragma unroll
  for (int kk = 0; kk < kKT; ++kk) {
    const bool in = g < p.rep;
    const bf16* qr = q + g * D + 16 * kk + 2 * t;
    qb[kk][0] = in ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
    qb[kk][1] = in ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
  }

  // the masks of this block's tiles → 64 bits a tile; warp w reads tiles
  // w, w + 4, ..., kScan of them with their loads in flight together
  for (int j0 = 0; j0 < n_local; j0 += kScan * kWarps) {
    int mv[kScan][2];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int j = j0 + warp + kWarps * u;
      mv[u][0] = mv[u][1] = 0;
      if (j < n_local) {
        const Tile tl = cols.template tile<D>(p, b, h, rank + kCluster * j);
        if (lane < tl.n) mv[u][0] = tl.mask[lane];
        if (lane + 32 < tl.n) mv[u][1] = tl.mask[lane + 32];
      }
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int j = j0 + warp + kWarps * u;
      const unsigned lo = __ballot_sync(0xffffffffu, mv[u][0] != 0);
      const unsigned hi = __ballot_sync(0xffffffffu, mv[u][1] != 0);
      if (j < n_local && lane == 0) bits_s[j] = make_uint2(lo, hi);
    }
  }
  // the current token's logit per head (the leading block only)
  if (rank == 0) {
    const bf16* kn = p.k_new + (int64_t)bg * D;
    for (int hh = warp; hh < kMaxRep; hh += kWarps) {
      float s = 0.f;
      if (hh < p.rep)
        for (int d = lane; d < D; d += 32)
          s = fmaf(__bfloat162float(q[hh * D + d]), __bfloat162float(kn[d]),
                   s);
      s = warp_sum(s);
      if (lane == 0) snew[hh] = s;
    }
  }
  __syncthreads();

  auto live = [&](int j) {
    const uint2 x = bits_s[j];
    return (x.x | x.y) != 0u;
  };
  auto next_live = [&](int j) {
    while (j < n_local && !live(j)) ++j;
    return j;
  };
  // K and V rows of local tile j → ring slot `slot`; masked columns
  // zero-filled, never read
  auto stage = [&](int j, int slot) {
    const Tile tl = cols.template tile<D>(p, b, h, rank + kCluster * j);
    const uint2 x = bits_s[j];
    bf16* ks = ring + slot * 2 * L::kTile;
    bf16* vs = ks + L::kTile;
    constexpr int kChunks = D / 8;
#pragma unroll
    for (int it = 0; it < kBT * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = ((r < 32 ? x.x >> r : x.y >> (r - 32)) & 1u) != 0u;
      const int64_t o = ok ? (int64_t)r * D + 8 * c : 0;
      cp_async16(ks + r * L::kStride + 8 * c, tl.k + o, ok ? 16 : 0);
      cp_async16(vs + r * L::kStride + 8 * c, tl.v + o, ok ? 16 : 0);
    }
  };

  // Oᵀ: tile mt holds (head dim 16mt + g (+8), heads 2t, 2t + 1)
  float o[kKT][4];
#pragma unroll
  for (int mt = 0; mt < kKT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // heads 2t, 2t + 1
  float l[2] = {0.f, 0.f};           // this thread's keys' part of the sums

  int cur = next_live(0);
  int nxt = cur < n_local ? next_live(cur + 1) : n_local;
  if (cur < n_local) stage(cur, 0);
  cp_async_commit();
  if (nxt < n_local) stage(nxt, 1);
  cp_async_commit();
  for (int it = 0; cur < n_local; ++it) {
    const int far = nxt < n_local ? next_live(nxt + 1) : n_local;
    cp_async_wait<1>();                // this tile has landed;
    __syncthreads();                   // every warp is done with slot it - 1
    if (far < n_local) stage(far, (it + 2) % kStages);
    cp_async_commit();
    const bf16* ks = ring + (it % kStages) * 2 * L::kTile;
    const bf16* vs = ks + L::kTile;
    const uint2 x = bits_s[cur];
    // the valid bits of this warp's 16 columns
    const unsigned wb = ((warp < 2 ? x.x : x.y) >> (16 * (warp & 1))) &
                        0xffffu;
    if (wb != 0u) {
      // Sᵀ = K·qᵀ: (key g, heads 2t, 2t + 1), (key g + 8, ...)
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        uint32_t ka[4];
        ldmatrix_x4(ka, ks + (16 * warp + (lane & 7) +
                              (((lane >> 3) & 1) << 3)) * L::kStride +
                            16 * kk + ((lane >> 4) << 3));
        mma_bf16(s, ka, qb[kk][0], qb[kk][1]);
      }
      const float ninf = __uint_as_float(0xff800000u);
      if (!((wb >> g) & 1u)) s[0] = s[1] = ninf;
      if (!((wb >> (g + 8)) & 1u)) s[2] = s[3] = ninf;
      // online softmax per head over the warp's keys: the max across the
      // lanes of one t by three shuffles
      float mx[2] = {fmaxf(s[0], s[2]), fmaxf(s[1], s[3])};
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 4));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 8));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 16));
        const float mn = fmaxf(m[r], mx[r]);
        alpha[r] = exp2_approx((m[r] - mn) * kLog2e);
        m[r] = mn;
        l[r] *= alpha[r];
      }
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[e] = exp2_approx((s[e] - m[e & 1]) * kLog2e);
        l[e & 1] += w[e];
      }
#pragma unroll
      for (int mt = 0; mt < kKT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][e] *= alpha[e & 1];
      // Pᵀ rounded to bf16: (keys × heads) 8x8 blocks → transposed, the B
      // fragments (k = key, n = head) of Oᵀ += Vᵀ·Pᵀ
      const uint32_t b0 = movmatrix_trans(pack_bf16x2(w[0], w[1]));
      const uint32_t b1 = movmatrix_trans(pack_bf16x2(w[2], w[3]));
#pragma unroll
      for (int mt = 0; mt < kKT; ++mt) {
        uint32_t va[4];
        ldmatrix_x4_trans(va, vs + (16 * warp + (lane & 7) +
                                    ((lane >> 4) << 3)) * L::kStride +
                                  16 * mt + (((lane >> 3) & 1) << 3));
        mma_bf16(o[mt], va, b0, b1);
      }
    }
    cur = nxt;
    nxt = far;
  }
  cp_async_wait<0>();

  // the warp's sums over its keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 4);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 8);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 16);
  }
  __syncthreads();                     // every warp is done with the ring
  float* wo = reinterpret_cast<float*>(ring);   // [kWarps][kMaxRep][kOStride]
  float* wm = wo + kWarps * kMaxRep * L::kOStride;
  float* wl = wm + kWarps * kMaxRep;
#pragma unroll
  for (int mt = 0; mt < kKT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wo[(warp * kMaxRep + 2 * t + (e & 1)) * L::kOStride + 16 * mt + g +
         8 * (e >> 1)] = o[mt][e];
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wm[warp * kMaxRep + 2 * t + r] = m[r];
      wl[warp * kMaxRep + 2 * t + r] = l[r];
    }
  }
  __syncthreads();
  // the block's partial; the leading block folds in the current token
  const bf16* vn = p.v_new + (int64_t)bg * D;
  for (int i = tid; i < kMaxRep * D; i += kThreads) {
    const int hh = i / D, d = i - hh * D;
    float mb = wm[hh];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mb = fmaxf(mb, wm[w * kMaxRep + hh]);
    float lb = 0.f, ob = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2_approx((wm[w * kMaxRep + hh] - mb) * kLog2e);
      lb = fmaf(wl[w * kMaxRep + hh], a, lb);
      ob = fmaf(wo[(w * kMaxRep + hh) * L::kOStride + d], a, ob);
    }
    if (rank == 0) {
      const float sn = snew[hh];
      const float mn = fmaxf(mb, sn);
      const float a = exp2_approx((mb - mn) * kLog2e);
      const float an = exp2_approx((sn - mn) * kLog2e);
      lb = fmaf(lb, a, an);
      ob = fmaf(ob, a, an * __bfloat162float(vn[d]));
      mb = mn;
    }
    bo[hh * D + d] = ob;
    if (d == 0) {
      bm[hh] = mb;
      bl[hh] = lb;
    }
  }
  // every block's partial is in place, and every read of the slab is done
  cluster.sync();

  // block `rank` merges head-dim columns [rank·kCols, (rank+1)·kCols) of
  // every head over the blocks in rank order
  constexpr int kCols = D / kCluster;
  for (int i = tid; i < p.rep * kCols; i += kThreads) {
    const int hh = i / kCols, d = rank * kCols + i % kCols;
    float mr[kCluster], lr[kCluster], orr[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      mr[r] = *cluster.map_shared_rank(bm + hh, r);
      lr[r] = *cluster.map_shared_rank(bl + hh, r);
      orr[r] = *cluster.map_shared_rank(bo + hh * D + d, r);
    }
    float mx = mr[0];
#pragma unroll
    for (int r = 1; r < kCluster; ++r) mx = fmaxf(mx, mr[r]);
    float lt = 0.f, ot = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float a = exp2_approx((mr[r] - mx) * kLog2e);
      lt = fmaf(lr[r], a, lt);
      ot = fmaf(orr[r], a, ot);
    }
    p.out[((int64_t)bg * p.rep + hh) * D + d] = __float2bfloat16(ot / lt);
  }
  // every block's last read of the slab preceded the barrier
  w.template write<D>(p, bg, b, rank, tid);
  cluster.sync();                    // no block leaves while others read it
}

template <int D, class Cols, class Write>
cudaError_t launch(const Params& p, const Write& w, int B,
                   cudaStream_t stream) {
  using L = Layout<D>;
  cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<D, Cols, Write>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (e != cudaSuccess) return e;
  decode_split_kernel<D, Cols, Write>
      <<<B * p.Hkv * kCluster, kThreads, L::kBytes, stream>>>(p, w);
  return cudaGetLastError();
}

// The body for head dim D; cudaErrorInvalidValue for another D, more than
// kMaxRep query heads or more tiles than a block may own,
// cudaErrorMisalignedAddress for a slab cp.async cannot copy (the wrapper
// raises before that).
template <class Cols, class Write>
cudaError_t run(int D, const Params& p, const Write& w, int B,
                cudaStream_t s) {
  if (p.rep > kMaxRep || owned(Cols(p).tiles(p), 0) > kMaxLocal)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(p.ck) | reinterpret_cast<uintptr_t>(p.cv) |
       reinterpret_cast<uintptr_t>(p.pk) | reinterpret_cast<uintptr_t>(p.pv)) &
      15)
    return cudaErrorMisalignedAddress;
  switch (D) {
    case 16: return launch<16, Cols>(p, w, B, s);
    case 32: return launch<32, Cols>(p, w, B, s);
    case 64: return launch<64, Cols>(p, w, B, s);
    case 128: return launch<128, Cols>(p, w, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace split
}  // namespace
