// The decode attention whose key columns are split across a thread-block
// cluster: the bf16 route of K2 (decode_attention.cu), K4 and K9a
// (decode_attention_write.cu), and the bf16 route, up to kMaxRows query
// rows, of K7 and K9b (decode_attention_write_q.cu) and K8 and K9c
// (decode_attention_verify.cu) over the int8 pool; f32 q, and an int8
// call past kMaxRows rows, are the only users of the SIMT bodies of those
// files (decode_attention_q.cuh for the int8 ones).  Three policies make
// each kernel of the one body:
//   - a column policy names the columns and counts their tiles:
//     `CacheCols` (K2, K4, K7, K8) the slot cache's, `PrefixCols` (K9a,
//     K9b, K9c) [shared prefix ‖ slot cache];
//   - an element policy: `Bf16Cache` (K2, K4, K9a) bf16 tiles and one bf16
//     current column; `Int8Cache` (K7, K8, K9b, K9c) int8 tiles with
//     per-column fp32 k and v scales, and G current columns (a verify
//     chunk; G = 1 for K7/K9b) as exact-integer fp32 rows with their
//     scales;
//   - a write policy: `SlotWrite` (K4, K9a) stores row b's bf16 k/v into
//     slot slots[b] after the reads, `ChunkWrite` (K7, K8, K9b, K9c) the G
//     int8 k/v rows and their scales at [slots[b], slots[b] + G),
//     `NoWrite` (K2) leaves the cache as it is (lockstep generation writes
//     the slot with K3 after the layer loop).
//
// Contract (as the SIMT bodies and the TPU kernels): q pre-scaled, logits
// fp32; a block holds all `rows` query rows of its kv head (K2/K4/K9a: the
// rep heads; K7-K9c: G·rep, row g·rep + r = chunk token g, replica r);
// masked columns (kv_mask == 0, pmask == 0 for the prefix) take no weight
// and are never read; the current columns are extra logit columns, chunk
// column g visible to row i when g <= i / rep; the softmax runs over
// [prefix ‖ cache ‖ current]; the weights are rounded to bf16 before P·V
// and their sum stays fp32; m starts at -1e30 and stays finite, so a block
// whose whole share is masked contributes l = 0 and no NaN, and a row with
// no valid column gives the current columns' mix.  Int8Cache adds the TPU
// kernels' rounding points (`_kernel_write_q[_p]`, `_kernel_verify_qc[_p]`):
// int8 → bf16 is exact, so the products are the bf16 ones; a column's
// logit is the fp32 q·k_int times its k scale, per key after the product;
// its weight times its v scale is rounded to bf16 before it meets v_int;
// the current columns stay fp32 (K7/K9b: q·(kq·ks), dequantized first;
// K8/K9c: (q·kq)·ks), their weights times vs meet vq unrounded.  The write
// policy runs after every read of its (b, kv head) slab (a slot whose
// kv_mask is 1 is read as it was before the write); inactive rows may
// share a scratch slot, since each row owns its slab.
//
// Bound: bytes.  A call reads each valid cache column of every (b, kv head)
// once (K2 at Llama-3.1-8B's generation shape, B 4, Hkv 8, rep 4, D 128,
// T 1280 with ~1040 valid columns a row: 5.1 us at 3.35 TB/s; K4/K9a at the
// Qwen3-14B serving shape, B 8, Hkv 8, rep 5, T 1936 with ~500-800 valid
// columns a row and, K9a, a 256-column prefix: 5.3-5.6 us; K7/K8 on the
// int8 pool, T 1856, 535 valid columns, half the bytes and 8 of scales a
// column: 2.8 and 3.1 us, K9b/K9c with the prefix 2.9 and 3.2 us) for ~2
// FLOP a byte a query row (K8/K9c: 25 rows).
// The SIMT bodies take one block per (b, kv head[, 8 query rows]), 64
// blocks on 132 SMs at the serving shape (K9c: 4 row tiles, each reading
// the slab again), and walk all columns in series in chunks of 256 with
// four barriers each, q·k and P·V on fp32 FMAs.  So here:
//   - a cluster of kCluster = 4 blocks per (b, kv head), at every shape,
//     splits the column tiles of 64, tile i to block i mod 4; the
//     interleave spreads a row's valid window evenly over the blocks.  At
//     B 8, Hkv 8: 256 blocks, two an SM, each with 3-4 of a serving row's
//     ~14 live tiles.  K2 at B 4, Hkv 8 gets 128 blocks, one an SM; a
//     cluster of 8 there (256 blocks, 2-3 live tiles each) measured slower
//     on the H100 (PERF.md §6; the likely cause, each block's fixed work of
//     q loads, mask scan and merge paid twice as often, is not profiled);
//   - a block first reads the masks of its tiles (every load in flight at
//     once) into a bit set; a tile with no valid column is never copied,
//     and a valid tile's masked columns are zero-filled, never read;
//   - tiles arrive by cp.async in a ring, E::kStages - 1 tiles ahead of the
//     one in use: bf16 K and V rows by 16 bytes (three stages); int8 K and
//     V rows by 16 bytes and each column's two scales by 4 (two stages).
//     Int8Cache then converts the tile in use into bf16 K and V tiles in
//     shared memory (exact: the byte in the fp32 2^23 + u, one add), one
//     pass of all threads between two block barriers, so the products
//     below read bf16 tiles either way.  The int8 ring is two stages deep
//     so that a block stays under 76 KB of shared memory: three blocks an
//     SM, and the H100 holds 92 clusters of 4 of either column policy
//     (cudaOccupancyMaxActiveClusters, scripts/sweep_decode_split.py), all
//     64 of the serving shape at once.  Deeper rings (106-110 KB) fit two
//     blocks an SM, fewer than 64 clusters, and two ran as a second wave
//     (PERF.md §6); the bf16 body's 111 KB holds 62 (K4, K9a at B 8,
//     Hkv 8);
//   - the products run on the tensor cores (mma.sync m16n8k16) from shared
//     memory, the query rows in NF = rows / 8 (rounded up to 1, 2 or 4) n8
//     fragments: warp w takes fragment w mod NF and the tile's keys
//     16·NF·(w / NF) .. + 16·NF - 1, so each warp keeps one fragment's Oᵀ
//     at every NF (K9c's 25 rows: NF 4, every warp all 64 keys of its 8
//     rows; K9b's 5: NF 1, 16 keys each) and the block's products are
//     never repeated.  Sᵀ = K·qᵀ, q's B fragments in registers; Int8Cache
//     scales Sᵀ per key by sk; the online softmax runs per warp on the
//     fragments (a row's max over the warp's keys by three shuffles); Pᵀ
//     (Int8Cache: times sv per key) is rounded to bf16 and turned into B
//     fragments by movmatrix; Oᵀ = Vᵀ·Pᵀ with Vᵀ's A fragments from
//     ldmatrix.trans;
//   - each warp keeps its own (m, l, Oᵀ); the block merges the warps that
//     share a fragment through shared memory, the folding block folds in
//     the current columns (rank 0 for Bf16Cache, so K2/K4/K9a keep their
//     bits; for Int8Cache the last rank, which owns the fewest tiles: the
//     chunk's logits and fold no longer wait on the busiest block), and
//     after a cluster barrier block r
//     merges the cluster's partials (in rank order, through distributed
//     shared memory, so two launches are bit-identical) for head-dim
//     columns [r·D/4, (r+1)·D/4) and writes them: one launch, no scratch;
//   - the write policy follows that barrier, which follows every block's
//     last read of the slab; a second barrier keeps each block's shared
//     memory alive until the others have read it (K2 needs both too).
// Registers (ptxas -v on sm_90a, no spills; chip_smoke.py logs every
// instantiation): at D 128 Bf16Cache 128, Int8Cache 96 at NF 1 and 128 at
// NF 2 and 4; each warp holds one fragment's Oᵀ (32 fp32) at every NF.
// The prefix tiles of a kv head are read by the clusters of all B rows;
// after the first they come from L2 (a layer's bf16 prefix is Hkv·Pc·D·2·2
// bytes, 1 MB at Pc 256; int8 half that), the redundancy the TPU kernel
// avoided by fetching the constant-index prefix block once per layer.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace {
namespace split {

namespace cg = cooperative_groups;

using p2t::cp_async16;
using p2t::cp_async4;
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
constexpr int kBT = 16 * kWarps;     // columns per tile, 16 a warp at NF 1
constexpr int kFrag = 8;             // query rows per n8 fragment
constexpr int kMaxRows = 4 * kFrag;  // query rows a block holds (NF <= 4)
constexpr int kMaxLocal = 256;       // tiles a block may own
constexpr int kScan = 8;             // mask loads in flight per lane
constexpr float kNegInf = -1e30f;    // the running max's floor
constexpr float kLog2e = 1.4426950408889634f;

// what every kernel of the body reads, and its output; T is the cache's
// element (bf16 or int8_t)
template <class T>
struct Params {
  const bf16* qg;            // (B, Hkv, rows, D), pre-scaled
  const T* ck;               // layer slice (B, Hkv, T, D)
  const T* cv;
  const float* sk;           // layer slice (B, Hkv, T); Int8Cache
  const float* sv;
  const int32_t* kv_mask;    // (B, T) 0/1
  const T* pk;               // prefix layer slice (Hkv, Pc, D); PrefixCols
  const T* pv;
  const float* psk;          // (Hkv, Pc); Int8Cache with PrefixCols
  const float* psv;
  const int32_t* pmask;      // (B, Pc) 0/1; PrefixCols
  bf16* out;                 // (B, Hkv, rows, D)
  int Hkv, rep, rows, T_len, Pc;
};

// K2/K4/K9a's untyped arguments → Params (pk, pv and pmask may be null:
// CacheCols reads none of them)
inline Params<bf16> make_params(const void* qg, const void* ck,
                                const void* cv, const void* kv_mask,
                                const void* pk, const void* pv,
                                const void* pmask, void* out, int Hkv,
                                int rep, int T_len, int Pc) {
  return {static_cast<const bf16*>(qg), static_cast<const bf16*>(ck),
          static_cast<const bf16*>(cv), nullptr, nullptr,
          static_cast<const int32_t*>(kv_mask), static_cast<const bf16*>(pk),
          static_cast<const bf16*>(pv), nullptr, nullptr,
          static_cast<const int32_t*>(pmask), static_cast<bf16*>(out),
          Hkv, rep, rep, T_len, Pc};
}

// a tile's first key and value rows (row stride D), their scales (null
// for bf16), its mask and its count of columns
template <class T>
struct Tile {
  const T* k;
  const T* v;
  const float* sk;
  const float* sv;
  const int32_t* mask;
  int n;
};

// A column policy: `tiles(p)` counts a row's column tiles, `tile<D>(p, b,
// h, i)` gives tile i of row b and kv head h.

// K2, K4: the slot cache's tiles; no prefix pointer is read.
struct CacheCols {
  template <class P>
  __host__ __device__ explicit CacheCols(const P&) {}
  template <class P>
  __host__ __device__ int tiles(const P& p) const {
    return (p.T_len + kBT - 1) / kBT;
  }
  template <int D, class T>
  __device__ Tile<T> tile(const Params<T>& p, int b, int h, int i) const {
    const int c0 = i * kBT;
    const int64_t c = ((int64_t)b * p.Hkv + h) * p.T_len + c0;
    return {p.ck + c * D, p.cv + c * D, p.sk ? p.sk + c : nullptr,
            p.sv ? p.sv + c : nullptr, p.kv_mask + (int64_t)b * p.T_len + c0,
            min(kBT, p.T_len - c0)};
  }
};

// K9a, K9b, K9c: the prefix's tiles, then the cache's (neither straddles
// the seam).
struct PrefixCols {
  int nP;                    // prefix tiles

  template <class P>
  __host__ __device__ explicit PrefixCols(const P& p)
      : nP((p.Pc + kBT - 1) / kBT) {}
  template <class P>
  __host__ __device__ int tiles(const P& p) const {
    return nP + CacheCols(p).tiles(p);
  }
  template <int D, class T>
  __device__ Tile<T> tile(const Params<T>& p, int b, int h, int i) const {
    if (i < nP) {
      const int c0 = i * kBT;
      const int64_t c = (int64_t)h * p.Pc + c0;
      return {p.pk + c * D, p.pv + c * D, p.psk ? p.psk + c : nullptr,
              p.psv ? p.psv + c : nullptr, p.pmask + (int64_t)b * p.Pc + c0,
              min(kBT, p.Pc - c0)};
    }
    return CacheCols(p).tile<D>(p, b, h, i - nP);
  }
};

// An element policy: the cache's element T, the ring's depth, and the
// current columns: their count (`n_new`); what their logits read, staged
// by cp.async in one commit group before the ring's first stages
// (`stage_new<D>`, into the conversion tiles and the per-column scales
// `ns`, free until the loop); their logits per visible (row, column) into
// snew (`new_logits<D>`), both by the folding block `kFoldRank`; the v
// scale of a column's weight (`vscale`); what `value<D>` reads, staged
// after the loop (`stage_values<D>`); what the weights `wn` of a row's
// current columns add to head-dim columns d .. d + 3 (`value<D>`).

// K2, K4, K9a: bf16 tiles; one bf16 current column (B, Hkv, D), read from
// global memory.
struct Bf16Cache {
  using T = bf16;
  static constexpr bool kInt8 = false;
  static constexpr int kStages = 3;
  static constexpr int kMaxNew = 1;
  static constexpr int kFoldRank = 0;
  const bf16* k_new;
  const bf16* v_new;

  __device__ int n_new() const { return 1; }
  template <int D>
  __device__ void stage_new(const Params<bf16>&, const bf16*, int,
                            unsigned char*, float*, int) const {}
  // a warp a row over lane-strided head dims
  template <int D>
  __device__ void new_logits(const Params<bf16>& p, const bf16* q, int bg,
                             const unsigned char*, const float*, float* snew,
                             int tid) const {
    const int warp = tid >> 5, lane = tid & 31;
    const bf16* kn = k_new + (int64_t)bg * D;
    for (int hh = warp; hh < p.rows; hh += kWarps) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s = fmaf(__bfloat162float(q[hh * D + d]), __bfloat162float(kn[d]),
                 s);
      s = warp_sum(s);
      if (lane == 0) snew[hh * kMaxNew] = s;
    }
  }
  __device__ float vscale(const float*, int) const { return 1.f; }
  template <int D>
  __device__ void stage_values(int, float*, int) const {}
  template <int D>
  __device__ void value(const float* wn, const float*, int bg, int d,
                        float (&x)[4]) const {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = wn[0] * __bfloat162float(v_new[(int64_t)bg * D + d + u]);
  }
};

// K9b, K9c: int8 tiles with fp32 scales; G current columns, exact-integer
// fp32 kq/vq (B, Hkv, G, D) with scales ks/vs (B, Hkv, G), staged in
// shared memory by 4-byte cp.async, every load in flight together.
struct Int8Cache {
  using T = int8_t;
  static constexpr bool kInt8 = true;
  static constexpr int kStages = 2;
  static constexpr int kMaxNew = kMaxRows;
  // the block that owns the fewest tiles (rank r owns (n - 1 - r) / 4 + 1
  // of n, at every n) folds in the current columns; a row of fewer than
  // kCluster tiles (CacheCols at T <= 192) leaves it none, and it only
  // folds
  static constexpr int kFoldRank = kCluster - 1;
  const float* kq;
  const float* vq;
  const float* ks;
  const float* vs;
  int G;
  int dequant_first;         // 1: q·(kq·ks) (K9b); 0: (q·kq)·ks (K9c)

  __device__ int n_new() const { return G; }
  // rows of the staged q (bf16) and kq (fp32), padded so that the rows a
  // warp reads at one step fall in different banks
  __host__ __device__ static constexpr int qstride(int D) { return D + 8; }
  __host__ __device__ static constexpr int kstride(int D) { return D + 4; }
  // q's rows and kq's G rows into buf, ks and vs into ns
  template <int D>
  __device__ void stage_new(const Params<int8_t>& p, const bf16* q, int bg,
                            unsigned char* buf, float* ns, int tid) const {
    constexpr int kW = D / 2;              // bf16 pairs a row
    uint32_t* qs = reinterpret_cast<uint32_t*>(buf);
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q);
    for (int i = tid; i < p.rows * kW; i += kThreads) {
      const int r = i / kW;
      cp_async4(qs + r * (qstride(D) / 2) + (i - r * kW), qw + i, 4);
    }
    float* kqs = reinterpret_cast<float*>(qs + p.rows * (qstride(D) / 2));
    const float* k = kq + (int64_t)bg * G * D;
    for (int i = tid; i < G * D; i += kThreads) {
      const int r = i / D;
      cp_async4(kqs + r * kstride(D) + (i - r * D), k + i, 4);
    }
    for (int i = tid; i < 2 * G; i += kThreads) {
      const int c = i < G ? i : i - G;
      cp_async4(ns + (i < G ? 0 : kMaxNew) + c,
                (i < G ? ks : vs) + (int64_t)bg * G + c, 4);
    }
    cp_async_commit();
  }
  // a thread a visible (row, column), 16-byte loads of the staged rows and
  // four running sums; waits for stage_new's group alone (the ring's
  // kStages - 1 first stages may still be in flight)
  template <int D>
  __device__ void new_logits(const Params<int8_t>& p, const bf16*, int,
                             const unsigned char* buf, const float* ns,
                             float* snew, int tid) const {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const bf16* qs = reinterpret_cast<const bf16*>(buf);
    const float* kqs =
        reinterpret_cast<const float*>(qs + p.rows * qstride(D));
    const int n = p.rows * G;
    for (int i = tid; i < n; i += kThreads) {
      const int hh = i / G, c = i - hh * G;
      if (c > hh / p.rep) continue;        // causal inside the chunk
      const float scale = ns[c];
      const float kscale = dequant_first ? scale : 1.f;
      const bf16* qr = qs + hh * qstride(D);
      const float* kr = kqs + c * kstride(D);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < D; d += 8) {
        const uint4 qv = *reinterpret_cast<const uint4*>(qr + d);
        const float4 k0 = *reinterpret_cast<const float4*>(kr + d);
        const float4 k1 = *reinterpret_cast<const float4*>(kr + d + 4);
        const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
        const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 qf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&qw[u]));
          a[u] = fmaf(qf.x, kv[2 * u] * kscale, a[u]);
          a[u] = fmaf(qf.y, kv[2 * u + 1] * kscale, a[u]);
        }
      }
      const float sum = (a[0] + a[1]) + (a[2] + a[3]);
      snew[hh * kMaxNew + c] = dequant_first ? sum : sum * scale;
    }
  }
  __device__ float vscale(const float* ns, int c) const {
    return ns[kMaxNew + c];
  }
  // vq's G rows of this (b, kv head); the caller waits and syncs
  template <int D>
  __device__ void stage_values(int bg, float* dst, int tid) const {
    const float* v = vq + (int64_t)bg * G * D;
    for (int i = tid; i < G * D; i += kThreads) cp_async4(dst + i, v + i, 4);
    cp_async_commit();
  }
  template <int D>
  __device__ void value(const float* wn, const float* staged, int, int d,
                        float (&x)[4]) const {
    x[0] = x[1] = x[2] = x[3] = 0.f;
#pragma unroll 4
    for (int g = 0; g < G; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(staged + g * D + d);
      x[0] = fmaf(wn[g], v.x, x[0]);
      x[1] = fmaf(wn[g], v.y, x[1]);
      x[2] = fmaf(wn[g], v.z, x[2]);
      x[3] = fmaf(wn[g], v.w, x[3]);
    }
  }
};

// signed int8 bytes i and i + 1 of w → their bf16 pair (byte i in the low
// half), exactly: the byte flipped (q + 128) sits in the fp32 2^23 + u,
// one add takes 2^23 + 128 off, and the high halves of the two fp32 values
// are the bf16s (an integer of at most 8 significant bits)
__device__ __forceinline__ uint32_t s8x2_bf16x2(uint32_t w, int i) {
  const uint32_t u = w ^ 0x80808080u;
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + i)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// A write policy: `prefetch<D>(p, e, bg, b, rank, tid)` loads what block
// `rank` writes, before the cluster barrier that follows every block's
// last read of the slab (its latency hides behind the barrier); `write<D>`
// stores it after that barrier, each block its head-dim columns.  An
// out-of-range column is not written (the wrappers' plain versions raise
// on one; the serving engine never produces one).

struct NothingAhead {};

// K4, K9a: row b's k/v into slot slots[b] of its own (b, kv head) slab.
struct SlotWrite {
  bf16* ck;                  // Params' layer slices, written
  bf16* cv;
  const int32_t* slots;      // (B,)

  template <int D>
  __device__ NothingAhead prefetch(const Params<bf16>&, const Bf16Cache&,
                                   int, int, int, int) const {
    return {};
  }
  template <int D>
  __device__ void write(const Params<bf16>& p, const Bf16Cache& e, int bg,
                        int b, int rank, int tid, NothingAhead) const {
    constexpr int kCols = D / kCluster;
    const int slot = slots[b];
    if (slot < 0 || slot >= p.T_len) return;
    const int64_t row = ((int64_t)bg * p.T_len + slot) * D;
    for (int i = tid; i < 2 * kCols; i += kThreads) {
      const int d = rank * kCols + (i < kCols ? i : i - kCols);
      if (i < kCols)
        ck[row + d] = e.k_new[(int64_t)bg * D + d];
      else
        cv[row + d] = e.v_new[(int64_t)bg * D + d];
    }
  }
};

// K9b, K9c: the G current rows' int8 k/v at columns [slots[b], slots[b] +
// G) of row b's own slab (the exact-integer fp32 values rounded, as the
// plain versions' `.to(int8)`), their k and v scales by the leading block;
// a thread's share of the kMaxRows rows, at most kAhead<D> values, and one
// scale are held in registers between the two.
struct ChunkWrite {
  int8_t* ck;                // Params' layer slices, written
  int8_t* cv;
  float* sk;
  float* sv;
  const int32_t* slots;      // (B,)

  template <int D>
  static constexpr int kAhead =
      (2 * kMaxRows * (D / kCluster) + kThreads - 1) / kThreads;
  template <int D>
  struct Ahead {
    float v[kAhead<D>];      // rounded to int8 only in write(), so the
    float scale;             // loads stay in flight across the barrier
    int slot;
  };

  template <int D>
  __device__ Ahead<D> prefetch(const Params<int8_t>&, const Int8Cache& e,
                               int bg, int b, int rank, int tid) const {
    constexpr int kCols = D / kCluster;
    const int n = e.G * kCols;
    Ahead<D> a;
    a.slot = slots[b];
#pragma unroll
    for (int u = 0; u < kAhead<D>; ++u) {
      const int i = tid + u * kThreads;
      a.v[u] = 0.f;
      if (i < 2 * n) {
        const int half = i / n;              // 0: k, 1: v
        const int j = i - half * n;
        const int g = j / kCols, d = rank * kCols + j % kCols;
        a.v[u] = (half ? e.vq : e.kq)[((int64_t)bg * e.G + g) * D + d];
      }
    }
    a.scale = 0.f;
    if (rank == 0 && tid < 2 * e.G) {
      const int g = tid % e.G;
      a.scale = (tid < e.G ? e.ks : e.vs)[(int64_t)bg * e.G + g];
    }
    return a;
  }
  template <int D>
  __device__ void write(const Params<int8_t>& p, const Int8Cache& e, int bg,
                        int, int rank, int tid, const Ahead<D>& a) const {
    constexpr int kCols = D / kCluster;
    const int n = e.G * kCols;
#pragma unroll
    for (int u = 0; u < kAhead<D>; ++u) {
      const int i = tid + u * kThreads;
      if (i >= 2 * n) break;
      const int half = i / n;
      const int j = i - half * n;
      const int g = j / kCols, d = rank * kCols + j % kCols;
      const int col = a.slot + g;
      if (col < 0 || col >= p.T_len) continue;
      (half ? cv : ck)[((int64_t)bg * p.T_len + col) * D + d] =
          static_cast<int8_t>(__float2int_rn(a.v[u]));
    }
    if (rank == 0 && tid < 2 * e.G) {
      const int col = a.slot + tid % e.G;
      if (col >= 0 && col < p.T_len)
        (tid < e.G ? sk : sv)[(int64_t)bg * p.T_len + col] = a.scale;
    }
  }
};

// K2: the cache is read-only.
struct NoWrite {
  template <int D, class P, class E>
  __device__ NothingAhead prefetch(const P&, const E&, int, int, int,
                                   int) const {
    return {};
  }
  template <int D, class P, class E>
  __device__ void write(const P&, const E&, int, int, int, int,
                        NothingAhead) const {}
};

// tiles rank, rank + kCluster, ... of n: the ones block `rank` owns
__host__ __device__ inline int owned(int n_tiles, int rank) {
  return n_tiles > rank ? (n_tiles - 1 - rank) / kCluster + 1 : 0;
}

template <int D, int NF, class E>
struct Layout {
  static constexpr int kRows = kFrag * NF;       // query rows held
  static constexpr int kStride = D + 8;          // bf16 per staged row
  static constexpr int kTile = kBT * kStride;    // one bf16 K or V tile
  static constexpr int kOStride = D + 4;         // fp32 per merged O row
  // a stage of the ring: bf16 K and V tiles, or int8 K and V tiles (row
  // stride D) and their k and v scale rows
  static constexpr size_t kStage =
      E::kInt8 ? 2 * kBT * D + 2 * kBT * sizeof(float)
               : 2 * kTile * sizeof(bf16);
  static constexpr size_t kRing = E::kStages * kStage;
  // Int8Cache: the bf16 K and V tiles converted from the stage in use
  static constexpr size_t kConv = E::kInt8 ? 2 * kTile * sizeof(bf16) : 0;
  // after the loop: the warps' partials and the staged current values in
  // the ring, the block's partial O in the converted tiles (or a region of
  // its own)
  static constexpr size_t kWarpPart =
      sizeof(float) * kWarps * kFrag * (kOStride + 2);
  static_assert(kWarpPart + sizeof(float) * E::kMaxNew * D <= kRing,
                "the warps' partials and the staged values must fit the ring");
  static constexpr size_t kBo = sizeof(float) * kRows * D;
  static constexpr size_t kBoAt = kBo <= kConv ? kRing : kRing + kConv;
  static constexpr size_t kBitsAt =
      kRing + kConv + (kBo <= kConv ? 0 : kBo);
  // then the tiles' mask bits; per row: the block's (m, l), the current
  // columns' rescale, the warps' rescales, the current columns' logits
  // (then their weights times vs); the current columns' k and v scales
  static constexpr size_t kBytes =
      kBitsAt + sizeof(uint2) * kMaxLocal +
      sizeof(float) * (kRows * (3 + kWarps + E::kMaxNew) + 2 * E::kMaxNew);
  static_assert(!E::kInt8 ||
                    sizeof(bf16) * kRows * (D + 8) +
                            sizeof(float) * kRows * (D + 4) <=
                        kConv,
                "q's rows and kq's must fit the conversion tiles");
};

// one cluster of kCluster blocks per (b, kv head)
template <int D, int NF, class Cols, class E, class Write>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
decode_split_kernel(const Params<typename E::T> p, const E e,
                    const Write w) {
  static_assert(D % 16 == 0 && D <= 128 && D % kCluster == 0,
                "head_dim in {16, 32, 64, 128}");
  static_assert(NF == 1 || NF == 2 || NF == 4, "1, 2 or 4 fragments");
  using L = Layout<D, NF, E>;
  constexpr int kKT = D / 16;            // k steps of Sᵀ; m tiles of Oᵀ
  constexpr int KG = kWarps / NF;        // key groups of a tile
  constexpr int kRows = L::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  bf16* conv = reinterpret_cast<bf16*>(smem_raw + L::kRing);
  float* bo = reinterpret_cast<float*>(smem_raw + L::kBoAt);  // [kRows][D]
  uint2* bits_s = reinterpret_cast<uint2*>(smem_raw + L::kBitsAt);
  float* bm = reinterpret_cast<float*>(bits_s + kMaxLocal);
  float* bl = bm + kRows;
  float* fold = bl + kRows;              // the current columns' rescale
  float* fac = fold + kRows;             // [kRows][kWarps]
  float* snew = fac + kRows * kWarps;    // [kRows][E::kMaxNew]
  float* ns = snew + kRows * E::kMaxNew; // [2][E::kMaxNew]: ks, vs

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bg = blockIdx.x / kCluster;  // b * Hkv + kv head
  const int b = bg / p.Hkv;
  const int h = bg - b * p.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int frag = warp % NF, kgrp = warp / NF;
  const Cols cols(p);
  const int n_local = owned(cols.tiles(p), rank);

  // q's B fragments (k = head dim, n = query row 8·frag + g; rows past
  // `rows` zero)
  const bf16* q = p.qg + (int64_t)bg * p.rows * D;
  uint32_t qb[kKT][2];
#pragma unroll
  for (int kk = 0; kk < kKT; ++kk) {
    const int row = kFrag * frag + g;
    const bool in = row < p.rows;
    const bf16* qr = q + row * D + 16 * kk + 2 * t;
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
        const auto tl = cols.template tile<D>(p, b, h, rank + kCluster * j);
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
  __syncthreads();

  auto live = [&](int j) {
    const uint2 x = bits_s[j];
    return (x.x | x.y) != 0u;
  };
  auto next_live = [&](int j) {
    while (j < n_local && !live(j)) ++j;
    return j;
  };
  // local tile j → ring stage `slot`; masked columns zero-filled, never
  // read
  auto stage = [&](int j, int slot) {
    const auto tl = cols.template tile<D>(p, b, h, rank + kCluster * j);
    const uint2 x = bits_s[j];
    auto valid = [&](int r) {
      return ((r < 32 ? x.x >> r : x.y >> (r - 32)) & 1u) != 0u;
    };
    if constexpr (E::kInt8) {
      int8_t* ks = reinterpret_cast<int8_t*>(ring + slot * L::kStage);
      int8_t* vs = ks + kBT * D;
      float* sks = reinterpret_cast<float*>(vs + kBT * D);
      float* svs = sks + kBT;
      constexpr int kChunks = D / 16;
      for (int i = tid; i < kBT * kChunks; i += kThreads) {
        const int r = i / kChunks, c = i % kChunks;
        const bool ok = valid(r);
        const int64_t o = ok ? (int64_t)r * D + 16 * c : 0;
        cp_async16(ks + r * D + 16 * c, tl.k + o, ok ? 16 : 0);
        cp_async16(vs + r * D + 16 * c, tl.v + o, ok ? 16 : 0);
      }
      static_assert(2 * kBT == kThreads, "one scale a thread");
      const int r = tid % kBT;
      const bool ok = valid(r);
      cp_async4(tid < kBT ? sks + r : svs + r,
                (tid < kBT ? tl.sk : tl.sv) + (ok ? r : 0), ok ? 4 : 0);
    } else {
      bf16* ks = reinterpret_cast<bf16*>(ring + slot * L::kStage);
      bf16* vs = ks + L::kTile;
      constexpr int kChunks = D / 8;
#pragma unroll
      for (int it = 0; it < kBT * kChunks / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int r = i / kChunks, c = i % kChunks;
        const bool ok = valid(r);
        const int64_t o = ok ? (int64_t)r * D + 8 * c : 0;
        cp_async16(ks + r * L::kStride + 8 * c, tl.k + o, ok ? 16 : 0);
        cp_async16(vs + r * L::kStride + 8 * c, tl.v + o, ok ? 16 : 0);
      }
    }
  };
  // Int8Cache: stage `slot`'s int8 K and V rows → the bf16 tiles in conv
  auto convert = [&](int slot) {
    const int8_t* ks = reinterpret_cast<const int8_t*>(ring + slot * L::kStage);
    constexpr int kChunks = D / 16;
    for (int i = tid; i < 2 * kBT * kChunks; i += kThreads) {
      const int half = i / (kBT * kChunks);  // 0: K, 1: V
      const int r = i / kChunks - half * kBT, c = i % kChunks;
      const uint4 u = *reinterpret_cast<const uint4*>(
          ks + (half * kBT + r) * D + 16 * c);
      uint4 lo, hi;
      lo.x = s8x2_bf16x2(u.x, 0);
      lo.y = s8x2_bf16x2(u.x, 2);
      lo.z = s8x2_bf16x2(u.y, 0);
      lo.w = s8x2_bf16x2(u.y, 2);
      hi.x = s8x2_bf16x2(u.z, 0);
      hi.y = s8x2_bf16x2(u.z, 2);
      hi.z = s8x2_bf16x2(u.w, 0);
      hi.w = s8x2_bf16x2(u.w, 2);
      bf16* dst = conv + half * L::kTile + r * L::kStride + 16 * c;
      *reinterpret_cast<uint4*>(dst) = lo;
      *reinterpret_cast<uint4*>(dst + 8) = hi;
    }
  };

  // Oᵀ: tile mt holds (head dim 16mt + g (+8), rows 2t, 2t + 1 of the
  // warp's fragment)
  float o[kKT][4];
#pragma unroll
  for (int mt = 0; mt < kKT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[mt][c] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // rows 2t, 2t + 1
  float l[2] = {0.f, 0.f};           // this thread's keys' part of the sums

  constexpr int kS = E::kStages;
  unsigned char* conv_b = reinterpret_cast<unsigned char*>(conv);
  if (rank == E::kFoldRank)
    e.template stage_new<D>(p, q, bg, conv_b, ns, tid);
  int to_stage = next_live(0);       // the next tile to stage
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (to_stage < n_local) {
      stage(to_stage, s);
      to_stage = next_live(to_stage + 1);
    }
    cp_async_commit();
  }
  // the current columns' logits (the folding block), while the first
  // tiles are in flight
  if (rank == E::kFoldRank)
    e.template new_logits<D>(p, q, bg, conv_b, ns, snew, tid);
  for (int it = 0, cur = next_live(0); cur < n_local;
       ++it, cur = next_live(cur + 1)) {
    cp_async_wait<kS - 2>();           // this tile has landed;
    __syncthreads();                   // every warp is done with tile it - 1
    if (to_stage < n_local) {
      stage(to_stage, (it + kS - 1) % kS);
      to_stage = next_live(to_stage + 1);
    }
    cp_async_commit();
    const unsigned char* st = ring + (it % kS) * L::kStage;
    const bf16* ks = reinterpret_cast<const bf16*>(st);
    const float* sks = nullptr;
    const float* svs = nullptr;
    if constexpr (E::kInt8) {
      convert(it % kS);
      sks = reinterpret_cast<const float*>(st + 2 * kBT * D);
      svs = sks + kBT;
      ks = conv;
      __syncthreads();                 // the converted tiles are complete
    }
    const bf16* vs = ks + L::kTile;
    const uint2 x = bits_s[cur];
    // the valid bits of the warp's key m tiles kgrp·NF + jj (16 keys each)
    unsigned wb[NF];
    unsigned any = 0u;
#pragma unroll
    for (int jj = 0; jj < NF; ++jj) {
      const int kt = kgrp * NF + jj;
      wb[jj] = ((kt < 2 ? x.x : x.y) >> (16 * (kt & 1))) & 0xffffu;
      any |= wb[jj];
    }
    if (any != 0u) {
      const float ninf = __uint_as_float(0xff800000u);
      // Sᵀ = K·qᵀ: (key g, rows 2t, 2t + 1), (key g + 8, ...) of m tile jj
      // (the NF m tiles' accumulations interleaved, a masked tile's too)
      float s[NF][4];
#pragma unroll
      for (int jj = 0; jj < NF; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[jj][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk)
#pragma unroll
        for (int jj = 0; jj < NF; ++jj) {
          uint32_t ka[4];
          ldmatrix_x4(ka, ks + (16 * (kgrp * NF + jj) + (lane & 7) +
                                (((lane >> 3) & 1) << 3)) * L::kStride +
                              16 * kk + ((lane >> 4) << 3));
          mma_bf16(s[jj], ka, qb[kk][0], qb[kk][1]);
        }
#pragma unroll
      for (int jj = 0; jj < NF; ++jj) {
        const int kt = kgrp * NF + jj;
        if constexpr (E::kInt8) {      // the logit: (q·k_int)·sk
          const float s0 = sks[16 * kt + g], s1 = sks[16 * kt + g + 8];
          s[jj][0] *= s0;
          s[jj][1] *= s0;
          s[jj][2] *= s1;
          s[jj][3] *= s1;
        }
        if (!((wb[jj] >> g) & 1u)) s[jj][0] = s[jj][1] = ninf;
        if (!((wb[jj] >> (g + 8)) & 1u)) s[jj][2] = s[jj][3] = ninf;
      }
      // online softmax per row over the warp's keys: the max across the
      // lanes of one t by three shuffles
      float mx[2] = {fmaxf(s[0][0], s[0][2]), fmaxf(s[0][1], s[0][3])};
#pragma unroll
      for (int jj = 1; jj < NF; ++jj) {
        mx[0] = fmaxf(mx[0], fmaxf(s[jj][0], s[jj][2]));
        mx[1] = fmaxf(mx[1], fmaxf(s[jj][1], s[jj][3]));
      }
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
#pragma unroll
      for (int jj = 0; jj < NF; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[jj][c] = exp2_approx((s[jj][c] - m[c & 1]) * kLog2e);
          l[c & 1] += s[jj][c];
        }
#pragma unroll
      for (int mt = 0; mt < kKT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[mt][c] *= alpha[c & 1];
#pragma unroll
      for (int jj = 0; jj < NF; ++jj) {
        const int kt = kgrp * NF + jj;
        if constexpr (E::kInt8) {      // the weight times sv, then bf16
          const float v0 = svs[16 * kt + g], v1 = svs[16 * kt + g + 8];
          s[jj][0] *= v0;
          s[jj][1] *= v0;
          s[jj][2] *= v1;
          s[jj][3] *= v1;
        }
        // Pᵀ rounded to bf16: (keys × rows) 8x8 blocks → transposed, the B
        // fragments (k = key, n = row) of Oᵀ += Vᵀ·Pᵀ
        const uint32_t b0 = movmatrix_trans(pack_bf16x2(s[jj][0], s[jj][1]));
        const uint32_t b1 = movmatrix_trans(pack_bf16x2(s[jj][2], s[jj][3]));
#pragma unroll
        for (int mt = 0; mt < kKT; ++mt) {
          uint32_t va[4];
          ldmatrix_x4_trans(va, vs + (16 * kt + (lane & 7) +
                                      ((lane >> 4) << 3)) * L::kStride +
                                    16 * mt + (((lane >> 3) & 1) << 3));
          mma_bf16(o[mt], va, b0, b1);
        }
      }
    }
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
  float* wo = reinterpret_cast<float*>(ring);   // [kWarps][kFrag][kOStride]
  float* wm = wo + kWarps * kFrag * L::kOStride;
  float* wl = wm + kWarps * kFrag;
  float* staged = wl + kWarps * kFrag;  // what the fold's value() reads
#pragma unroll
  for (int mt = 0; mt < kKT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wo[(warp * kFrag + 2 * t + (c & 1)) * L::kOStride + 16 * mt + g +
         8 * (c >> 1)] = o[mt][c];
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wm[warp * kFrag + 2 * t + r] = m[r];
      wl[warp * kFrag + 2 * t + r] = l[r];
    }
  }
  if (rank == E::kFoldRank) {
    e.template stage_values<D>(bg, staged, tid);
    cp_async_wait<0>();
  }
  __syncthreads();
  // per row: the block's (m, l) over the warps of its fragment, their
  // rescales, and in the folding block the current columns folded in
  for (int hh = tid; hh < p.rows; hh += kThreads) {
    const int f = hh / kFrag, j = hh % kFrag;
    float mb = wm[f * kFrag + j];
#pragma unroll
    for (int kg = 1; kg < KG; ++kg)
      mb = fmaxf(mb, wm[(kg * NF + f) * kFrag + j]);
    float lb = 0.f;
#pragma unroll
    for (int kg = 0; kg < KG; ++kg) {
      const int wi = (kg * NF + f) * kFrag + j;
      const float a = exp2_approx((wm[wi] - mb) * kLog2e);
      fac[hh * kWarps + kg] = a;
      lb = fmaf(wl[wi], a, lb);
    }
    if (rank == E::kFoldRank) {
      const int nn = min(e.n_new(), hh / p.rep + 1);   // visible columns
      float* sn = snew + hh * E::kMaxNew;
      float mn = mb;
      for (int c = 0; c < nn; ++c) mn = fmaxf(mn, sn[c]);
      const float a = exp2_approx((mb - mn) * kLog2e);
      float ln = 0.f;
      for (int c = 0; c < e.n_new(); ++c) {
        const float an = c < nn ? exp2_approx((sn[c] - mn) * kLog2e) : 0.f;
        ln += an;
        sn[c] = an * e.vscale(ns, c);    // the weight that meets v
      }
      lb = fmaf(lb, a, ln);
      fold[hh] = a;
      mb = mn;
    }
    bm[hh] = mb;
    bl[hh] = lb;
  }
  __syncthreads();
  // what the write policy stores after the cluster barrier
  const auto ahead = w.template prefetch<D>(p, e, bg, b, rank, tid);
  // the block's partial O, four head-dim columns a thread
#pragma unroll 2
  for (int i = tid; i < p.rows * D / 4; i += kThreads) {
    const int hh = i / (D / 4), d = (i - hh * (D / 4)) * 4;
    const int f = hh / kFrag, j = hh % kFrag;
    float ob[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kg = 0; kg < KG; ++kg) {
      const float4 v = *reinterpret_cast<const float4*>(
          wo + ((kg * NF + f) * kFrag + j) * L::kOStride + d);
      const float a = fac[hh * kWarps + kg];
      ob[0] = fmaf(v.x, a, ob[0]);
      ob[1] = fmaf(v.y, a, ob[1]);
      ob[2] = fmaf(v.z, a, ob[2]);
      ob[3] = fmaf(v.w, a, ob[3]);
    }
    if (rank == E::kFoldRank) {
      float x[4];
      e.template value<D>(snew + hh * E::kMaxNew, staged, bg, d, x);
#pragma unroll
      for (int u = 0; u < 4; ++u) ob[u] = fmaf(ob[u], fold[hh], x[u]);
    }
    *reinterpret_cast<float4*>(bo + hh * D + d) =
        make_float4(ob[0], ob[1], ob[2], ob[3]);
  }
  // every block's partial is in place, and every read of the slab is done
  cluster.sync();

  // block `rank` merges head-dim columns [rank·kCols, (rank+1)·kCols) of
  // every row over the blocks in rank order, four columns a thread
  constexpr int kCols = D / kCluster;
  static_assert(kCols % 4 == 0, "four columns a thread");
#pragma unroll 2
  for (int i = tid; i < p.rows * kCols / 4; i += kThreads) {
    const int hh = i / (kCols / 4);
    const int d = rank * kCols + (i - hh * (kCols / 4)) * 4;
    float mr[kCluster], lr[kCluster];
    float4 orr[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      mr[r] = *cluster.map_shared_rank(bm + hh, r);
      lr[r] = *cluster.map_shared_rank(bl + hh, r);
      orr[r] = *cluster.map_shared_rank(
          reinterpret_cast<float4*>(bo + hh * D + d), r);
    }
    float mx = mr[0];
#pragma unroll
    for (int r = 1; r < kCluster; ++r) mx = fmaxf(mx, mr[r]);
    float lt = 0.f, ot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float a = exp2_approx((mr[r] - mx) * kLog2e);
      lt = fmaf(lr[r], a, lt);
      ot[0] = fmaf(orr[r].x, a, ot[0]);
      ot[1] = fmaf(orr[r].y, a, ot[1]);
      ot[2] = fmaf(orr[r].z, a, ot[2]);
      ot[3] = fmaf(orr[r].w, a, ot[3]);
    }
    uint2 packed;
    packed.x = pack_bf16x2(ot[0] / lt, ot[1] / lt);
    packed.y = pack_bf16x2(ot[2] / lt, ot[3] / lt);
    *reinterpret_cast<uint2*>(p.out + ((int64_t)bg * p.rows + hh) * D + d) =
        packed;
  }
  // every block's last read of the slab preceded the barrier
  w.template write<D>(p, e, bg, b, rank, tid, ahead);
  cluster.sync();                    // no block leaves while others read it
}

template <int D, int NF, class Cols, class E, class Write>
cudaError_t launch(const Params<typename E::T>& p, const E& e,
                   const Write& w, int B, cudaStream_t stream) {
  using L = Layout<D, NF, E>;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<D, NF, Cols, E, Write>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  decode_split_kernel<D, NF, Cols, E, Write>
      <<<B * p.Hkv * kCluster, kThreads, L::kBytes, stream>>>(p, e, w);
  return cudaGetLastError();
}

// How many clusters of one instantiation the card holds at once
// (cudaOccupancyMaxActiveClusters): a launch of more (B·Hkv at B 8, Hkv 8
// is 64) runs the rest as a second wave.  For the sweep script; no path
// asks.
template <int D, int NF, class Cols, class E, class Write>
cudaError_t resident(int* n) {
  using L = Layout<D, NF, E>;
  const auto kernel = decode_split_kernel<D, NF, Cols, E, Write>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  return cudaOccupancyMaxActiveClusters(n, (void*)kernel, &cfg);
}

// f.go<D, NF>() for the instantiation of head dim D and `rows` query rows
// (NF n8 fragments: 1 up to kFrag rows; Int8Cache 2 or 4 above)
template <class E, int D, class F>
cudaError_t dispatch_rows(int rows, const F& f) {
  if (rows <= kFrag) return f.template go<D, 1>();
  if constexpr (E::kInt8) {            // bf16's rows are rep <= 8
    if (rows <= 2 * kFrag) return f.template go<D, 2>();
    if (rows <= kMaxRows) return f.template go<D, 4>();
  }
  return cudaErrorInvalidValue;
}
template <class E, class F>
cudaError_t dispatch(int D, int rows, const F& f) {
  switch (D) {
    case 16: return dispatch_rows<E, 16>(rows, f);
    case 32: return dispatch_rows<E, 32>(rows, f);
    case 64: return dispatch_rows<E, 64>(rows, f);
    case 128: return dispatch_rows<E, 128>(rows, f);
    default: return cudaErrorInvalidValue;
  }
}

template <class Cols, class E, class Write>
struct Launch {
  const Params<typename E::T>& p;
  const E& e;
  const Write& w;
  int B;
  cudaStream_t s;
  template <int D, int NF>
  cudaError_t go() const { return launch<D, NF, Cols>(p, e, w, B, s); }
};
template <class Cols, class E, class Write>
struct Resident {
  int* n;
  template <int D, int NF>
  cudaError_t go() const { return resident<D, NF, Cols, E, Write>(n); }
};

// The body for head dim D; cudaErrorInvalidValue for another D, more than
// kMaxRows query rows (bf16: kFrag) or more tiles than a block may own,
// cudaErrorMisalignedAddress for a slab cp.async cannot copy (the wrappers
// raise before that).
template <class Cols, class E, class Write>
cudaError_t run(int D, const Params<typename E::T>& p, const E& e,
                const Write& w, int B, cudaStream_t s) {
  if (owned(Cols(p).tiles(p), 0) > kMaxLocal) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(p.ck) | reinterpret_cast<uintptr_t>(p.cv) |
       reinterpret_cast<uintptr_t>(p.pk) | reinterpret_cast<uintptr_t>(p.pv)) &
      15)
    return cudaErrorMisalignedAddress;
  return dispatch<E>(D, p.rows, Launch<Cols, E, Write>{p, e, w, B, s});
}

template <class Cols, class E, class Write>
cudaError_t resident_clusters(int D, int rows, int* n) {
  return dispatch<E>(D, rows, Resident<Cols, E, Write>{n});
}

// K7, K8, K9b and K9c's untyped arguments (as p2t_decode_attention_verify's,
// G current rows of rep query heads each; dequant_first 1: K7/K9b's
// q·(kq·ks), 0: K8/K9c's (q·kq)·ks) → the Int8Cache body over column
// policy Cols (CacheCols reads no prefix pointer)
template <class Cols>
cudaError_t run_int8(const void* qg, void* ck, void* cv, void* sk, void* sv,
                     const void* kv_mask, const void* kq, const void* vq,
                     const void* ks, const void* vs, const void* slots,
                     const void* pk, const void* pv, const void* psk,
                     const void* psv, const void* pmask, void* out, int B,
                     int Hkv, int rep, int G, int T_len, int Pc, int D,
                     int dequant_first, cudaStream_t stream) {
  const Params<int8_t> p = {
      static_cast<const bf16*>(qg), static_cast<const int8_t*>(ck),
      static_cast<const int8_t*>(cv), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int32_t*>(kv_mask),
      static_cast<const int8_t*>(pk), static_cast<const int8_t*>(pv),
      static_cast<const float*>(psk), static_cast<const float*>(psv),
      static_cast<const int32_t*>(pmask), static_cast<bf16*>(out),
      Hkv, rep, G * rep, T_len, Pc};
  const Int8Cache e = {static_cast<const float*>(kq),
                       static_cast<const float*>(vq),
                       static_cast<const float*>(ks),
                       static_cast<const float*>(vs), G, dequant_first};
  const ChunkWrite w = {static_cast<int8_t*>(ck), static_cast<int8_t*>(cv),
                        static_cast<float*>(sk), static_cast<float*>(sv),
                        static_cast<const int32_t*>(slots)};
  return run<Cols>(D, p, e, w, B, stream);
}

// K7, K8, K9b and K9c on bf16 q: whether the shape takes this body (the
// rule the wrappers state as `decode_attention.int8_split_route`), with
// the shared prefix (PrefixCols) or without it (CacheCols)
inline bool int8_takes(int dtype, int rows) {
  return dtype == p2t::kBFloat16 && rows <= kMaxRows;
}

}  // namespace split
}  // namespace

// bf16 K7, K8, K9b and K9c on this body's int8 policy, defined in
// decode_attention_split_q.cu (the shapes `split::int8_takes` gives it):
// Pc > 0 with the prefix's pointers over PrefixCols (K9b, K9c), Pc == 0
// with null prefix pointers over CacheCols (K7, K8), whose instantiations
// decode_attention_split_qc.cu holds (p2t_decode_split_int8_cache)
extern "C" int p2t_decode_split_int8(
    const void* qg, void* ck, void* cv, void* sk, void* sv,
    const void* kv_mask, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* slots, const void* pk, const void* pv,
    const void* psk, const void* psv, const void* pmask, void* out, int B,
    int Hkv, int rep, int G, int T_len, int Pc, int D, int dequant_first,
    void* stream);
extern "C" int p2t_decode_split_int8_cache(
    const void* qg, void* ck, void* cv, void* sk, void* sv,
    const void* kv_mask, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* slots, void* out, int B, int Hkv, int rep,
    int G, int T_len, int D, int dequant_first, void* stream);
extern "C" int p2t_decode_split_int8_cache_resident(int rows, int D,
                                                    void* n);
