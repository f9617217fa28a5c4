// Weight-quantized matmul for the few-row products of serving and decoding,
// one body for four weight formats (K10, K11a, K11b, K14) and the probes'
// variants (K15a-e, probe_quant_matmul.cu),
//
//   y[r, n] = (sum_k bf16(x[r, k]) * q[k, n]) * scale[n]
//
// x (R, K) f32 or bf16, rounded to bf16 as it is staged; q the integer
// weight in a format policy's layout (`WordsF<kPlanes>` K10: (K/8, N) int32
// nibble planes, nibble j of word [k8, n] holding q[k8 + j*K/8, n];
// `WordsF<kPairs>` K11b: (K/8, N) int32 bf16-pair words, bits [4p, 4p+4)
// holding q[k8 + 2p*K/8, n] + 8 and bits [16+4p, 20+4p) q[k8 + (2p+1)*K/8,
// n] + 8; `BytesF` K11a: (K/2, N) int8 split-half bytes, byte [k2, n]
// holding q[k2, n] low and q[k2 + K/2, n] high; `Int8F` K14: (K, N) int8);
// scale (N,) f32 (nullptr: none); fp32 accumulation, the scale in the fp32
// epilogue, y in x's dtype.  The stacked entry points pass the layer's base
// pointer into an (L, ...) buffer.  The TPU kernels
// (prot2text_tpu/kernels/quant_matmul.py) walked an (N/bn, K/bk) grid in
// order, carrying the block's sum in VMEM; here blocks run in no order, so
// a split of K is summed across a thread-block cluster.
//
// Bound: bytes.  At a decode step's rows the weight is nearly every byte:
// Qwen3-14B's gate/up read 44.6 MB (int4) or 89.1 MB (int8), 13.3 or 26.6
// us at 3.35 TB/s, its int4 LM head 389 MB (116 us); the products, 2*R*K*N
// operations, take under 2% of the bf16 tensor cores' rate at R 8.  So the
// body streams each weight byte from device memory once and keeps the
// stream unbroken.  The body it replaces (quant_matmul_ragged.cuh, which
// keeps the shapes TMA cannot describe) reached 21-49% of the bound on an
// H100, HBM-cold (PERF.md §6): its loads drained at every fill of x, its
// split of K wrote fp32 partials to device memory for a second launch, and
// bytes and int8 took four 4-byte loads a row.  The design:
//   - the weight streams through a ring of 4 stages of 8 KB in shared
//     memory (a stage is one tile: 128 k values of int4 or 64 of int8 x
//     the block's 128 columns), each filled by one TMA box of 128-byte rows
//     in the 128-byte swizzle, which keeps every consumer's read of a stage
//     free of bank conflicts.  One producer warp issues the copies; a full
//     and an empty mbarrier guard each stage; no block-wide barrier runs in
//     the K loop.  A deeper ring streamed slower on the card (fewer blocks
//     fit an SM), as did a ring of smaller stages;
//   - x (8 rows, or 16 in two MMA tiles, x the block's K slice) is staged
//     once, before the consumers' first wait, as bf16 in the order the B
//     fragments read it: 16 bytes per thread and pair of k16 steps, one
//     conflict-free 16-byte load (a row's stride is 4 mod 8 chunks of 16
//     bytes), read 16 bytes at a time from global memory; a row block of
//     16 per grid z for larger R;
//   - the consumer warps (32 output columns each) read a chunk of four
//     pairs of k16 steps of their columns from the ring (planes and pairs:
//     one 16-byte load a pair; bytes: four 4-byte loads of the four byte
//     groups; int8: one ldmatrix.x4.trans per 16 columns, the many-row
//     body's Int8W), turn them into A fragments in registers (`nibble_pair`
//     for planes; a byte permute, a mask and one bf16x2 subtraction per
//     fragment register for pairs and bytes; int8: the many-row body's
//     `int8_pair`), and run mma.sync m16n8k16 with x as the 8-row B operand,
//     the product transposed (y^T = q^T x^T);
//   - K is split over the Ck blocks of a cluster, the largest up to 8 whose
//     ranks all hold a tile (on the card more, shorter blocks streamed
//     faster at every projection, whole waves or not: each block's stream
//     is paced by its own latency): each rank pushes its fp32 partial,
//     float4 by float4, into the receive buffer of the rank that owns that
//     float4 (i % Ck), one cluster barrier, and each rank sums its float4s
//     over the ranks in rank order and writes them: one launch, no partial
//     in device memory, no atomics, the same bits on every launch;
//   - the host path is short (a decode step's host time paces it): the
//     weight's tensor map comes from a table keyed by what it encodes, the
//     shared-memory limit is set once per device, and a cluster is launched
//     only to split K.  kernels/quant_matmul.py few_rows_tiling picks the
//     columns, the cluster and the stages.
// Measured (H100 80GB HBM3, 700 W, HBM-cold, scripts/time_few_rows.py;
// PERF.md §6), at R 8: 35% of the bound at Qwen3-14B's gate/up and down in
// the int4 formats (33% for bytes), 57% in int8, 45% at the int4 LM head,
// 70% at the int8 one, 8-13% at k/v (2.6 MB: a launch's latency).  What
// stops it short: the stream itself (without its products it ran at under
// half the bound at gate/up on the card), paced by each block's latency
// (a deeper ring runs no faster, more and shorter blocks do), then the
// products (about a fifth of the time at gate/up).
// The integer values are exact in bf16, so only x's rounding and the order
// of the fp32 sums separate the result from the plain version.  The three
// int4 policies read their words into the same fragments (the k values of
// MMA m of word row i at kk 2t, 2t+1, 2t+8, 2t+9 are planes 2m, 2m+4,
// 2m+1, 2m+5 of that word row), and all run the same grid, the same MMAs
// in the same order and the same cluster sum: on the same integers K11a
// and K11b equal K10 bit for bit.
// Contract: any R >= 1, x 16-byte aligned; the weight 16-byte aligned and
// described by TMA: the int4 formats K % 64 == 0 and N % 32 == 0 (planes'
// and pairs' stage is one box of 32-word column groups; bytes follow, so
// that the three formats take one route), int8 K % 8 == 0, N % 16 == 0
// (kernels/quant_matmul.py few_fit, which also keeps x's slice within a
// block's shared memory; any other shape takes the ragged route).
#pragma once

#include <cooperative_groups.h>
#include <mutex>

#include "quant_matmul_ragged.cuh"
#include "quant_matmul_rows.cuh"

namespace {
namespace few {

namespace cg = cooperative_groups;
using rows::mbar_arrive;
using rows::mbar_expect;
using rows::mbar_init;
using rows::mbar_wait;

constexpr int kUnitK = 64;             // k values of a unit of staged x
constexpr int kWordRows = 16;          // word rows of an int4 tile (128 k)
constexpr int kXPad = 64;              // bytes after each staged x row
constexpr int kMaxCluster = 8;         // the portable cluster
constexpr int kSmemMax = 232448;       // a block's dynamic shared memory
constexpr int kMapSlots = 4096;        // the tensor-map table

// ---------------------------------------------------------------------------
// x staging.  A row of the block's x slice is a run of 16-byte quads; quad
// 4p + t holds thread t's B fragments of pair p (k16 steps 2p and 2p + 1):
// words (b0, b1) of step 2p, then (b0, b1) of step 2p + 1.

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 consecutive values of x at p (16-byte aligned) as bf16 pairs
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                    pack2(b.z, b.w));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// unit `unit` (64 k values, 8 word rows) of row xr (nullptr: a row past R,
// zeros; so are word rows past K/8) in the int4 formats' order: word row i
// of the unit (k = j*K/8 + 8*unit + i in plane j) is quad 4(i % 2) + i / 2,
// planes (0, 4), (1, 5), (2, 6), (3, 7)
template <typename T>
__device__ __forceinline__ void stage_planes(const T* xr, int K, int unit,
                                             uint4* q) {
  uint4 v[8];
  const bool live = xr && 8 * unit < K / 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = live ? load8(xr + j * (K / 8) + 8 * unit) : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t sel = (i & 1) ? 0x7632 : 0x5410;
    uint32_t w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      w[m] = __byte_perm(word(v[m], i >> 1), word(v[m + 4], i >> 1), sel);
    q[4 * (i & 1) + (i >> 1)] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// unit `unit` (64 k values) of row xr in plain k order within each pair (k
// values past K are zeros; K % 8 == 0): word i of the unit holds k 2i, 2i +
// 1.  kInt8:
// quad 4p + t = words 16p + t, + 4, + 8, + 12 (k 2t, 2t+8 of step 2p, then
// of step 2p + 1); else (K15c's native int4) words 16p + 2t, + 1, + 8, + 9
// (k 4t .. 4t + 3 of each step)
template <typename T, bool kInt8>
__device__ __forceinline__ void stage_natural(const T* xr, int K, int unit,
                                              uint4* q) {
  uint4 v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int k = kUnitK * unit + 8 * c;
    v[c] = xr && k < K ? load8(xr + k) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i0 = kInt8 ? 16 * p + t : 16 * p + 2 * t;
      const int i1 = kInt8 ? i0 + 4 : i0 + 1;
      const int i2 = i0 + 8, i3 = i1 + 8;
      q[4 * p + t] = make_uint4(word(v[i0 >> 2], i0 & 3),
                                word(v[i1 >> 2], i1 & 3),
                                word(v[i2 >> 2], i2 & 3),
                                word(v[i3 >> 2], i3 & 3));
    }
}

// ---------------------------------------------------------------------------
// fragment builders.  A nibble u >= 0 masked into bits [0, 4) of a bf16
// under 0x4300 is the bf16 of 128 + u (bf16 has 7 mantissa bits: a nibble
// at bits 4-7 would reach the exponent), and one LOP3 (the mask, the
// two's-complement flip of bit 3 and 0x4300 at once) and one bf16x2 add of
// -136 leave the value exactly.  What remains is to bring each pair of
// nibbles to bits 0-3 and 16-19 in few instructions: one byte permute of
// the word and of the word shifted by 4 for the byte formats, the ragged
// route's shifts for the planes.  The values, and so the products, are
// those of the ragged route's builders (`nibble_pair`, `pair_planes`,
// `byte_nibbles`) bit for bit.

__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the nibbles at bits [0, 4) and [16, 20) of t as an exact bf16 pair;
// kFlip 0x00080008 for two's complement nibbles, 0 for ones biased by 8
template <uint32_t kFlip>
__device__ __forceinline__ uint32_t low_pair(uint32_t t) {
  return u32(__hadd2(bf2((t & 0x000F000Fu) ^ (0x43004300u | kFlip)),
                     bf2(0xC308C308u)));                  // - 136
}

// byte c of v, two's complement nibbles, as (low nibble, high nibble): one
// permute takes byte c of v and of vh = v >> 4 (whose low nibble is v's
// high one) to bytes 0 and 2
__device__ __forceinline__ uint32_t byte_pair(uint32_t v, uint32_t vh,
                                              int c) {
  return low_pair<0x00080008u>(
      __byte_perm(v, vh, c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12)));
}

// ---------------------------------------------------------------------------
// weight formats.  A policy W states: kNatural (x staged by stage_natural,
// else stage_planes), kNativeX (stage_natural's native order), kChunk (the
// pairs a warp reads before their products), kMinBlocks (the launch bound
// at 8 rows: blocks an SM, 3 at most at 16),
// fits(K, N) (its shape rule), map() (the weight's tensor map),
// stage_bytes<kBN>(), copy<kBN>() (the producer's TMA of tile `tile` at
// columns n0), Raw (a thread's words of one pair), load() (pair pr of the
// stage), frags() (the A fragments a[h][m] of the warp's column tiles h and
// the pair's MMAs m) and col(g, h, e) (the warp-local output column of MMA
// row g + 8e of tile h).

// planes (kF = kPlanes) and bf16-pair words (kPairs): a tile is 16 word
// rows x kBN words, one TMA box of (32 words, 16 rows, kBN / 32 column
// groups): the map's dims (32, K/8, N/32) with strides 4N and 128 bytes,
// so that group b's rows of 128 bytes land at 2048 b, warp w's 32 columns
// in group w.  Pair pr of the tile is word rows 8 (pr / 2) + 2t + pr % 2:
// thread (g, t) reads the 4 words of columns 4g .. 4g+3 at word row i = 2t
// + pr % 2 of its 8 (one 16-byte load; the rows of a quarter-warp land on
// distinct chunks: g ^ i over g in {2q, 2q+1}, t < 4); MMA m takes planes
// (2m, 2m+4) and (2m+1, 2m+5), x's quad of that word row is
// stage_planes'.
// Planes: the ragged route's shifts (`nibble_pair`).  Pairs: bytes 0, 1 of
// the word hold planes (0, 2), (4, 6), bytes 2, 3 planes (1, 3), (5, 7),
// already biased; a permute puts bytes 0, 1 (and 2, 3) at bits 0 and 16,
// whose low nibbles are MMA 0's planes and, shifted by 4, high nibbles MMA
// 1's.
template <int kF>
struct WordsF {
  static constexpr int kTileK = 8 * kWordRows;
  static constexpr bool kNatural = false;
  static constexpr bool kNativeX = false;
  static constexpr int kChunk = 4;
  static constexpr int kMinBlocks = 4;
  static bool fits(int K, int N) { return K % 64 == 0 && N % 32 == 0; }
  template <int kBN>
  static bool map(CUtensorMap* m, const void* w, int K, int N) {
    const cuuint64_t d[3] = {32, (cuuint64_t)(K / 8), (cuuint64_t)(N / 32)};
    const cuuint64_t st[2] = {(cuuint64_t)N * 4, 128};
    const cuuint32_t b[3] = {32, kWordRows, kBN / 32};
    return rows::make_map(m, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, w, d, st, b);
  }
  template <int kBN>
  __host__ __device__ static constexpr int stage_bytes() {
    return kWordRows * 4 * kBN;
  }
  template <int kBN>
  __device__ static void copy(unsigned char* st, const CUtensorMap* map,
                              int n0, int tile, uint64_t* bar) {
    rows::tma_3d(st, map, 0, kWordRows * tile, n0 / 32, bar);
  }
  typedef uint4 Raw;
  __device__ static void load(const unsigned char* st, int warp, int lane,
                              int pr, Raw* r) {
    const int g = lane >> 2, i = 2 * (lane & 3) + (pr & 1);
    *r = *reinterpret_cast<const uint4*>(
        st + warp * kWordRows * 128 + (8 * (pr >> 1) + i) * 128 +
        ((g ^ i) << 4));
  }
  __device__ static void frags(const Raw& r, uint32_t (&a)[2][2][4]) {
    const uint32_t v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (kF == kPlanes) {
        a_frags<kPlanes>(v, h, a[h]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // column 4g + 2h + e: MMA row g + 8e
          const uint32_t t0 = __byte_perm(v[2 * h + e], 0u, 0x4140);
          const uint32_t t1 = __byte_perm(v[2 * h + e], 0u, 0x4342);
          a[h][0][e] = low_pair<0u>(t0);
          a[h][0][2 + e] = low_pair<0u>(t1);
          a[h][1][e] = low_pair<0u>(t0 >> 4);
          a[h][1][2 + e] = low_pair<0u>(t1 >> 4);
        }
      }
    }
  }
  __device__ static int col(int g, int h, int e) { return 4 * g + 2 * h + e; }
};

// the split-half bytes' unpack: byte c of w → (plane j, plane j + 4) as an
// exact bf16 pair, wh = w >> 4 beside it (the probes K15b and K15e vary
// it)
struct ByteNibbles {
  __device__ static uint32_t pair(uint32_t w, uint32_t wh, int c) {
    return byte_pair(w, wh, c);
  }
};

// split-half bytes, viewed as (4, K/8, N): group j's byte row k8 holds
// plane j low and plane j + 4 high.  A tile is word rows 16 tile .. + 15 of
// the four groups, kBN / 128 boxes of (4, 16, 128) bytes (the map: dims
// (N, K/8, 4), strides N and K/8 * N bytes), byte row 16j + r of a box at
// 128(16j + r).  Thread (g, t) reads 4 bytes (columns 4g .. 4g+3) of pair
// pr's word row r = 8 (pr / 2) + 2t + pr % 2 in each group j (4-byte
// loads; a warp's 32 land on 32 distinct banks), and builds WordsF's
// fragments from them.
template <class U = ByteNibbles>
struct BytesF {
  static constexpr int kTileK = 8 * kWordRows;
  static constexpr bool kNatural = false;
  static constexpr bool kNativeX = false;
  static constexpr int kChunk = 4;
  static constexpr int kMinBlocks = 4;
  static bool fits(int K, int N) { return K % 64 == 0 && N % 32 == 0; }
  static constexpr int kBox = 4 * kWordRows * 128;   // a box's bytes
  template <int kBN>
  static bool map(CUtensorMap* m, const void* w, int K, int N) {
    const cuuint64_t d[3] = {(cuuint64_t)N, (cuuint64_t)(K / 8), 4};
    const cuuint64_t st[2] = {(cuuint64_t)N, (cuuint64_t)(K / 8) * N};
    const cuuint32_t b[3] = {128, kWordRows, 4};
    return rows::make_map(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, d, st, b);
  }
  template <int kBN>
  __host__ __device__ static constexpr int stage_bytes() {
    return kBox * kBN / 128;
  }
  template <int kBN>
  __device__ static void copy(unsigned char* st, const CUtensorMap* map,
                              int n0, int tile, uint64_t* bar) {
#pragma unroll
    for (int b = 0; b < kBN / 128; ++b)
      rows::tma_3d(st + b * kBox, map, n0 + 128 * b, kWordRows * tile, 0,
                   bar);
  }
  typedef uint4 Raw;
  __device__ static void load(const unsigned char* st, int warp, int lane,
                              int pr, Raw* r) {
    const int g = lane >> 2, i = 2 * (lane & 3) + (pr & 1);
    const int chunk = 2 * (warp & 3) + (g >> 2);
    const unsigned char* p = st + (warp >> 2) * kBox +
                             (8 * (pr >> 1) + i) * 128 +
                             ((chunk ^ i) << 4) + 4 * (g & 3);
    constexpr int kGroup = kWordRows * 128;
    r->x = *reinterpret_cast<const uint32_t*>(p);
    r->y = *reinterpret_cast<const uint32_t*>(p + kGroup);
    r->z = *reinterpret_cast<const uint32_t*>(p + 2 * kGroup);
    r->w = *reinterpret_cast<const uint32_t*>(p + 3 * kGroup);
  }
  __device__ static void frags(const Raw& r, uint32_t (&a)[2][2][4]) {
    const uint32_t v[4] = {r.x, r.y, r.z, r.w};
    const uint32_t vh[4] = {r.x >> 4, r.y >> 4, r.z >> 4, r.w >> 4};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 0; m < 2; ++m) {        // a_frags<kBytes>'s order
        a[h][m][0] = U::pair(v[2 * m], vh[2 * m], 2 * h);
        a[h][m][1] = U::pair(v[2 * m], vh[2 * m], 2 * h + 1);
        a[h][m][2] = U::pair(v[2 * m + 1], vh[2 * m + 1], 2 * h);
        a[h][m][3] = U::pair(v[2 * m + 1], vh[2 * m + 1], 2 * h + 1);
      }
  }
  __device__ static int col(int g, int h, int e) { return 4 * g + 2 * h + e; }
};

// int8 (K, N): a tile is 64 k rows x kBN columns, kBN / 128 boxes of 64
// rows x 128 bytes (the many-row body's Int8W map: dims (N, K), boxes
// (128, 64)): 8 KB a stage, as an int4 tile of 128 k.  For each 16 columns h
// of its warp, a thread's ldmatrix.x4.trans over k rows 32 pr .. + 31 gives
// the bytes of k 2t, 2t+1 (and + 8, + 16, + 24) at columns 2g, 2g + 1: the
// MMA's row g is column 16h + 2g, row g + 8 column 16h + 2g + 1 (Int8W's
// half(), read and converted in two steps).  kC pairs a chunk (K15a's bc /
// 32; K14: 4).
template <int kC = 4, int kMinB = 4>
struct Int8F {
  static constexpr int kTileK = 64;
  static constexpr bool kNatural = true;
  static constexpr bool kNativeX = false;
  static constexpr int kChunk = kC;
  static constexpr int kMinBlocks = kMinB;
  static bool fits(int K, int N) { return K % 8 == 0 && N % 16 == 0; }
  template <int kBN>
  static bool map(CUtensorMap* m, const void* w, int K, int N) {
    return rows::Int8W::wmap(m, w, K, N);
  }
  template <int kBN>
  __host__ __device__ static constexpr int stage_bytes() {
    return kTileK * kBN;
  }
  template <int kBN>
  __device__ static void copy(unsigned char* st, const CUtensorMap* map,
                              int n0, int tile, uint64_t* bar) {
#pragma unroll
    for (int b = 0; b < kBN / 128; ++b)
      rows::tma_2d(st + b * 128 * kTileK, map, n0 + 128 * b, kTileK * tile,
                   bar);
  }
  struct Raw {
    uint32_t m[2][4];
  };
  __device__ static void load(const unsigned char* st, int warp, int lane,
                              int pr, Raw* r) {
    const int k = 32 * pr + (lane & 7) + 8 * (lane >> 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 32 * warp + 16 * h;
      p2t::ldmatrix_x4_trans(r->m[h], st + (col >> 7) * 128 * kTileK +
                                          k * 128 +
                                          ((((col & 127) >> 4) ^ (k & 7))
                                           << 4));
    }
  }
  __device__ static void frags(const Raw& r, uint32_t (&a)[2][2][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = r.m[h][i] ^ 0x80808080u;
      a[h][0][0] = rows::int8_pair(u[0], 0);
      a[h][0][1] = rows::int8_pair(u[0], 1);
      a[h][0][2] = rows::int8_pair(u[1], 0);
      a[h][0][3] = rows::int8_pair(u[1], 1);
      a[h][1][0] = rows::int8_pair(u[2], 0);
      a[h][1][1] = rows::int8_pair(u[2], 1);
      a[h][1][2] = rows::int8_pair(u[3], 0);
      a[h][1][3] = rows::int8_pair(u[3], 1);
    }
  }
  __device__ static int col(int g, int h, int e) {
    return 16 * h + 2 * g + e;
  }
};

// ---------------------------------------------------------------------------
// the body

template <int kBN, int kNT>
__host__ __device__ constexpr int part_units() {  // float4s of a partial
  return 8 * kNT * kBN / 4;
}

// bytes of the cluster's receive buffer: rank q owns the float4s i with i
// % Ck == q, and holds each rank's copy of them in rank order
template <int kBN, int kNT>
__host__ __device__ int recv_bytes(int ck) {
  return ck == 1 ? 0
                 : ck * ((part_units<kBN, kNT>() + ck - 1) / ck) * 16;
}

// shared memory: the ring, the receive buffer, x, the mbarriers; xstride:
// bytes of a staged x row
template <class W, int kBN>
__host__ __device__ constexpr int ring_bytes(int stages) {
  return stages * W::template stage_bytes<kBN>();
}

// grid (Ck, column blocks, row blocks of 8 kNT) in clusters of the Ck blocks
// that split one output tile's K; block kx sums K tiles [kx * per, (kx + 1)
// * per).  Warps 0 .. kBN/32 - 1 consume, warp kBN/32 produces.
template <class W, typename T, typename To, int kBN, int kNT>
__global__ void __launch_bounds__(kBN + 32,
                                  kBN == 256 ? 1
                                  : kNT == 1 ? W::kMinBlocks
                                  : W::kMinBlocks < 3 ? W::kMinBlocks : 3)
few_rows_kernel(const __grid_constant__ CUtensorMap wmap,
                const T* __restrict__ x, const float* __restrict__ scale,
                To* __restrict__ out, int R, int K, int N, int stages,
                int xstride) {
  constexpr int kW = kBN / 32;
  constexpr int kConsumers = 32 * kW;
  constexpr int kRows = 8 * kNT;
  constexpr int kStage = W::template stage_bytes<kBN>();
  constexpr int kChunk = W::kChunk;
  constexpr int kTile = W::kTileK;             // k values a stage holds
  constexpr int kTilePairs = kTile / 32;       // pairs of k16 steps a tile
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int S = stages;
  const int Ck = gridDim.x, kx = blockIdx.x;
  float4* recv = reinterpret_cast<float4*>(ring + ring_bytes<W, kBN>(S));
  unsigned char* xs =
      reinterpret_cast<unsigned char*>(recv) + recv_bytes<kBN, kNT>(Ck);
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + kRows * xstride);
  uint64_t* empty = full + S;

  const int tiles = (K + kTile - 1) / kTile;
  const int per = (tiles + Ck - 1) / Ck, t0 = kx * per;
  const int nt = max(0, min(tiles, t0 + per) - t0);
  const int n0 = blockIdx.y * kBN, r0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&wmap) : "memory");
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this block has started: the cluster's pushes below may target it once
  // every rank has arrived here (waited for just before them)
  if (Ck > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[kNT][2][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][h][c] = 0.f;

  if (warp == kW) {
    // the producer: tile i into stage i % S once the consumers released
    // tile i - S there
    if (lane == 0)
      for (int i = 0, s = 0, ph = 0; i < nt; ++i) {
        if (i >= S) mbar_wait(&empty[s], ph ^ 1);
        mbar_expect(&full[s], kStage);
        W::template copy<kBN>(ring + s * kStage, &wmap, n0, t0 + i, &full[s]);
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
  } else {
    // x's slice, staged once while the producer's first copies fly, in
    // units of 64 k (8 quads a row)
    constexpr int kUnits = kTile / kUnitK;
    const int nu = kUnits * nt;
    for (int e = tid; e < kRows * nu; e += kConsumers) {
      const int r = e / nu, i = e - r * nu;
      const T* xr = r0 + r < R ? x + (int64_t)(r0 + r) * K : nullptr;
      uint4* q = reinterpret_cast<uint4*>(xs + r * xstride) + 8 * i;
      if constexpr (W::kNatural)
        stage_natural<T, !W::kNativeX>(xr, K, kUnits * t0 + i, q);
      else
        stage_planes<T>(xr, K, kUnits * t0 + i, q);
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

    // pair p's quad of x row g (+ 8n): xq + n * 8 * xstride + 64 p
    const unsigned char* xq = xs + g * xstride + 16 * t;
    const int npairs = kTilePairs * nt;
    for (int p0 = 0; p0 < npairs; p0 += kChunk) {
      typename W::Raw raw[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int p = p0 + c;
        if (p < npairs) {
          const int i = p / kTilePairs, s = i % S;
          if (p % kTilePairs == 0) mbar_wait(&full[s], (i / S) & 1);
          W::load(ring + s * kStage, warp, lane, p % kTilePairs, &raw[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int p = p0 + c;
        if (p < npairs) {
#ifdef P2T_FEW_STREAM_ONLY
          // the stream alone, for scripts/few_stream_ceiling.py: a use of
          // the loaded words, no conversion, no product
          acc[0][0][0] += __uint_as_float(
              reinterpret_cast<const uint32_t*>(&raw[c])[0] & 0x3F800000u);
          continue;
#endif
          uint32_t a[2][2][4];
          W::frags(raw[c], a);
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            const uint4 b = *reinterpret_cast<const uint4*>(
                xq + n * 8 * xstride + 64 * p);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mma_bf16(acc[n][h], a[h][0], b.x, b.y);
              mma_bf16(acc[n][h], a[h][1], b.z, b.w);
            }
          }
        }
      }
      // the chunk's stages are read and used: release the tiles it ended
      __syncwarp();
      if (lane == 0)
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int p = p0 + c;
          if (p < npairs && p % kTilePairs == kTilePairs - 1)
            mbar_arrive(&empty[(p / kTilePairs) % S]);
        }
    }
  }

  // acc[n][h]: (c0, c1) = column W::col(g, h, 0), x rows 8n + 2t and 8n +
  // 2t + 1; (c2, c3) = column W::col(g, h, 1) (the next one), the same rows
  if (Ck == 1) {
    if (warp < kW) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + 32 * warp + W::col(g, h, 0);  // even
        if (col >= N) continue;          // N even here: col + 1 < N too
        const float s0 = scale ? scale[col] : 1.f;
        const float s1 = scale ? scale[col + 1] : 1.f;
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int row = r0 + 8 * n + 2 * t + rr;
            if (row >= R) continue;
            const float y0 = acc[n][h][rr] * s0, y1 = acc[n][h][2 + rr] * s1;
            To* o = out + (int64_t)row * N + col;
            if constexpr (std::is_same<To, float>::value)
              *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
            else
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __floats2bfloat162_rn(y0, y1);
          }
      }
    }
    return;
  }

  // the cluster's sum: float4 i of the (kRows, kBN) partial (row i /
  // (kBN/4), columns 4 (i % (kBN/4)) ..) belongs to rank i % Ck; every rank
  // pushes its copy of it into slot [kx][i / Ck] of that rank's receive
  // buffer (a region nothing else touches), and after one cluster barrier
  // each rank sums its slots over the ranks in order 0 .. Ck-1 (the same
  // bits on every launch) and writes them; no rank reads another's shared
  // memory after the barrier, so none waits for another to finish
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kUnitsRow = kBN / 4;
  const int share = (part_units<kBN, kNT>() + Ck - 1) / Ck;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp < kW)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = 32 * warp + W::col(g, h, 0);        // even
          const int i = (8 * n + 2 * t + rr) * kUnitsRow + c / 4;
          float* dst = reinterpret_cast<float*>(recv + kx * share + i / Ck) +
                       (c & 2);
          *reinterpret_cast<float2*>(cluster.map_shared_rank(dst, i % Ck)) =
              make_float2(acc[n][h][rr], acc[n][h][2 + rr]);
        }
  cluster.sync();                  // every rank's pushes are in place

  const int live = min(kRows, R - r0) * kUnitsRow;
  for (int j = tid; j < share; j += blockDim.x) {
    const int i = j * Ck + kx;
    if (i >= live) break;
    float4 s = recv[j];
    for (int q = 1; q < Ck; ++q) {
      const float4 v = recv[q * share + j];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int row = i / kUnitsRow, col = n0 + 4 * (i % kUnitsRow);
    if (col < N) {                 // N % 4 == 0: all 4 or none
      if (scale) {
        s.x *= scale[col];
        s.y *= scale[col + 1];
        s.z *= scale[col + 2];
        s.w *= scale[col + 3];
      }
      To* o = out + (int64_t)(r0 + row) * N + col;
      if constexpr (std::is_same<To, float>::value) {
        *reinterpret_cast<float4*>(o) = s;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(s.x, s.y);
        *reinterpret_cast<__nv_bfloat162*>(o + 2) =
            __floats2bfloat162_rn(s.z, s.w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the host path

// W's map of weight w through a table of encoded maps: a map is a function
// of what it encodes (the address and shape; the box is W's), so an entry
// that matches them is that map.  Decode steps call this body with the same
// weights again and again, and a call's host time paces them.
template <class W, int kBN>
bool cached_map(CUtensorMap* map, const void* w, int K, int N) {
  struct Entry {
    CUtensorMap m;
    const void* w = nullptr;
    int K = 0, N = 0;
  };
  static Entry table[kMapSlots];
  static std::mutex mu;
  const uint64_t h = (static_cast<uint64_t>(reinterpret_cast<uintptr_t>(w)) *
                          0x9E3779B97F4A7C15ull +
                      static_cast<uint64_t>(K) * 1315423911u + N) >>
                     52;                                 // 12 bits
  std::lock_guard<std::mutex> lock(mu);
  Entry& e = table[h % kMapSlots];
  if (e.w != w || e.K != K || e.N != N) {
    e.w = nullptr;
    if (!W::template map<kBN>(&e.m, w, K, N)) return false;
    e.w = w;
    e.K = K;
    e.N = N;
  }
  *map = e.m;
  return true;
}

// bytes of dynamic shared memory at K, Ck and S stages, and a staged x
// row's stride (quads of the rank's tiles, 4 mod 8 chunks: conflict-free)
template <class W, int kBN, int kNT>
int smem_bytes(int K, int ck, int stages, int* xstride) {
  const int tiles = (K + W::kTileK - 1) / W::kTileK;
  const int per = (tiles + ck - 1) / ck;
  *xstride = per * 2 * W::kTileK + kXPad;
  return 1024 + ring_bytes<W, kBN>(stages) + recv_bytes<kBN, kNT>(ck) +
         8 * kNT * *xstride + 16 * stages;
}

template <class W, typename T, typename To, int kBN, int kNT>
cudaError_t launch_few(const CUtensorMap& map, const void* x,
                       const float* scale, void* out, int R, int K, int N,
                       int ck, int stages, cudaStream_t stream) {
  int xstride = 0;
  const int bytes = smem_bytes<W, kBN, kNT>(K, ck, stages, &xstride);
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  auto kern = few_rows_kernel<W, T, To, kBN, kNT>;
  // the shared-memory limit, once per device: a call's host time paces
  // the decode steps that launch this body
  static unsigned set_on = 0;                   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(set_on & (1u << dev))) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
    if (e != cudaSuccess) return e;
    if (dev < 32) set_on |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ck, (N + kBN - 1) / kBN, (R + 8 * kNT - 1) / (8 * kNT));
  cfg.blockDim = dim3(kBN + 32);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ck;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ck > 1 ? 1 : 0;                // a cluster only to split K
  e = cudaLaunchKernelEx(&cfg, kern, map, static_cast<const T*>(x), scale,
                         static_cast<To*>(out), R, K, N, stages, xstride);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The body with weight policy W, x of type T and out of type To, kBN
// columns a block (128 or 256), K split over ck blocks of a cluster (1 ..
// 8, no rank empty), `stages` ring stages (one more than the tiles of a
// chunk at least); 8 rows a block up to 8 rows,
// else 16 (grid z over row blocks); cudaErrorInvalidValue for operands
// outside the contract.  The caller's rule picks ck and stages
// (kernels/quant_matmul.py few_rows_tiling).
template <class W, typename T, typename To, int kBN>
int run(const void* x, const void* w, const float* scale, void* out, int R,
        int K, int N, int ck, int stages, cudaStream_t s) {
  const int tiles = (K + W::kTileK - 1) / W::kTileK;
  if (R <= 0 || K <= 0 || N <= 0 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15) || !W::fits(K, N) || ck < 1 ||
      ck > kMaxCluster || ck > tiles ||
      (ck - 1) * ((tiles + ck - 1) / ck) >= tiles ||
      stages < (32 * W::kChunk + W::kTileK - 1) / W::kTileK + 1 ||
      stages > 32 ||
      (N + kBN - 1) / kBN > 65535 || (R + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!cached_map<W, kBN>(&map, w, K, N)) return (int)cudaErrorInvalidValue;
  if (R <= 8)
    return (int)launch_few<W, T, To, kBN, 1>(map, x, scale, out, R, K, N, ck,
                                             stages, s);
  return (int)launch_few<W, T, To, kBN, 2>(map, x, scale, out, R, K, N, ck,
                                           stages, s);
}

// run() in x's dtype (p2t::DType), y in the same type
template <class W, int kBN = 128>
int run_dtype(const void* x, const void* w, const void* scale, void* out,
              int R, int K, int N, int ck, int stages, int dtype,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  using bf16 = __nv_bfloat16;
  if (dtype == p2t::kFloat32)
    return run<W, float, float, kBN>(x, w, sc, out, R, K, N, ck, stages, s);
  if (dtype == p2t::kBFloat16)
    return run<W, bf16, bf16, kBN>(x, w, sc, out, R, K, N, ck, stages, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace few
}  // namespace

// K11a's and K11b's instantiations (few::BytesF, few::WordsF<kPairs>), in a
// translation unit of their own (quant_matmul_int4.cu):
// p2t_quant_matmul_few's arguments, fmt kBytes or kPairs
extern "C" int p2t_quant_matmul_few_int4(const void* x, const void* w,
                                         const void* scale, void* out, int R,
                                         int K, int N, int fmt, int ck,
                                         int stages, int dtype, void* stream);
