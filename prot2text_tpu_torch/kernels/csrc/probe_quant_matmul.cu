// K15a-e: the weight-quantized matmul variants of the TPU probe scripts,
// products at Llama-3.1-8B and Qwen3-14B widths (16 rows),
//
//   y[r, n] = (sum_k bf16(x[r, k]) * q[k, n]) * scale[n]
//
// x (R, K) bf16; fp32 accumulation; the scale (N,) f32 in the fp32
// epilogue; y (R, N) bf16.  Each of K15a-e keeps the one strategy its probe
// varies and takes the rest from K10/K11/K14's few-row TMA body
// (quant_matmul.cuh: the TMA weight ring, x staged once, the fragment
// builders, mma.sync m16n8k16, K split over a cluster) through a weight
// policy of that body (namespace few) that overrides only what its probe
// varies, so the card's answer isolates that strategy.  Shapes TMA cannot
// describe (the byte formats at N % 16 != 0, planes at N % 4 != 0) take
// the same policies' forms on the ragged route (quant_matmul_ragged.cuh),
// as K10/K11/K14 do:
//
//   K15a chunk_mm (scripts/bench_lmhead3.py:65, body :42): int8 q (K, N);
//        the TPU kernel converts its int8 tile to bf16 in sub-chunks of bc
//        rows.  Here a warp reads bc k rows of its columns from the ring
//        into registers before it converts them and runs their products
//        (`few::Int8F<bc / 32>`; bc 128 is K14's policy).
//   K15b mm_i4f (bench_int4_unpack.py:96, body :71): split-half bytes
//        (K/2, N) as K11a; each byte unpacked in f32 arithmetic: hi =
//        floor(w / 16), lo = w - 16 hi, lo -= 16 when lo >= 8.
//   K15c mm_i4n (bench_int4_unpack.py:138, body :119): a native int4 weight
//        (K, N); the port's layout (kernels/probe_quant_matmul.py
//        pack_int4_native) holds k rows 2i and 2i + 1 of a column in the low
//        and high nibble of byte [i, n], so one byte is one bf16 pair of an
//        A fragment and x is staged in plain k order within a step.
//   K15d mm_i4p (bench_int4_planes.py:95, body :72): K10's nibble planes
//        over the probe's tile sweep: 128 or 256 columns per block, the K
//        slice per cluster rank.  At 128 columns and K10's grid it is K10's
//        policy, bit for bit.
//   K15e mm_i4and (bench_int4_single.py:86, body :59): split-half bytes,
//        unpacked with AND masks: lo_u = w & 0xF and hi_u = (w >> 4) & 0xF
//        side by side, then 0x4300 | (u ^ 8) is the bf16 of 136 + value and
//        one bf16x2 subtraction of 136 leaves (lo_u - 16 [lo_u >= 8], (w -
//        lo_u) / 16) exactly, with no int -> float conversion.
//   (K15g mm_mix, bench_int8_mxu.py:156, runs the many-row body through
//   quant_matmul_rows.cu's entry point.)
//
// K15b and K15e build K11a's fragments from the same bytes, so on the same
// integers they equal K11a (and K10) bit for bit; only the unpack differs.
//
// Bound: bytes, as K10/K14 (the header states the design).  At R 16 the
// weight dominates: one int4 call at (4096, 14336) reads 29.4 MB, 8.8 us at
// 3.35 TB/s; K15a's LM head (4096, 128256) int8 525 MB, 157 us; K15e's
// (5120, 17408) 44.6 MB, 13.3 us.
#include "quant_matmul.cuh"  // and the ragged route

namespace {

// f32-arithmetic unpack of split-half byte c of w: (lo, hi) as one bf16 pair
__device__ __forceinline__ uint32_t floor_pair(uint32_t w, int c) {
  const float wf = static_cast<float>(byte_at(w, c));
  const float hi = floorf(wf * (1.f / 16.f));
  float lo = wf - hi * 16.f;                     // [0, 15]
  lo -= lo >= 8.f ? 16.f : 0.f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// AND unpack of split-half byte c of w (wh = w >> 4): the masks give lo_u
// = w & 0xF and hi_u = (w >> 4) & 0xF of every byte at once, a permute puts
// byte c's at bits [0, 4) and [16, 20); bit 3 flipped, 0x4300 | u is the
// bf16 of 128 + (u ^ 8), and 136 off leaves lo_u - 16 [lo_u >= 8] and (w -
// lo_u) / 16, exactly, with no int -> float conversion
__device__ __forceinline__ uint32_t and_pair(uint32_t w, uint32_t wh,
                                             int c) {
  return few::low_pair<0x00080008u>(__byte_perm(
      w & 0x0F0F0F0Fu, wh & 0x0F0F0F0Fu,
      c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12)));
}

// K15a: K14's int8 loads and fragments with kU steps loaded ahead
template <int kU>
struct Int8Rows : FormatPolicy<kInt8, true> {
  static constexpr int kUnroll = kU;
};

// K15b / K15e: K11a's split-half byte loads and k order, another unpack
template <int kUnpack>          // 0 f32 floor (K15b), 1 AND (K15e)
struct BytesUnpack : FormatPolicy<kBytes, true> {
  __device__ static uint32_t pair(uint32_t w, int c) {
    return kUnpack == 0 ? floor_pair(w, c) : and_pair(w, w >> 4, c);
  }
  __device__ static void frags(const uint32_t (&v)[4], int h,
                               uint32_t (&a)[2][4]) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {     // a_frags<kBytes>'s order
      a[m][0] = pair(v[2 * m], 2 * h);
      a[m][1] = pair(v[2 * m], 2 * h + 1);
      a[m][2] = pair(v[2 * m + 1], 2 * h);
      a[m][3] = pair(v[2 * m + 1], 2 * h + 1);
    }
  }
};

// K15c: native int4, k rows 2i and 2i + 1 in byte row i.  A step of 32 k
// loads byte rows 16 step + 4t + i (i < 4) with K14's 4-byte row loads over
// the (K/2, N) bytes; MMA m takes byte rows 2m (k 2t, 2t+1) and 2m + 1 (k
// 2t+8, 2t+9), so thread t's B fragments are x[32 step + 8t .. + 8): x is
// staged in plain k order
struct Native : FormatPolicy<kBytes, true> {
  __device__ static void load(const void* w, int step, int nc, int t, int K,
                              int N, uint32_t (&v)[4]) {
    load_step<kInt8, true>(w, step, nc, t, K / 2, N, v);
  }
  __device__ static void frags(const uint32_t (&v)[4], int h,
                               uint32_t (&a)[2][4]) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      a[m][0] = byte_nibbles(v[2 * m], 2 * h);
      a[m][1] = byte_nibbles(v[2 * m], 2 * h + 1);
      a[m][2] = byte_nibbles(v[2 * m + 1], 2 * h);
      a[m][3] = byte_nibbles(v[2 * m + 1], 2 * h + 1);
    }
  }
  __device__ static void slot(int q, int sb, int K, int* k, int* pos) {
    *k = kStepK * sb + q;
    *pos = q;
  }
};

// the few-row TMA body's probe policies

struct FloorUnpack {
  __device__ static uint32_t pair(uint32_t w, uint32_t, int c) {
    return floor_pair(w, c);
  }
};

struct AndUnpack {
  __device__ static uint32_t pair(uint32_t w, uint32_t wh, int c) {
    return and_pair(w, wh, c);
  }
};

// K15c on the TMA body: the native int4 (K/2, N) bytes, a tile 64 byte rows
// x kBN bytes, kBN / 128 boxes of 64 rows x 128 bytes (the map: dims (N,
// K/2), boxes (128, 64)).  Thread (g, t) takes columns 4g .. 4g+3 (4 bytes)
// of byte rows 16 pr + 8m + 2t (MMA m's kk 2t, 2t+1: k 4t, 4t+1 of step
// 2pr + m) and the next one (kk 2t+8, 2t+9: k 4t+2, 4t+3), so x is in
// plain k order within a step (stage_natural's native quads); a warp's 32
// loads land on 32 distinct banks.
struct NativeF : few::BytesF<> {
  static constexpr bool kNatural = true;
  static constexpr bool kNativeX = true;
  template <int kBN>
  static bool map(CUtensorMap* m, const void* w, int K, int N) {
    return rows::make_wmap_2d(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K / 2,
                              N, 128, kTileK / 2);
  }
  template <int kBN>
  __device__ static void copy(unsigned char* st, const CUtensorMap* map,
                              int n0, int tile, uint64_t* bar) {
#pragma unroll
    for (int b = 0; b < kBN / 128; ++b)
      rows::tma_2d(st + b * kBox, map, n0 + 128 * b, kTileK / 2 * tile,
                   bar);
  }
  __device__ static void load(const unsigned char* st, int warp, int lane,
                              int pr, Raw* r) {
    const int g = lane >> 2, t = lane & 3;
    const int chunk = 2 * (warp & 3) + (g >> 2);
    const unsigned char* box = st + (warp >> 2) * kBox + 4 * (g & 3);
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {      // rows 2t, 2t + 1 of steps m = e / 2
      const int row = 16 * pr + 8 * (e >> 1) + 2 * t + (e & 1);
      v[e] = *reinterpret_cast<const uint32_t*>(
          box + row * 128 + ((chunk ^ (row & 7)) << 4));
    }
    *r = make_uint4(v[0], v[1], v[2], v[3]);
  }
  __device__ static void frags(const Raw& r, uint32_t (&a)[2][2][4]) {
    const uint32_t v[4] = {r.x, r.y, r.z, r.w};
    const uint32_t vh[4] = {r.x >> 4, r.y >> 4, r.z >> 4, r.w >> 4};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        a[h][m][0] = few::byte_pair(v[2 * m], vh[2 * m], 2 * h);
        a[h][m][1] = few::byte_pair(v[2 * m], vh[2 * m], 2 * h + 1);
        a[h][m][2] = few::byte_pair(v[2 * m + 1], vh[2 * m + 1], 2 * h);
        a[h][m][3] = few::byte_pair(v[2 * m + 1], vh[2 * m + 1], 2 * h + 1);
      }
  }
};

}  // namespace

// variant 0 K15a (param: bc in {32, 64, 128, 256}; w (K, N) int8), 1 K15b
// (w (K/2, N) int8 split-half bytes), 2 K15c (w (K/2, N) int8 native int4,
// k pairs per byte), 3 K15d (param: columns per block, 128 or 256; w (K/8,
// N) int32 planes), 4 K15e (as K15b): bf16 out, the scale needed, splits
// >= 1 slices of K (in steps of 16 k values for int8, 32 for int4), with
// `partial` an (splits, R, N) fp32 scratch buffer when splits > 1.  The
// wrapper checks x bf16 (R, K), N % 4 == 0 and a 16-byte-aligned weight.
extern "C" int p2t_probe_quant_matmul(const void* x, const void* w,
                                      const void* scale, void* out,
                                      void* partial, int R, int K, int N,
                                      int variant, int param, int splits,
                                      void* stream) {
  const int k_mult = variant == 3 ? 8 : variant == 0 ? 1 : 2;
  const int step_k = variant == 0 ? 16 : 32;
  if (R <= 0 || K <= 0 || N <= 0 || K % k_mult != 0 || N % 4 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || splits <= 0 ||
      splits > 65535 || (splits > 1 && partial == nullptr) ||
      splits > (K + step_k - 1) / step_k || (N + 127) / 128 > 65535 ||
      scale == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(partial);
  using bf16 = __nv_bfloat16;
  switch (variant) {
    case 0:
      if (param == 32)
        return (int)launch<Int8Rows<2>, bf16, bf16>(x, w, sc, out, pt, R, K,
                                                    N, splits, s);
      if (param == 64)
        return (int)launch<Int8Rows<4>, bf16, bf16>(x, w, sc, out, pt, R, K,
                                                    N, splits, s);
      if (param == 128)         // K14's policy
        return (int)launch<FormatPolicy<kInt8, true>, bf16, bf16>(
            x, w, sc, out, pt, R, K, N, splits, s);
      if (param == 256)
        return (int)launch<Int8Rows<16>, bf16, bf16>(x, w, sc, out, pt, R,
                                                     K, N, splits, s);
      return (int)cudaErrorInvalidValue;
    case 1:
      return (int)launch<BytesUnpack<0>, bf16, bf16>(x, w, sc, out, pt, R, K,
                                                     N, splits, s);
    case 2:
      return (int)launch<Native, bf16, bf16>(x, w, sc, out, pt, R, K, N,
                                             splits, s);
    case 3:
      if (param == 128)         // K10's policy and tiling
        return (int)launch<FormatPolicy<kPlanes, true>, bf16, bf16>(
            x, w, sc, out, pt, R, K, N, splits, s);
      if (param == 256)
        return (int)launch<FormatPolicy<kPlanes, true>, bf16, bf16, 8>(
            x, w, sc, out, pt, R, K, N, splits, s);
      return (int)cudaErrorInvalidValue;
    case 4:
      return (int)launch<BytesUnpack<1>, bf16, bf16>(x, w, sc, out, pt, R, K,
                                                     N, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The TMA body (shapes few_fit takes; the wrapper routes the rest to
// p2t_probe_quant_matmul): variant and param as there, K split over ck
// blocks of a cluster and `stages` ring stages (kernels/quant_matmul.py
// few_rows_tiling, K15d's split_k8 mapped onto ck), bf16 x and out
extern "C" int p2t_probe_quant_matmul_few(const void* x, const void* w,
                                          const void* scale, void* out,
                                          int R, int K, int N, int variant,
                                          int param, int ck, int stages,
                                          void* stream) {
  if (scale == nullptr) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  switch (variant) {
    case 0:
      if (param == 32)
        return few::run<few::Int8F<1>, bf16, bf16, 128>(x, w, sc, out, R, K,
                                                        N, ck, stages, s);
      if (param == 64)
        return few::run<few::Int8F<2>, bf16, bf16, 128>(x, w, sc, out, R, K,
                                                        N, ck, stages, s);
      if (param == 128)         // K14's policy
        return few::run<few::Int8F<>, bf16, bf16, 128>(x, w, sc, out, R, K,
                                                       N, ck, stages, s);
      if (param == 256)
        return few::run<few::Int8F<8, 2>, bf16, bf16, 128>(
            x, w, sc, out, R, K, N, ck, stages, s);
      return (int)cudaErrorInvalidValue;
    case 1:
      return few::run<few::BytesF<FloorUnpack>, bf16, bf16, 128>(
          x, w, sc, out, R, K, N, ck, stages, s);
    case 2:
      return few::run<NativeF, bf16, bf16, 128>(x, w, sc, out, R, K, N, ck,
                                                stages, s);
    case 3:
      if (param == 128)         // K10's policy
        return few::run<few::WordsF<kPlanes>, bf16, bf16, 128>(
            x, w, sc, out, R, K, N, ck, stages, s);
      if (param == 256)
        return few::run<few::WordsF<kPlanes>, bf16, bf16, 256>(
            x, w, sc, out, R, K, N, ck, stages, s);
      return (int)cudaErrorInvalidValue;
    case 4:
      return few::run<few::BytesF<AndUnpack>, bf16, bf16, 128>(
          x, w, sc, out, R, K, N, ck, stages, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
