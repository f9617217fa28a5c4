// K15h-l: the int8 KV-cache probes of scripts/probe_int8_kv.py, the five
// operations its TPU kernels were written to check, as small kernels:
//
//   K15h p1_f32_to_int8_store (:38)   o = int8(clip(rint(mult * x), -127, 127))
//   K15i p2_int8_select (:50)         o[r, :] = r == row ? a[r, :] : b[r, :]
//   K15j p3_dynamic_int8_group_rmw (:62)  in place: cache[b, h, slot, :] =
//        kn[b, h, :] (the TPU kernel rewrote the 32-row int8 tile group
//        slot // 32 around that row; here only the row is written)
//   K15k p4_int8_to_bf16_matmul (:96)  logits[i, t] = (sum_d q[i, d] *
//        c[t, d]) * s[t], q bf16, c int8, f32 out
//   K15l p5_f32_scale_row_rmw (:116)  in place: s[b, h, slot] = sn[b, h]
//
// K15j and K15l read `slot` from device memory, as the Pallas kernels
// prefetched it: nothing is synced to the host; a slot outside [0, T)
// writes nothing.  rint rounds half to even, as jnp.round and torch.round.
//
// K15h and K15i move bytes: 24.6 KB out at the probe's (192, 128), which
// a launch outweighs, and 8.4 MB at one layer of a serving install's keys,
// (65536, 128), where the bytes bound them.  So both move W-byte words:
//   - K15h: a thread loads W floats (at W 16 four 16-byte loads, all in
//     flight before the first convert) and stores its W int8 as one word,
//     the bytes packed in registers (`__byte_perm`).  W is the widest of
//     16, 8, 4, 2, 1 that both addresses allow (x at 4·min(W, 4) bytes,
//     out at W); the n mod W elements past the last word are written by
//     the first threads of the same launch.  fmaxf before fminf, as the
//     kernel before this design: NaN → -127, ±inf → ±127;
//   - K15i: a thread copies one word of b, or of a where the word lies in
//     row `row`: one unsigned compare of the word's index against that
//     row's word range, which the launcher computes (32-bit indices where
//     the words allow), so a is read in that row only.  W is the widest
//     that divides cols and all three addresses: no word straddles rows;
//   - one word a thread (two words a thread measured slower, at both
//     sizes); one block up to kWriteThreads threads, past that blocks of
//     128-1024 threads, as many as cover the words and at least two an SM
//     where the words allow (`word_grid`);
//   - chained launches, as K15j's and K15l's below: only index arithmetic
//     before `grid_dependency_wait` (x, a and b may be the previous
//     kernel's output, and out may be memory that kernel still reads),
//     the trigger after the stores.
//
// K15j and K15l write 1 KB and 32 bytes at the probe's shape, so what
// bounds them is a launch and one memory round trip, not bytes.  So:
//   - one round trip: a thread issues its source load (kn, sn; always in
//     bounds) together with the slot's, both by volatile loads that the
//     compiler can neither sink behind the slot's branch nor reorder, so
//     the two latencies overlap (the kernels before read the slot,
//     branched, then read kn: two dependent trips);
//   - few, wide accesses in one block: K15j moves W bytes a thread, W the
//     widest of 16, 8, 4, 2, 1 that divides D and both addresses (a
//     template choice of the launcher: 16 at D 128 and 64, 8 at D 72), so
//     the probe's B·Hkv·D = 1024 bytes are 64 threads of one 16-byte load
//     and one store; K15l writes B·Hkv floats at a T-float stride, which
//     no vector covers, one warp per 32 values; a block takes up to
//     kWriteThreads, and more blocks come only past that;
//   - chained launches (`p2t::launch_chained`, programmatic dependent
//     launch): before `grid_dependency_wait` a block does only index
//     arithmetic, since the slot, the source and the buffer may all be the
//     previous kernel's output; after its store it calls
//     `launch_dependents`, so in a run of launches (a CUDA graph of calls)
//     each launch's set-up overlaps the kernel before it.  chip_smoke.py
//     times a graph of 10 calls and of 1 call (no launch before it to
//     overlap) behind a busy device: the launch is the cost, and only the
//     chain moves it.
//
// K15k runs on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate), the product transposed, Sᵀ = C·qᵀ: the c rows are the m
// dimension, eight query rows one n8 B fragment (Q 8 needs no padding).
// A block of 4 warps takes 64 rows of c and 8 query rows; it stages its c
// rows (16 bytes a copy), its q rows and its 64 scales in shared memory
// with every cp.async in flight at once, then warp w multiplies rows
// 16w .. 16w + 15 over the head dim.  A lane reads four consecutive bytes
// of c a k16 step and the four matching bf16 of q (the same permutation
// of k on both operands, so the sum is over the same products); the bytes
// become bf16 exactly (the byte in the fp32 2^23 + u, one add, as the
// split decode body's Int8Cache), so every product is exact in fp32, as on
// the MXU, and only the order of the fp32 sums moves.  The epilogue scales
// a row by s[t] and stores it; rows past T and query rows past Q are
// zero-filled and never stored.  Why mma.sync and not wgmma: the work is
// 0.4 MFLOP and one 24.6 KB read at the probe's shape, so a launch and one
// load latency set the time; a warpgroup's 64-row tiles and the TMA
// descriptors they want would add set-up and no speed.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWriteThreads = 1024;   // threads a block at most
constexpr int kSMs = 132;             // the H100 SXM's

// one W-byte word: its type, and a volatile global load of it (issued
// where it stands: never sunk behind a branch nor reordered with another)
template <int W> struct Word;
template <> struct Word<16> {
  using T = uint4;
  static __device__ __forceinline__ T load(const void* p) {
    T v;
    asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
  }
};
template <> struct Word<8> {
  using T = uint2;
  static __device__ __forceinline__ T load(const void* p) {
    T v;
    asm volatile("ld.global.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(v.x), "=r"(v.y) : "l"(p));
    return v;
  }
};
template <> struct Word<4> {
  using T = uint32_t;
  static __device__ __forceinline__ T load(const void* p) {
    T v;
    asm volatile("ld.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
    return v;
  }
};
template <> struct Word<2> {
  using T = uint16_t;
  static __device__ __forceinline__ T load(const void* p) {
    T v;
    asm volatile("ld.global.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
    return v;
  }
};
template <> struct Word<1> {
  using T = uint8_t;
  static __device__ __forceinline__ T load(const void* p) {
    uint16_t v;
    asm volatile("ld.global.u8 %0, [%1];\n" : "=h"(v) : "l"(p));
    return static_cast<T>(v);
  }
};

// the word width's kernel: f(std::integral_constant<int, W>) for W one of
// 16, 8, 4, 2, 1
template <typename F>
cudaError_t by_width(int W, F&& f) {
  switch (W) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 2>{});
    default: return f(std::integral_constant<int, 1>{});
  }
}

// the widest of 16, 8, 4, 2, 1 that divides a (an address or a length)
int widest(uintptr_t a) {
  return (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4
       : (a & 1) == 0 ? 2 : 1;
}

// K15h: int8(clip(rint(mult·x), -127, 127)) in the low byte of the result:
// r + 1.5·2^23 is exact for the clamped integer r and holds r's two's
// complement byte in the low 8 bits of its mantissa
__device__ __forceinline__ uint32_t s8_low(float x, float mult) {
  const float r = fminf(fmaxf(rintf(x * mult), -127.f), 127.f);
  return __float_as_uint(r + 12582912.f);
}

// W floats from p (aligned to 4·min(W, 4) bytes), min(W, 4) a load
template <int W>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[W]) {
  if constexpr (W >= 4) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const float4 f = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = f.x; v[4 * k + 1] = f.y; v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else if constexpr (W == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = *p;
  }
}

// W floats → their W int8 as one word, element 0 in byte 0
template <int W>
__device__ __forceinline__ typename Word<W>::T quantize_word(
    const float (&v)[W], float mult) {
  uint32_t w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = s8_low(v[k], mult);
  if constexpr (W == 1) {
    return static_cast<uint8_t>(w[0]);
  } else if constexpr (W == 2) {
    return static_cast<uint16_t>(__byte_perm(w[0], w[1], 0x0040));
  } else {
    uint32_t p[W / 4];
#pragma unroll
    for (int k = 0; k < W / 4; ++k)
      p[k] = __byte_perm(__byte_perm(w[4 * k], w[4 * k + 1], 0x0040),
                         __byte_perm(w[4 * k + 2], w[4 * k + 3], 0x0040),
                         0x5410);
    if constexpr (W == 4) return p[0];
    else if constexpr (W == 8) return make_uint2(p[0], p[1]);
    else return make_uint4(p[0], p[1], p[2], p[3]);
  }
}

// K15h: x (words·W + tail,) f32 → out int8, word i of W elements by
// thread i; the tail (< W elements) by threads 0 .. tail - 1
template <int W>
__global__ void __launch_bounds__(kWriteThreads)
quantize_store_kernel(const float* __restrict__ x, int8_t* __restrict__ out,
                      int64_t words, int tail, float mult) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  p2t::grid_dependency_wait();
  if (t < words) {
    float v[W];
    load_floats<W>(x + t * W, v);
    reinterpret_cast<typename Word<W>::T*>(out)[t] =
        quantize_word<W>(v, mult);
  }
  if (t < tail) {
    const int64_t e = words * W + t;
    out[e] = static_cast<int8_t>(s8_low(x[e], mult));
  }
  p2t::launch_dependents();
}

// K15i: word i of out ← word i of a if lo <= i < lo + span (row `row`'s
// words; span 0 for a row outside the tile), else of b
template <int W, typename I>
__global__ void __launch_bounds__(kWriteThreads)
select_row_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                  int8_t* __restrict__ out, I words, I lo, I span) {
  using V = typename Word<W>::T;
  using U = std::make_unsigned_t<I>;
  const I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  p2t::grid_dependency_wait();
  if (i < words)
    reinterpret_cast<V*>(out)[i] = reinterpret_cast<const V*>(
        static_cast<U>(i - lo) < static_cast<U>(span) ? a : b)[i];
  p2t::launch_dependents();
}

// K15j: word i of kn (W bytes of head i / words, words = D / W a head) →
// cache[head, *slot]; n = heads · words
template <int W>
__global__ void __launch_bounds__(kWriteThreads)
group_row_write_kernel(int8_t* __restrict__ cache,
                       const int8_t* __restrict__ kn,
                       const int32_t* __restrict__ slot, int64_t n,
                       int words, int T) {
  using V = typename Word<W>::T;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t h = i / words, c = i - h * words;
  p2t::grid_dependency_wait();
  if (i < n) {
    const int s = static_cast<int>(Word<4>::load(slot));
    const V v = Word<W>::load(kn + i * W);
    if (s >= 0 && s < T)
      reinterpret_cast<V*>(cache)[(h * T + s) * words + c] = v;
  }
  p2t::launch_dependents();
}

constexpr int kLogitRows = 64;        // c rows a K15k block (4 warps x 16)
constexpr int kLogitQ = 8;            // query rows a K15k block (one n8)
constexpr int kLogitMaxD = 512;       // shared memory stays under 48 KB

// bytes 0..3 of w (signed int8) → two bf16 pairs, byte 0 in the low half
// of the first, exactly: the byte flipped (q + 128) sits in the fp32
// 2^23 + u, one add takes 2^23 + 128 off, and the high halves are the bf16
__device__ __forceinline__ uint2 s8x4_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

__global__ void __launch_bounds__(128)
kv_logits_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const int8_t* __restrict__ c,
                     const float* __restrict__ s, float* __restrict__ out,
                     int Q, int T, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = D + 16;              // bytes a staged c row (banks skewed)
  const int qs = D + 8;               // bf16 a staged q row
  int8_t* c_s = reinterpret_cast<int8_t*>(smem_raw);
  __nv_bfloat16* q_s =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + kLogitRows * cs);
  float* s_s = reinterpret_cast<float*>(q_s + kLogitQ * qs);
  const int t0 = blockIdx.x * kLogitRows, q0 = blockIdx.y * kLogitQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // every copy in flight at once: 64 c rows, 8 q rows, 64 scales; rows
  // past T or Q are zero-filled and not read
  const int c_chunks = D / 16, q_chunks = D / 8;
  for (int i = tid; i < kLogitRows * c_chunks; i += 128) {
    const int r = i / c_chunks, k = i - r * c_chunks;
    const bool ok = t0 + r < T;
    p2t::cp_async16(c_s + r * cs + 16 * k,
                    ok ? c + (int64_t)(t0 + r) * D + 16 * k : c, ok ? 16 : 0);
  }
  for (int i = tid; i < kLogitQ * q_chunks; i += 128) {
    const int r = i / q_chunks, k = i - r * q_chunks;
    const bool ok = q0 + r < Q;
    p2t::cp_async16(q_s + r * qs + 8 * k,
                    ok ? q + (int64_t)(q0 + r) * D + 8 * k : q, ok ? 16 : 0);
  }
  if (tid < kLogitRows) {
    const bool ok = t0 + tid < T;
    p2t::cp_async4(s_s + tid, ok ? s + t0 + tid : s, ok ? 4 : 0);
  }
  p2t::cp_async_commit();
  p2t::cp_async_wait<0>();
  __syncthreads();

  // lane 4g + t: c rows 16w + g and 16w + g + 8 (A), query row g (B), the
  // head dims k0 + 4t .. k0 + 4t + 3 of each k16 step
  const int g = lane >> 2, t = lane & 3;
  const int8_t* c0 = c_s + (16 * warp + g) * cs + 4 * t;
  const int8_t* c1 = c0 + 8 * cs;
  const __nv_bfloat16* qr = q_s + g * qs + 4 * t;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < D; k0 += 16) {
    const uint2 lo = s8x4_bf16x4(*reinterpret_cast<const uint32_t*>(c0 + k0));
    const uint2 hi = s8x4_bf16x4(*reinterpret_cast<const uint32_t*>(c1 + k0));
    const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
    const uint2 b = *reinterpret_cast<const uint2*>(qr + k0);
    p2t::mma_bf16(acc, a, b.x, b.y);
  }
  // c0, c1: row 16w + g, query rows 2t, 2t + 1; c2, c3: row 16w + g + 8
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int ti = 16 * warp + g + 8 * (u >> 1), qi = q0 + 2 * t + (u & 1);
    if (t0 + ti < T && qi < Q)
      out[(int64_t)qi * T + t0 + ti] = acc[u] * s_s[ti];
  }
}

// K15l: sn[h] → s[h, *slot], a thread a value
__global__ void __launch_bounds__(kWriteThreads)
scale_column_write_kernel(float* __restrict__ s,
                          const float* __restrict__ sn,
                          const int32_t* __restrict__ slot, int heads,
                          int T) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  p2t::grid_dependency_wait();
  if (h < heads) {
    const int col = static_cast<int>(Word<4>::load(slot));
    const float v = __uint_as_float(Word<4>::load(sn + h));
    if (col >= 0 && col < T) s[(int64_t)h * T + col] = v;
  }
  p2t::launch_dependents();
}

// n threads in blocks of at most kWriteThreads, whole warps, one block up
// to kWriteThreads
void write_grid(int64_t n, dim3* grid, dim3* block) {
  const int64_t warps = (n + 31) / 32;
  const int64_t threads = warps * 32 < kWriteThreads ? warps * 32
                                                     : kWriteThreads;
  *block = dim3(static_cast<unsigned>(threads));
  *grid = dim3(static_cast<unsigned>((n + threads - 1) / threads));
}

// K15h/K15i: one thread a word, and at least `least` threads: one block
// up to kWriteThreads threads; past that blocks of 128-1024 threads, as
// many as cover the words and at least two an SM where 128-thread blocks
// allow it
void word_grid(int64_t words, int least, dim3* grid, dim3* block) {
  const int64_t n = words > least ? words : least;
  if (n <= kWriteThreads) return write_grid(n, grid, block);
  int64_t t = ((n + 2 * kSMs - 1) / (2 * kSMs) + 31) / 32 * 32;
  t = t < 128 ? 128 : t > kWriteThreads ? kWriteThreads : t;
  *block = dim3(static_cast<unsigned>(t));
  *grid = dim3(static_cast<unsigned>((n + t - 1) / t));
}

}  // namespace

// K15h: x (n,) f32 -> out (n,) int8
extern "C" int p2t_int8_quantize_store(const void* x, void* out, int64_t n,
                                       float mult, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  // x's loads are min(W, 4) floats wide: W 4-16 want it at 16 bytes
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int wo = widest(reinterpret_cast<uintptr_t>(out));
  const int wx = (xa & 15) == 0 ? 16 : (xa & 7) == 0 ? 2 : 1;
  const int W = wo < wx ? wo : wx;
  const int64_t words = n / W;
  const int tail = static_cast<int>(n - words * W);
  dim3 grid, block;
  word_grid(words, tail, &grid, &block);
  const float* xs = static_cast<const float*>(x);
  int8_t* o = static_cast<int8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_width(W, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return p2t::launch_chained(quantize_store_kernel<kW>, grid, block, s, xs,
                               o, words, tail, mult);
  });
}

// K15i: a, b, out (rows, cols) int8; a row outside [0, rows) gives b
extern "C" int p2t_int8_select_row(const void* a, const void* b, void* out,
                                   int rows, int cols, int row,
                                   void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int W = widest(reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(b) |
                       reinterpret_cast<uintptr_t>(out) |
                       static_cast<uintptr_t>(cols));
  const int64_t per_row = cols / W, words = (int64_t)rows * per_row;
  const bool in = row >= 0 && row < rows;
  const int64_t lo = in ? row * per_row : 0, span = in ? per_row : 0;
  dim3 grid, block;
  word_grid(words, 1, &grid, &block);
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  int8_t* o = static_cast<int8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 32-bit indices while every thread's index fits
  const bool narrow = (int64_t)grid.x * block.x <= INT32_MAX;
  return (int)by_width(W, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return narrow
        ? p2t::launch_chained(select_row_kernel<kW, int>, grid, block, s,
                              pa, pb, o, static_cast<int>(words),
                              static_cast<int>(lo), static_cast<int>(span))
        : p2t::launch_chained(select_row_kernel<kW, int64_t>, grid, block,
                              s, pa, pb, o, words, lo, span);
  });
}

// K15j: cache (heads, T, D) int8 in place, kn (heads, D) int8, slot a
// device int32; W bytes a thread, the widest word that divides D and both
// addresses
extern "C" int p2t_int8_group_row_write(void* cache, const void* kn,
                                        const void* slot, int heads, int T,
                                        int D, void* stream) {
  if (heads <= 0 || T <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int W = widest(reinterpret_cast<uintptr_t>(cache) |
                       reinterpret_cast<uintptr_t>(kn) |
                       static_cast<uintptr_t>(D));
  const int64_t n = (int64_t)heads * (D / W);
  dim3 grid, block;
  write_grid(n, &grid, &block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* c = static_cast<int8_t*>(cache);
  const int8_t* k = static_cast<const int8_t*>(kn);
  const int32_t* i = static_cast<const int32_t*>(slot);
  return (int)by_width(W, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return p2t::launch_chained(group_row_write_kernel<kW>, grid, block, s, c,
                               k, i, n, D / kW, T);
  });
}

// K15k: q (Q, D) bf16, c (T, D) int8, s (T,) f32 -> out (Q, T) f32; D a
// multiple of 16 up to kLogitMaxD, q and c 16-byte aligned (cp.async)
extern "C" int p2t_int8_kv_logits(const void* q, const void* c,
                                  const void* s, void* out, int Q, int T,
                                  int D, void* stream) {
  if (Q <= 0 || T <= 0 || D <= 0 || D % 16 || D > kLogitMaxD ||
      (int64_t)Q * T > (1LL << 30) || (Q + kLogitQ - 1) / kLogitQ > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(c)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((T + kLogitRows - 1) / kLogitRows,
                  (Q + kLogitQ - 1) / kLogitQ);
  const size_t smem = kLogitRows * (D + 16) +
                      kLogitQ * (D + 8) * sizeof(__nv_bfloat16) +
                      kLogitRows * sizeof(float);
  kv_logits_mma_kernel<<<grid, 128, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(c),
      static_cast<const float*>(s), static_cast<float*>(out), Q, T, D);
  return (int)cudaGetLastError();
}

// K15l: s (heads, T) f32 in place, sn (heads,) f32, slot a device int32
extern "C" int p2t_scale_column_write(void* s, const void* sn,
                                      const void* slot, int heads, int T,
                                      void* stream) {
  if (heads <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid, block;
  write_grid(heads, &grid, &block);
  return (int)p2t::launch_chained(
      scale_column_write_kernel, grid, block,
      static_cast<cudaStream_t>(stream), static_cast<float*>(s),
      static_cast<const float*>(sn), static_cast<const int32_t*>(slot),
      heads, T);
}
