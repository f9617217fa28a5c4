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
// Bound: bytes, and a few microseconds of launch at the probes' sizes
// ((192, 128) int8 is 24.6 KB: 0.01 us at 3.35 TB/s).  Design: one thread
// per output element (K15h, K15i), one thread per written byte or value
// (K15j, K15l); nothing is staged.
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
#include "common.cuh"

namespace {

__global__ void quantize_store_kernel(const float* __restrict__ x,
                                      int8_t* __restrict__ out, int64_t n,
                                      float mult) {
  for (int64_t i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * 256)
    out[i] = static_cast<int8_t>(fminf(fmaxf(rintf(x[i] * mult), -127.f),
                                       127.f));
}

__global__ void select_row_kernel(const int8_t* __restrict__ a,
                                  const int8_t* __restrict__ b,
                                  int8_t* __restrict__ out, int rows,
                                  int cols, int row) {
  const int64_t n = (int64_t)rows * cols;
  for (int64_t i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * 256)
    out[i] = i / cols == row ? a[i] : b[i];
}

__global__ void group_row_write_kernel(int8_t* __restrict__ cache,
                                       const int8_t* __restrict__ kn,
                                       const int32_t* __restrict__ slot,
                                       int heads, int T, int D) {
  const int s = *slot;
  if (s < 0 || s >= T) return;
  const int64_t n = (int64_t)heads * D;
  for (int64_t i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * 256) {
    const int64_t h = i / D, d = i % D;
    cache[(h * T + s) * D + d] = kn[i];
  }
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

__global__ void scale_column_write_kernel(float* __restrict__ s,
                                          const float* __restrict__ sn,
                                          const int32_t* __restrict__ slot,
                                          int heads, int T) {
  const int col = *slot;
  const int h = blockIdx.x * 256 + threadIdx.x;
  if (col < 0 || col >= T || h >= heads) return;
  s[(int64_t)h * T + col] = sn[h];
}

int blocks_for(int64_t n) {
  const int64_t b = (n + 255) / 256;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace

// K15h: x (n,) f32 -> out (n,) int8
extern "C" int p2t_int8_quantize_store(const void* x, void* out, int64_t n,
                                       float mult, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  quantize_store_kernel<<<blocks_for(n), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(out), n, mult);
  return (int)cudaGetLastError();
}

// K15i: a, b, out (rows, cols) int8
extern "C" int p2t_int8_select_row(const void* a, const void* b, void* out,
                                   int rows, int cols, int row,
                                   void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  select_row_kernel<<<blocks_for((int64_t)rows * cols), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int8_t*>(out), rows, cols, row);
  return (int)cudaGetLastError();
}

// K15j: cache (heads, T, D) int8 in place, kn (heads, D) int8, slot a
// device int32
extern "C" int p2t_int8_group_row_write(void* cache, const void* kn,
                                        const void* slot, int heads, int T,
                                        int D, void* stream) {
  if (heads <= 0 || T <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  group_row_write_kernel<<<blocks_for((int64_t)heads * D), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(cache), static_cast<const int8_t*>(kn),
      static_cast<const int32_t*>(slot), heads, T, D);
  return (int)cudaGetLastError();
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
  scale_column_write_kernel<<<(heads + 255) / 256, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(s), static_cast<const float*>(sn),
      static_cast<const int32_t*>(slot), heads, T);
  return (int)cudaGetLastError();
}
