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
// per output element (K15h, K15i, K15k: a D-long fp32 dot per logit), one
// thread per written byte or value (K15j, K15l); nothing is staged.
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

__global__ void kv_logits_kernel(const __nv_bfloat16* __restrict__ q,
                                 const int8_t* __restrict__ c,
                                 const float* __restrict__ s,
                                 float* __restrict__ out, int Q, int T,
                                 int D) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= Q * T) return;
  const int qi = i / T, ti = i % T;
  const __nv_bfloat16* qr = q + (int64_t)qi * D;
  const int8_t* cr = c + (int64_t)ti * D;
  float acc = 0.f;
  for (int d = 0; d < D; ++d)
    acc = fmaf(__bfloat162float(qr[d]), static_cast<float>(cr[d]), acc);
  out[i] = acc * s[ti];
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

// K15k: q (Q, D) bf16, c (T, D) int8, s (T,) f32 -> out (Q, T) f32
extern "C" int p2t_int8_kv_logits(const void* q, const void* c,
                                  const void* s, void* out, int Q, int T,
                                  int D, void* stream) {
  if (Q <= 0 || T <= 0 || D <= 0 || (int64_t)Q * T > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  kv_logits_kernel<<<(Q * T + 255) / 256, 256, 0,
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
