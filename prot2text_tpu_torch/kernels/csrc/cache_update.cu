// K3: in-place KV-cache slot write, cache[l, b, h, index, :] = new[l, b, h, :]
// for every (l, b, h) of the (L, B, Hkv, T, D) cache.  K12/K13 (below): the
// same write for the sequence-leading (L, T, B, Hkv, D) cache.
//
// Replaces prot2text_tpu/kernels/cache_update.py cache_slot_write_bkt
// (_write_group_kernel): on the TPU a slot could not be addressed alone, so
// the kernel read-modified-wrote an (8, 128) tile group per (layer, head)
// through an aliased output.  Here a slot row is D contiguous elements, so
// the write is a plain strided copy of L*B*Hkv rows.
//
// Bound: bytes.  It reads and writes L*B*Hkv*D*itemsize bytes each (256 KiB
// at the 8B shape: L=32, B=4, Hkv=8, D=128, bf16) and is launch-latency
// bound at that size.  So the port's bf16 lockstep step does not call it:
// K4's epilogue (decode_attention_split.cuh SlotWrite) writes each layer's
// slot in the launch that already holds the token's k and v.
// Design: one 16-byte word per thread over the flattened (row, word) index,
// so every warp stores 512 contiguous bytes of slot rows; a byte-wise
// variant covers rows whose size is not a multiple of 16 bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
slot_write_kernel(W* __restrict__ cache, const W* __restrict__ src,
                  int64_t n_rows, int64_t row_words, int64_t T,
                  int64_t index) {
  const int64_t total = n_rows * row_words;
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t r = i / row_words;
    const int64_t w = i - r * row_words;
    cache[(r * T + index) * row_words + w] = src[i];
  }
}

template <typename W>
cudaError_t launch(void* cache, const void* src, int64_t n_rows,
                   int64_t row_words, int64_t T, int64_t index,
                   cudaStream_t stream) {
  const int64_t total = n_rows * row_words;
  const int64_t blocks64 = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(blocks64 < 65536 ? blocks64 : 65536);
  slot_write_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<W*>(cache), static_cast<const W*>(src), n_rows, row_words,
      T, index);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K12 / K13: in-place slot write for the sequence-leading (L, T, B, Hkv, D)
// ("tbkd") cache, cache[l, index] = new[l] for every layer l.
//
// Replaces prot2text_tpu/kernels/cache_update.py cache_slot_write
// (_write_kernel, K12) and cache_slot_write_kv (_write_kv_kernel, K13: k and
// v in one launch).  On the TPU each grid step DMA'd one layer's slot slab,
// viewed as (N/128, 128) lane rows, which is why JAX needs N % 128 == 0.
// Here the slot of layer l is ONE contiguous run of N = B*Hkv*D elements at
// offset (l*T + index)*N, so the write is L strided copies of N elements
// and takes any N.
//
// Bound: bytes.  It reads and writes L*N*itemsize bytes per cache (64 KiB
// at Llama-3.2-1B's lockstep shape: L=16, B=4, Hkv=8, D=64, bf16), so at
// the path's shapes it is launch-latency bound.  So the port's tbkd
// lockstep step does not call it (nor K13): K4's epilogue (decode_
// attention_split.cuh SlotWrite, the SIMT body in f32) writes each layer's
// slot at the tbkd strides in the launch that already holds the token's k
// and v.  JAX's tbkd step still calls it twice a step.
// Design: blockIdx.y is the layer, blockIdx.z the cache (k, v), blockIdx.x
// strides the run in 16-byte words, one per thread, so every warp stores
// 512 contiguous bytes; no index division per element.  A byte-wise variant
// covers runs or pointers that are not 16-byte aligned.

template <typename W>
__global__ void __launch_bounds__(kThreads)
slab_write_kernel(W* __restrict__ cache0, const W* __restrict__ src0,
                  W* __restrict__ cache1, const W* __restrict__ src1,
                  int64_t run_words, int64_t T, int64_t index) {
  W* cache = blockIdx.z ? cache1 : cache0;
  const W* src = blockIdx.z ? src1 : src0;
  const int64_t l = blockIdx.y;
  W* dst = cache + (l * T + index) * run_words;
  const W* s = src + l * run_words;
  for (int64_t w = blockIdx.x * (int64_t)kThreads + threadIdx.x;
       w < run_words; w += (int64_t)gridDim.x * kThreads)
    dst[w] = s[w];
}

template <typename W>
cudaError_t launch_slab(void* c0, const void* s0, void* c1, const void* s1,
                        int n_caches, int64_t L, int64_t run_words,
                        int64_t T, int64_t index, cudaStream_t stream) {
  const int64_t blocks64 = (run_words + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(blocks64 < 1024 ? blocks64 : 1024),
                  (unsigned)L, (unsigned)n_caches);
  slab_write_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<W*>(c0), static_cast<const W*>(s0), static_cast<W*>(c1),
      static_cast<const W*>(s1), run_words, T, index);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// cache1/src1 may be null (n_caches 1: K12); with n_caches 2 (K13) both
// caches share L, T and the run size.
extern "C" int p2t_cache_slab_write(void* cache0, const void* src0,
                                    void* cache1, const void* src1,
                                    int n_caches, int64_t L, int64_t T,
                                    int64_t index, int64_t run_bytes,
                                    void* stream) {
  if (n_caches < 1 || n_caches > 2 || L <= 0 || L > 65535 ||
      run_bytes <= 0 || index < 0 || index >= T)
    return (int)cudaErrorInvalidValue;
  if (n_caches == 1) {
    cache1 = cache0;
    src1 = src0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = run_bytes % 16 == 0 && aligned16(cache0) &&
                    aligned16(src0) && aligned16(cache1) && aligned16(src1);
  if (wide)
    return (int)launch_slab<uint4>(cache0, src0, cache1, src1, n_caches, L,
                                   run_bytes / 16, T, index, s);
  return (int)launch_slab<uint8_t>(cache0, src0, cache1, src1, n_caches, L,
                                   run_bytes, T, index, s);
}

extern "C" int p2t_cache_slot_write(void* cache, const void* src,
                                    int64_t n_rows, int64_t T, int64_t index,
                                    int row_bytes, void* stream) {
  if (n_rows <= 0 || row_bytes <= 0 || index < 0 || index >= T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(cache) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(src) % 16 == 0);
  if (row_bytes % 16 == 0 && aligned)
    return (int)launch<uint4>(cache, src, n_rows, row_bytes / 16, T, index,
                              s);
  return (int)launch<uint8_t>(cache, src, n_rows, row_bytes, T, index, s);
}

extern "C" const char* p2t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
