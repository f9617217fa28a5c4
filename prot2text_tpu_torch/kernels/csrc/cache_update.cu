// K3: in-place KV-cache slot write, cache[l, b, h, index, :] = new[l, b, h, :]
// for every (l, b, h) of the (L, B, Hkv, T, D) cache.
//
// Replaces prot2text_tpu/kernels/cache_update.py cache_slot_write_bkt
// (_write_group_kernel): on the TPU a slot could not be addressed alone, so
// the kernel read-modified-wrote an (8, 128) tile group per (layer, head)
// through an aliased output.  Here a slot row is D contiguous elements, so
// the write is a plain strided copy of L*B*Hkv rows.
//
// Bound: bytes.  It reads and writes L*B*Hkv*D*itemsize bytes each (256 KiB
// at the 8B shape: L=32, B=4, Hkv=8, D=128, bf16) and is launch-latency
// bound at that size.
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

}  // namespace

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
