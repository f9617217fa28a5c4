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
// the path's shapes a launch, not the bytes, is its cost.  So the port's
// tbkd lockstep step does not call it (nor K13): K4's epilogue (decode_
// attention_split.cuh SlotWrite, the SIMT body in f32) writes each layer's
// slot at the tbkd strides in the launch that already holds the token's k
// and v.  JAX's tbkd step still calls it twice a step.
// Design, as K15h/K15i's (probe_int8_kv.cu):
//   - one W-byte word a thread over the flattened (cache, layer, word)
//     index, W the widest of 16, 8, 4, 2, 1 that divides the run's bytes
//     and all four addresses, so every result is bit-exact at any N; the
//     legacy shape is 2 x 16 x 256 16-byte words;
//   - `p2t::word_grid`: one block up to kWriteThreads words, past that
//     blocks of 128-1024 threads, at least two an SM where the words allow;
//     32-bit word indices while they fit;
//   - chained launches (`p2t::launch_chained`): only index arithmetic
//     before `grid_dependency_wait` (the new rows may be the previous
//     kernel's output and the cache memory that kernel still reads), the
//     trigger after the store, so in a run of launches each one's set-up
//     overlaps the kernel before it.

// word i of n = n_caches * L * run words: cache i / per_cache (per_cache =
// L * run), layer (i mod per_cache) / run, word (i mod per_cache) mod run
template <int W, typename I>
__global__ void __launch_bounds__(p2t::kWriteThreads)
slab_write_kernel(unsigned char* __restrict__ cache0,
                  const unsigned char* __restrict__ src0,
                  unsigned char* __restrict__ cache1,
                  const unsigned char* __restrict__ src1, I n, I per_cache,
                  I run, int64_t T, int64_t index) {
  using V = typename p2t::Word<W>::T;
  const I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool second = i >= per_cache;
  const I j = second ? i - per_cache : i;
  const I l = j / run;
  const int64_t dst = (l * T + index) * run + (j - l * run);
  V* cache = reinterpret_cast<V*>(second ? cache1 : cache0);
  const V* src = reinterpret_cast<const V*>(second ? src1 : src0);
  p2t::grid_dependency_wait();
  if (i < n) cache[dst] = src[j];
  p2t::launch_dependents();
}

}  // namespace

// cache1/src1 may be null (n_caches 1: K12); with n_caches 2 (K13) both
// caches share L, T and the run size
extern "C" int p2t_cache_slab_write(void* cache0, const void* src0,
                                    void* cache1, const void* src1,
                                    int n_caches, int64_t L, int64_t T,
                                    int64_t index, int64_t run_bytes,
                                    void* stream) {
  if (n_caches < 1 || n_caches > 2 || L <= 0 || run_bytes <= 0 ||
      index < 0 || index >= T)
    return (int)cudaErrorInvalidValue;
  if (n_caches == 1) {
    cache1 = cache0;
    src1 = src0;
  }
  const int W = p2t::widest(reinterpret_cast<uintptr_t>(cache0) |
                            reinterpret_cast<uintptr_t>(src0) |
                            reinterpret_cast<uintptr_t>(cache1) |
                            reinterpret_cast<uintptr_t>(src1) |
                            static_cast<uintptr_t>(run_bytes));
  const int64_t run = run_bytes / W, per_cache = L * run;
  const int64_t n = n_caches * per_cache;
  dim3 grid, block;
  p2t::word_grid(n, 1, &grid, &block);
  auto* c0 = static_cast<unsigned char*>(cache0);
  auto* c1 = static_cast<unsigned char*>(cache1);
  const auto* s0 = static_cast<const unsigned char*>(src0);
  const auto* s1 = static_cast<const unsigned char*>(src1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 32-bit word indices while every thread's index fits
  const bool narrow = (int64_t)grid.x * block.x <= INT32_MAX;
  return (int)p2t::by_width(W, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return narrow
        ? p2t::launch_chained(slab_write_kernel<kW, int>, grid, block, s, c0,
                              s0, c1, s1, static_cast<int>(n),
                              static_cast<int>(per_cache),
                              static_cast<int>(run), T, index)
        : p2t::launch_chained(slab_write_kernel<kW, int64_t>, grid, block,
                              s, c0, s0, c1, s1, n, per_cache, run, T,
                              index);
  });
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
