// A bf16 x integer-weight product for more than a few rows on the tensor
// cores' warpgroup instruction (wgmma): K14's, K10's, K11a's and K11b's
// body above the few-row threshold, and K15g's,
//
//   y[r, n] = (sum_k x[r, k] * q[k, n]) * scale[n]     (no scale: the sum)
//
// and K15f's int8 x int8 product, exact in int32 with no scale (its policy
// `S8W`, instantiated in int8_mma.cu, whose header states its fragments:
// x (R, K) int8 as it is, 128 k values a tile, s32 accumulators on wgmma
// m64nBMk32.s8.s8, int32 sums in the cluster's exchange and in y).
//
// x (R, K) bf16 row-major; q the integer weight in a format policy's layout
// (`Int8W`: (K, N) int8, K14's and K15g's; `PlanesW`: (K/8, N) int32 nibble
// planes, K10's: nibble j of word [k8, n] holds q[k8 + j*K/8, n];
// `BytesW`: (K/2, N) int8 split-half bytes, K11a's: byte [k2, n] holds
// q[k2, n] in its low nibble and q[k2 + K/2, n] in its high one; `PairsW`:
// (K/8, N) int32 bf16-pair words, K11b's: bits [4p, 4p+4) hold q[k8 +
// 2p*K/8, n] + 8 and bits [16+4p, 20+4p) q[k8 + (2p+1)*K/8, n] + 8); fp32
// accumulation, the scale in the fp32 epilogue, y of type To (bf16 or f32).
// The body is a template over the weight format, the output type, the
// block's columns (64 per consumer warpgroup) and its rows (wgmma's N: 64,
// 128 or 256); the scale is nullable.
//
// Bound: at R <= 128 the weight stream (Qwen3-14B gate/up, K 5120 N 17408:
// 89.1 MB int8, 44.6 MB in each int4 format, 26.6 or 13.3 us at 3.35
// TB/s); at an install's rows (R 3072 there: 547.6 G operations, 0.554 ms
// at 989 TFLOP/s) the tensor cores.  The few-row body (quant_matmul.cuh)
// is 3x slower than cuBLAS on a bf16 copy at R 40: its mma.sync tiles of 8
// rows re-stage x per 128 columns and hold R/8 accumulator tiles a warp.
// So:
//   - the product runs transposed, y^T = q^T x^T, on wgmma m64nBMk16: A (64
//     weight columns x 16 k) from registers, converted from the integer
//     tile, B (16 k x BM rows of x) from shared memory through a
//     descriptor, BM/2 fp32 accumulators a thread.  BM follows R (64 at R
//     <= 64, so a verify round's 40 rows waste a third of the MMA, not two
//     thirds), and 256 at an install's rows, where each converted A
//     fragment then serves 256 rows;
//   - one producer warp streams K in tiles of 64 through a ring of up to 8
//     stages by TMA alone: x's tile is one box of BM rows x 128 bytes, the
//     weight's tile boxes of 128-byte rows, all in the 128-byte swizzle
//     (16-byte chunk c of row r at chunk c ^ (r % 8)), which wgmma's
//     descriptor reads as it is and which keeps the fragment loads free of
//     bank conflicts.  An mbarrier per stage counts the bytes in, a second
//     one the consumer warps' releases; no block-wide barrier runs in the
//     loop;
//   - the consumer warpgroups build tile i's A fragments while tile i - 1's
//     wgmmas may run (the fragments double-buffered, the wgmmas of a tile
//     one batch), and release tile i - 1's stage once those completed;
//     ptxas serializes the wgmmas all the same (its report C7513: registers
//     of a later wgmma are written while a batch runs), which the install's
//     compute-bound rows feel;
//   - where the column blocks leave SMs idle, K is split over the Ck blocks
//     of a thread-block cluster: each sums its K slice, leaves its fp32
//     partial in its shared memory (over the ring), and after a cluster
//     barrier block r sums a share of the elements over the ranks in rank
//     order through distributed shared memory: no partial crosses global
//     memory, no second launch, no atomics (two launches give the same
//     bits), as flash_attention_bwd.cuh's dK/dV;
//   - the host path is short, since a decode step's host time paces it:
//     tensor maps come from a table keyed by what they encode, the
//     shared-memory limit is set once, and a cluster is launched only to
//     split K.
// Sharing x's tiles across a cluster's column blocks by TMA multicast held
// those blocks in step and ran 1.3-2x slower than each block loading its
// own x on an H100 (PERF.md §6), so the blocks load x alone.
// A fragments.  Int8W: one ldmatrix.trans of 16-bit units gives a thread
// the bytes of k 2t, 2t+1 (and 2t+8, 2t+9) at columns 2g, 2g+1, so the
// MMA's row g stands for column 2g and row g + 8 for column 2g + 1, and a
// byte pair becomes a bf16 pair in registers (q + 128 in the fp32 2^23 +
// 128 + q by a byte permute, 2^23 + 128 off in one add, exactly).
// The three int4 formats hold the same integers in three layouts, and
// each policy's tile holds the same 64 k values: those of word row k8 =
// 8t + i (i < 8) in plane j, k = j*K/8 + 8t + i, at tile-local k 8j + i.
// So x's tile is, for each row, the 8 runs x[j*K/8 + 8t .. + 8] side by
// side: a first kernel copies x into that order (`planes_x_kernel`), so
// that x's tile is one TMA box (a 4-D view of x, boxes of 16-byte runs,
// does not fit the 128-byte swizzle: it wrote past the stage on the
// card).  k16 step s of a tile is planes 2s (k 2t, 2t+1: word rows 2t and
// 2t + 1) and 2s + 1 (k 2t+8, 2t+9).  Every A value is an exact bf16 built
// from a nibble u biased to u + 8: 0x4300 | u is the bf16 of 128 + u, and
// one bf16x2 subtraction of 136 leaves the value (the few-row body's
// arithmetic).  So on the same integers the three formats give the same
// fragments, the same wgmmas and K10's result bit for bit, at every grid.
//   PlanesW: a thread loads its two columns' words of word rows 2t and
//   2t + 1 (two 8-byte loads); a byte permute puts byte s (nibbles 2s, 2s +
//   1) of both words side by side; nibble ^ 8 biases it.
//   BytesW: the tile is byte rows g*K/8 + 8t + i of the four groups g < 4
//   (low nibble plane g, high nibble plane g + 4), 32 byte rows, as many
//   bytes as PlanesW's 8 word rows; one ldmatrix.x4.trans of 16-bit units
//   over the four groups (matrix g: group g's 8 rows) gives a thread, in
//   register g, the bytes of word rows 2t, 2t + 1 at columns 2g, 2g + 1:
//   planes g and g + 4.  One load a warp serves the tile's four k16
//   steps (Int8W needs two); nibble ^ 8 biases it, as for planes.
//   PairsW: PlanesW's word rows, tile and boxes; plane 2p sits in byte p/2
//   (nibble p % 2), plane 2p + 1 in byte 2 + p/2, both already biased: one
//   byte permute a column and pair of steps puts bytes kp and 2 + kp of
//   rows 2t and 2t + 1 side by side, and masks (no XOR) give steps 2kp and
//   2kp + 1.
// The integer values are exact in bf16, so only the order of the fp32
// sums separates the result from the plain version.
// Contract: any R >= 1 (rows past R are zero-filled and not written), x
// 16-byte aligned; Int8W: K % 8 == 0, N % 16 == 0; PlanesW and PairsW: K %
// 64 == 0, N % 4 == 0; BytesW: K % 64 == 0, N % 16 == 0 (the byte rows'
// stride, a TMA rule); the weight 16-byte aligned.  (kernels/quant_matmul.py
// rows_fit is this rule.)
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace {
namespace rows {

namespace cg = cooperative_groups;

using p2t::ldmatrix_x4_trans;

typedef __nv_bfloat16 bf16;

constexpr int kBK = 64;                // k values per tile of a bf16 x
constexpr int kMaxCluster = 8;         // the portable cluster
constexpr int kMaxStages = 8;

// kWG consumer warpgroups of 64 weight columns each and one producer warp,
// kBM rows of x; a block of 64 rows and 128 columns keeps under half the
// shared memory and 112 registers a thread, so two are resident on an SM
template <int kWG, int kBM>
__host__ __device__ constexpr int per_sm() {
  return kWG == 2 && kBM == 64 ? 2 : 1;
}

template <class W, int kWG, int kBM>
struct Tile {
  static constexpr int kBN = 64 * kWG;            // output columns a block
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kPerSM = per_sm<kWG, kBM>();
  static constexpr int kXBytes = 128 * kBM;       // kBM rows x 128 bytes
  static constexpr int kWBytes = W::template bytes<kBN>();
  static constexpr int kStage = kXBytes + kWBytes;  // multiples of 1024
  static constexpr int kBudget = kPerSM == 2 ? 104 * 1024 : 224 * 1024;
  static constexpr int kStages =
      kBudget / kStage < kMaxStages ? kBudget / kStage : kMaxStages;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kBytes = kRing + 2 * kStages * 8;  // + the mbarriers
  // the cluster's exchange: Acc [kBM][kAccStride] over the ring
  static constexpr int kAccStride = kBN + 4;
  static_assert(kStage % 1024 == 0, "128-byte swizzle atoms");
  static_assert(kStages >= 3, "a ring of at least three stages");
  static_assert(4 * kBM * kAccStride <= kRing, "exchange over the ring");
  static_assert(kBytes + 1024 <= 232448, "shared memory of one block");
};

// ---------------------------------------------------------------------------
// mbarriers and TMA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// this thread's arrival, and `bytes` more for the phase to wait for
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// wait for the phase of parity `parity` to complete; a phase that never
// completes is a fault of this body, so after ~2^26 tries it traps (a
// launch error) instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// the box at coordinates c of `map` → dst, its bytes counted on `bar`
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// a tensor map in the 128-byte swizzle, zeros out of bounds; dims and box
// innermost first, strides (bytes) of dims 1 ..
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                     const void* base, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      fn = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      fn = nullptr;
#endif
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// the MMA

// a shared-memory matrix descriptor for a K-major tile in the 128-byte
// swizzle: the start address, 1024 bytes between 8-row groups, swizzle
// mode 1 (128 bytes); a k16 step inside the 128-byte row moves the start
// by 32 bytes
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (the warpgroup's 64 weight columns x N rows, fp32) += a (64 x 16 bf16,
// registers: warp w's fragment holds columns 16w ..) · b (16 x N bf16 of x,
// K-major in shared memory)
template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2],
                                        const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_n<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_n<128>(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_n<256>(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// weight formats.  A policy W states: Acc (the accumulators' type), x's
// element (kXType, kXElem: a tile of x is kTileK of them, 128 bytes a
// row), mma<N>() (one of the tile's four MMA steps), kXTiled (x is read in
// the int4 formats' tile order, written first by planes_x_kernel),
// fits(K, N) (its shape rule), wmap() (the weight's tensor map),
// bytes<kBN>() (a tile's weight bytes), tiles(K), load() (the producer's
// copies of tile kt) and frags() (a consumer warp's A fragments of the
// tile's four MMA steps).

// what the formats of a bf16 x share: fp32 sums, x's tile 64 bf16 a row,
// an MMA step of k16
struct Bf16X {
  using Acc = float;
  static constexpr CUtensorMapDataType kXType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kXElem = 2;
  static constexpr int kTileK = kBK;
  template <int N>
  __device__ static void mma(float (&d)[N / 2], const uint32_t (&a)[4],
                             uint64_t b) {
    wgmma_n<N>(d, a, b);
  }
};

// int8 bytes i and i + 2 of u (flipped: q + 128) → their bf16 pair (byte i
// in the low half), exactly: u's byte sits in the fp32 2^23 + u, one add
// takes 2^23 + 128 off, and the high halves of the two fp32 values are the
// bf16s (an integer of at most 8 significant bits has zero low halves)
__device__ __forceinline__ uint32_t int8_pair(uint32_t u, int i) {
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542 + i)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// nibbles u0, u1 in bits [0, 4) and [16, 20) of t, already biased (u =
// q + 8) → their exact bf16 pair: 0x4300 | u is the bf16 of 128 + u, and
// 136 off
__device__ __forceinline__ uint32_t biased_pair(uint32_t t) {
  t = (t & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&t),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// two's complement nibbles in bits [0, 4) and [16, 20) of v → their exact
// bf16 pair: bit 3 flipped (q + 8), then biased_pair's arithmetic
__device__ __forceinline__ uint32_t nibble_pair(uint32_t v) {
  uint32_t t = (v & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&t),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// the weight's 2-D map: dims (cols, rows) of `type`, a row `pitch` bytes
// apart, boxes (box_cols, box_rows)
inline bool make_wmap_2d(CUtensorMap* map, CUtensorMapDataType type,
                         const void* w, int cols, int rows, int pitch,
                         int box_cols, int box_rows) {
  const cuuint64_t d[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t st[1] = {(cuuint64_t)pitch};
  const cuuint32_t b[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return make_map(map, type, 2, w, d, st, b);
}

// The int8 weight (K, N): a tile is kBK rows x kBN columns, kBN / 128
// boxes of 64 rows x 128 bytes (the weight's map: dims (N, K), boxes (128,
// 64)).  x's tile is one box of its map (dims (K, R), boxes (64, kBM)) at
// k 64kt.  half() turns one ldmatrix.x4.trans of 16-bit units over k rows
// 32kp .. 32kp + 31 of the warp's 16 columns (matrices: k 0-7, 8-15, 16-23,
// 24-31) into the A fragments of k16 steps 2kp and 2kp + 1: register r of
// a matrix holds bytes (k 2t, col 2g), (k 2t, col 2g+1), (k 2t+1, col 2g),
// (k 2t+1, col 2g+1), so the MMA's row g is column 2g (bytes 0, 2) and row
// g + 8 column 2g + 1 (bytes 1, 3).
struct Int8W : Bf16X {
  static constexpr bool kXTiled = false;
  static bool fits(int K, int N) { return K % 8 == 0 && N % 16 == 0; }
  static bool wmap(CUtensorMap* map, const void* w, int K, int N) {
    return make_wmap_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, 128,
                        64);
  }
  template <int kBN>
  __host__ __device__ static constexpr int bytes() {
    return kBK * kBN;
  }
  __host__ __device__ static int tiles(int K) { return (K + kBK - 1) / kBK; }
  template <int kBN>
  __device__ static void load(unsigned char* xs, unsigned char* ws,
                              const CUtensorMap* xmap,
                              const CUtensorMap* wmap, int kt, int r0,
                              int n0, uint64_t* bar) {
    tma_2d(xs, xmap, kt * kBK, r0, bar);
#pragma unroll
    for (int h = 0; h < kBN / 128; ++h)
      tma_2d(ws + h * 128 * kBK, wmap, n0 + 128 * h, kt * kBK, bar);
  }
  __device__ static void half(const unsigned char* ws, int col, int lane,
                              int kp, uint32_t (&a0)[4], uint32_t (&a1)[4]) {
    const int k = 32 * kp + (lane & 7) + 8 * (lane >> 3);
    uint32_t m[4];
    ldmatrix_x4_trans(m, ws + (col >> 7) * 128 * kBK + k * 128 +
                             ((((col & 127) >> 4) ^ (k & 7)) << 4));
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = m[i] ^ 0x80808080u;
    a0[0] = int8_pair(u[0], 0);
    a0[1] = int8_pair(u[0], 1);
    a0[2] = int8_pair(u[1], 0);
    a0[3] = int8_pair(u[1], 1);
    a1[0] = int8_pair(u[2], 0);
    a1[1] = int8_pair(u[2], 1);
    a1[2] = int8_pair(u[3], 0);
    a1[3] = int8_pair(u[3], 1);
  }
  __device__ static void frags(const unsigned char* ws, int col, int lane,
                               uint32_t (&a)[4][4]) {
    half(ws, col, lane, 0, a[0], a[1]);
    half(ws, col, lane, 1, a[2], a[3]);
  }
};

// The nibble planes (K/8, N) int32: a tile is 8 word rows x kBN words,
// kBN / 32 boxes of 8 rows x 128 bytes (the weight's map: dims (N, K/8),
// boxes (32, 8)).  The tile-local k of (word row i, nibble j) is 8j + i:
// `planes_x_kernel` writes x in that order (xp[r, 64kt + 8j + i] = x[r,
// j*K/8 + 8kt + i]), and x's tile is one box of xp's map at k 64kt, as for
// Int8W.  half() for k16 steps 2kp and 2kp + 1: the MMA's row g is column
// 2g and row g + 8 column 2g + 1, as for Int8W; words (2t, col) and (2t +
// 1, col) give k 2t, 2t + 1 (nibble 2s) and 2t + 8, 2t + 9 (nibble 2s + 1)
// of step s.
struct PlanesW : Bf16X {
  static constexpr bool kXTiled = true;
  static bool fits(int K, int N) { return K % 64 == 0 && N % 4 == 0; }
  static bool wmap(CUtensorMap* map, const void* w, int K, int N) {
    return make_wmap_2d(map, CU_TENSOR_MAP_DATA_TYPE_INT32, w, N, K / 8,
                        4 * N, 32, 8);
  }
  template <int kBN>
  __host__ __device__ static constexpr int bytes() {
    return 8 * 4 * kBN;
  }
  __host__ __device__ static int tiles(int K) { return K / kBK; }
  template <int kBN>
  __device__ static void load(unsigned char* xs, unsigned char* ws,
                              const CUtensorMap* xmap,
                              const CUtensorMap* wmap, int kt, int r0,
                              int n0, uint64_t* bar) {
    tma_2d(xs, xmap, kt * kBK, r0, bar);
#pragma unroll
    for (int h = 0; h < kBN / 32; ++h)
      tma_2d(ws + h * 1024, wmap, n0 + 32 * h, 8 * kt, bar);
  }
  // words (2t, column 2g), (2t, 2g + 1) in u0 and (2t + 1, ...) in u1 (the
  // box of 32 words holding column c, word w of it)
  __device__ static void words(const unsigned char* ws, int col, int lane,
                               uint2* u0, uint2* u1) {
    const int g = lane >> 2, t = lane & 3;
    const int c = col + 2 * g, w = c & 31;        // box c / 32, word w
    const unsigned char* box = ws + (c >> 5) * 1024 + (w & 3) * 4;
    *u0 = *reinterpret_cast<const uint2*>(
        box + 2 * t * 128 + (((w >> 2) ^ (2 * t)) << 4));
    *u1 = *reinterpret_cast<const uint2*>(
        box + (2 * t + 1) * 128 + (((w >> 2) ^ (2 * t + 1)) << 4));
  }
  __device__ static void half(const unsigned char* ws, int col, int lane,
                              int kp, uint32_t (&a0)[4], uint32_t (&a1)[4]) {
    uint2 u0, u1;
    words(ws, col, lane, &u0, &u1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * kp + h;
      // byte s of row 2t in byte 0, of row 2t + 1 in byte 2
      const uint32_t sel = s | ((4 + s) << 8);
      const uint32_t c0 = __byte_perm(u0.x, u1.x, sel);  // column 2g
      const uint32_t c1 = __byte_perm(u0.y, u1.y, sel);  // column 2g + 1
      uint32_t (&a)[4] = h ? a1 : a0;
      a[0] = nibble_pair(c0);
      a[1] = nibble_pair(c1);
      a[2] = nibble_pair(c0 >> 4);
      a[3] = nibble_pair(c1 >> 4);
    }
  }
  __device__ static void frags(const unsigned char* ws, int col, int lane,
                               uint32_t (&a)[4][4]) {
    half(ws, col, lane, 0, a[0], a[1]);
    half(ws, col, lane, 1, a[2], a[3]);
  }
};

// The split-half bytes (K/2, N) int8, viewed as (4, K/8, N): group g's
// byte row k8 holds plane g (k = g*K/8 + k8) low and plane g + 4 (k = K/2
// + g*K/8 + k8) high.  A tile is word rows 8kt .. 8kt + 7 of the four
// groups, 32 byte rows x kBN bytes, PlanesW's k values in PlanesW's
// bytes: kBN / 128 boxes of (4, 8, 128) bytes (the weight's map: dims (N,
// K/8, 4), strides N and K/8 * N bytes), byte row 8g + i of a box at
// 128(8g + i), in the 128-byte swizzle.  x as for PlanesW.  frags(): one
// ldmatrix.x4.trans of 16-bit units, lane l addressing row l of the box
// (group l / 8, word row l % 8) at the warp's 16 columns: register g holds
// bytes (2t, 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1, 2g + 1) of group g,
// so k16 step s's planes 2s, 2s + 1 are groups 2(s % 2) and 2(s % 2) + 1,
// low nibbles for s < 2 and high ones above: one load for the four steps.
struct BytesW : Bf16X {
  static constexpr bool kXTiled = true;
  static bool fits(int K, int N) { return K % 64 == 0 && N % 16 == 0; }
  static bool wmap(CUtensorMap* map, const void* w, int K, int N) {
    const cuuint64_t d[3] = {(cuuint64_t)N, (cuuint64_t)(K / 8), 4};
    const cuuint64_t st[2] = {(cuuint64_t)N, (cuuint64_t)(K / 8) * N};
    const cuuint32_t b[3] = {128, 8, 4};
    return make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, d, st, b);
  }
  template <int kBN>
  __host__ __device__ static constexpr int bytes() {
    return 32 * kBN;
  }
  __host__ __device__ static int tiles(int K) { return K / kBK; }
  template <int kBN>
  __device__ static void load(unsigned char* xs, unsigned char* ws,
                              const CUtensorMap* xmap,
                              const CUtensorMap* wmap, int kt, int r0,
                              int n0, uint64_t* bar) {
    tma_2d(xs, xmap, kt * kBK, r0, bar);
#pragma unroll
    for (int h = 0; h < kBN / 128; ++h)
      tma_3d(ws + h * 4096, wmap, n0 + 128 * h, 8 * kt, 0, bar);
  }
  __device__ static void frags(const unsigned char* ws, int col, int lane,
                               uint32_t (&a)[4][4]) {
    uint32_t m[4];
    ldmatrix_x4_trans(m, ws + (col >> 7) * 4096 + lane * 128 +
                             ((((col & 127) >> 4) ^ (lane & 7)) << 4));
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int sh = 4 * (s >> 1);              // high nibbles from step 2
      const uint32_t lo = m[2 * (s & 1)] >> sh;   // plane 2s
      const uint32_t hi = m[2 * (s & 1) + 1] >> sh;  // plane 2s + 1
      a[s][0] = nibble_pair(lo);                // column 2g
      a[s][1] = nibble_pair(lo >> 8);           // column 2g + 1
      a[s][2] = nibble_pair(hi);
      a[s][3] = nibble_pair(hi >> 8);
    }
  }
};

// The bf16-pair words (K/8, N) int32: PlanesW's word rows, tile, boxes and
// map; only the bits differ.  Plane 2p sits in bits [4p, 4p + 4) (byte p /
// 2, nibble p % 2), plane 2p + 1 in bits [16 + 4p, 20 + 4p) (byte 2 + p /
// 2), both biased by +8.  For steps 2kp and 2kp + 1 one byte permute a
// column puts bytes kp, 2 + kp of row 2t and kp, 2 + kp of row 2t + 1 in
// bytes 0-3: step 2kp's planes are the low nibbles of bytes (0, 2) and (1,
// 3), step 2kp + 1's the high ones.
struct PairsW : PlanesW {
  __device__ static void frags(const unsigned char* ws, int col, int lane,
                               uint32_t (&a)[4][4]) {
    uint2 u0, u1;
    words(ws, col, lane, &u0, &u1);
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      const uint32_t sel = kp | ((2 + kp) << 4) | ((4 + kp) << 8) |
                           ((6 + kp) << 12);
      const uint32_t c0 = __byte_perm(u0.x, u1.x, sel);  // column 2g
      const uint32_t c1 = __byte_perm(u0.y, u1.y, sel);  // column 2g + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t (&f)[4] = a[2 * kp + h];
        f[0] = biased_pair(c0 >> (4 * h));
        f[1] = biased_pair(c1 >> (4 * h));
        f[2] = biased_pair(c0 >> (8 + 4 * h));
        f[3] = biased_pair(c1 >> (8 + 4 * h));
      }
    }
  }
};

// grid (Ck, column blocks, row blocks) in clusters of the Ck blocks that
// split one output tile's K; block kx sums K tiles [kx * per, (kx + 1) *
// per).  Warps 0 .. 4kWG-1 consume, warp 4kWG produces.
template <class W, typename To, int kWG, int kBM>
__global__ void __launch_bounds__(128 * kWG + 32, (per_sm<kWG, kBM>()))
mm_rows_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ scale, To* __restrict__ out, int R,
               int K, int N) {
  using T = Tile<W, kWG, kBM>;
  constexpr int kBN = T::kBN, kS = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kRing);
  uint64_t* empty = full + kS;

  const int Ck = gridDim.x, kx = blockIdx.x;
  const int n0 = blockIdx.y * kBN, r0 = blockIdx.z * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;      // warpgroup, its warp
  const int ntiles = W::tiles(K);
  const int per = (ntiles + Ck - 1) / Ck;
  const int kt0 = kx * per;
  const int nt = max(0, min(ntiles, kt0 + per) - kt0);
  auto xs_of = [&](int i) { return smem + (i % kS) * T::kStage; };
  auto ws_of = [&](int i) { return xs_of(i) + T::kXBytes; };

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  using Acc = typename W::Acc;
  Acc acc[kBM / 2];
#pragma unroll
  for (int e = 0; e < kBM / 2; ++e) acc[e] = 0;

  if (warp == 4 * kWG) {
    // the producer: tile i into stage i % kS once the consumers released
    // tile i - kS there
    if (lane == 0)
      for (int i = 0; i < nt; ++i) {
        if (i >= kS) mbar_wait(&empty[i % kS], (i / kS - 1) & 1);
        mbar_expect(&full[i % kS], T::kStage);
        W::template load<kBN>(xs_of(i), ws_of(i), &xmap, &wmap, kt0 + i,
                              r0, n0, &full[i % kS]);
      }
    __syncwarp();
  } else {
    // a consumer warp: tile i's A fragments (4 MMA steps) are built while
    // tile i - 1's wgmmas run; its 4 wgmmas issue as one batch; once tile
    // i - 1's completed, its stage is released
    const int col = 64 * wg + 16 * wq;
    auto step = [&](int i, uint32_t (&a)[4][4]) {
      mbar_wait(&full[i % kS], (i / kS) & 1);
      W::frags(ws_of(i), col, lane, a);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < 4; ++s)
        W::template mma<kBM>(acc, a[s], smem_desc(xs_of(i) + 32 * s));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kS]);
    };
    uint32_t a0[4][4], a1[4][4];            // tiles 2m and 2m + 1
    for (int i = 0; i < nt; i += 2) {
      step(i, a0);
      if (i + 1 < nt) step(i + 1, a1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }

  // acc[4j + e]: column 64wg + 16wq + 2g + (e >> 1), row 8j + 2t + (e & 1)
  constexpr bool kInt = std::is_same<To, int32_t>::value;  // no scale
  const int cl = 64 * wg + 16 * wq + 2 * g;
  if (Ck == 1) {
    const int col = n0 + cl;
    if (warp < 4 * kWG && col < N) {      // N % 4 == 0: col + 1 < N too
      const float s0 = scale ? scale[col] : 1.f;
      const float s1 = scale ? scale[col + 1] : 1.f;
#pragma unroll
      for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * j + 2 * t + h;
          if (row >= R) continue;
          To* o = out + (int64_t)row * N + col;
          if constexpr (kInt) {
            *reinterpret_cast<int2*>(o) =
                make_int2(acc[4 * j + h], acc[4 * j + 2 + h]);
          } else {
            const float y0 = acc[4 * j + h] * s0;
            const float y1 = acc[4 * j + 2 + h] * s1;
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

  // the exchange in the accumulators' type: 4 of them a vector
  using V4 = typename std::conditional<kInt, int4, float4>::type;
  using V2 = typename std::conditional<kInt, int2, float2>::type;
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();                 // every warp is done with the ring
  Acc* xs = reinterpret_cast<Acc*>(smem);
  if (warp < 4 * kWG)
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        V2 v;
        v.x = acc[4 * j + h];
        v.y = acc[4 * j + 2 + h];
        *reinterpret_cast<V2*>(xs + (8 * j + 2 * t + h) * T::kAccStride +
                               cl) = v;
      }
  cluster.sync();                  // every block's partial is in place

  // block kx sums every Ck-th run of kThreads vectors over the ranks in
  // order 0 .. Ck-1 (the map of an offset in this block's shared memory
  // is the same offset in the other's: every block aligns its ring alike)
  constexpr int kPer = kBN / 4;                 // vectors per row
  for (int i = kx * T::kThreads + tid; i < kBM * kPer;
       i += Ck * T::kThreads) {
    const int row = i / kPer, c = 4 * (i % kPer);
    Acc* src = xs + row * T::kAccStride + c;
    V4 s = *reinterpret_cast<const V4*>(cluster.map_shared_rank(src, 0));
    for (int q = 1; q < Ck; ++q) {
      const V4 v =
          *reinterpret_cast<const V4*>(cluster.map_shared_rank(src, q));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int col = n0 + c;
    if (r0 + row < R && col < N) {              // N % 4 == 0: all 4 or none
      To* o = out + (int64_t)(r0 + row) * N + col;
      if constexpr (kInt) {
        *reinterpret_cast<int4*>(o) = s;
      } else {
        if (scale) {
          s.x *= scale[col];
          s.y *= scale[col + 1];
          s.z *= scale[col + 2];
          s.w *= scale[col + 3];
        }
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
  cluster.sync();                  // no block leaves while others read it
}

// x in the int4 formats' tile-local k order, xp[r, 64t + 8j + i] = x[r,
// j*K/8 + 8t + i]: one 16-byte run of 8 values a thread
__global__ void __launch_bounds__(256)
planes_x_kernel(const uint4* __restrict__ x, uint4* __restrict__ xp, int R,
                int K) {
  const int runs = K / 8;                       // 16-byte runs a row
  const int64_t n = (int64_t)R * runs;
  for (int64_t e = blockIdx.x * 256LL + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * 256) {
    const int r = (int)(e / runs), c = (int)(e % runs);  // c = 8t + j
    xp[e] = x[(int64_t)r * runs + (c % 8) * (K / 64) + c / 8];
  }
}

// x's and the weight's maps for format W at bm rows a block (x in the
// tile-local order where W::kXTiled)
template <class W>
bool make_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
               const void* w, int R, int K, int N, int bm) {
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)R};
  const cuuint64_t xs[1] = {(cuuint64_t)K * W::kXElem};
  const cuuint32_t xb[2] = {(cuuint32_t)W::kTileK, (cuuint32_t)bm};
  return make_map(xmap, W::kXType, 2, x, xd, xs, xb) &&
         W::wmap(wmap, w, K, N);
}

// make_maps through a small table of encoded maps: a map is a function of
// what it encodes (addresses, shape, box), so an entry that matches them
// is that map.  Decode steps call this body with the same weights and,
// through the caching allocator, mostly the same x, and a call's host time
// paces them.
template <class W>
bool cached_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                 const void* w, int R, int K, int N, int bm) {
  struct Entry {
    CUtensorMap xm, wm;
    const void* x = nullptr;
    const void* w = nullptr;
    int R = 0, K = 0, N = 0, bm = 0;
  };
  static Entry table[1024];
  static std::mutex mu;
  const uintptr_t h = (reinterpret_cast<uintptr_t>(x) >> 8) * 31 +
                      (reinterpret_cast<uintptr_t>(w) >> 8) + R * 7 + bm;
  std::lock_guard<std::mutex> lock(mu);
  Entry& e = table[h % 1024];
  if (e.x != x || e.w != w || e.R != R || e.K != K || e.N != N ||
      e.bm != bm) {
    e.x = nullptr;
    if (!make_maps<W>(&e.xm, &e.wm, x, w, R, K, N, bm)) return false;
    e.x = x;
    e.w = w;
    e.R = R;
    e.K = K;
    e.N = N;
    e.bm = bm;
  }
  *xmap = e.xm;
  *wmap = e.wm;
  return true;
}

template <class W, typename To, int kWG, int kBM>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
                   const float* scale, void* out, int R, int K, int N, int Ck,
                   cudaStream_t stream) {
  using T = Tile<W, kWG, kBM>;
  const int bytes = T::kBytes + 1024;           // + the ring's alignment
  // the shared-memory limit, once per device: a call's host time paces
  // the decode steps that launch this body
  static unsigned set_on = 0;                   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(set_on & (1u << dev))) {
    e = cudaFuncSetAttribute(mm_rows_kernel<W, To, kWG, kBM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    if (dev < 32) set_on |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Ck, (N + T::kBN - 1) / T::kBN, (R + kBM - 1) / kBM);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Ck;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = Ck > 1 ? 1 : 0;                // a cluster only to split K
  e = cudaLaunchKernelEx(&cfg, mm_rows_kernel<W, To, kWG, kBM>, xmap, wmap,
                         scale, static_cast<To*>(out), R, K, N);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The body with weight format W and output type To: bm rows (64, 128 or
// 256) and bn columns (128 or 256; 128 at bm 256) a block, K split over Ck
// blocks of a cluster (1 .. 8, at most one K tile each); a format with
// kXTiled first writes x in its tile-local order to xp (R x K bf16,
// 16-byte aligned); an integer format (int32 sums) writes them as they are,
// with no scale; cudaErrorInvalidValue for anything else, or for operands
// outside the contract.  The caller's rule picks them (kernels/
// quant_matmul.py rows_tiling).
template <class W, typename To>
int run(const void* x, void* xp, const void* w, const float* scale,
        void* out, int R, int K, int N, int bm, int bn, int Ck,
        cudaStream_t s) {
  constexpr bool kInt = std::is_same<typename W::Acc, int32_t>::value;
  static_assert(kInt == std::is_same<To, int32_t>::value,
                "int32 sums are written as int32, and only they");
  if (R <= 0 || K <= 0 || N <= 0 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (kInt && scale != nullptr) ||
      (reinterpret_cast<uintptr_t>(w) & 15) ||
      (W::kXTiled &&
       (xp == nullptr || (reinterpret_cast<uintptr_t>(xp) & 15))) ||
      !W::fits(K, N) || Ck < 1 || Ck > kMaxCluster || Ck > W::tiles(K) ||
      (R + bm - 1) / bm > 65535 || (N + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  if (W::kXTiled) {
    const int64_t n = (int64_t)R * (K / 8);
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    planes_x_kernel<<<blocks, 256, 0, s>>>(static_cast<const uint4*>(x),
                                           static_cast<uint4*>(xp), R, K);
    x = xp;
  }
  CUtensorMap xmap, wmap;
  if (!cached_maps<W>(&xmap, &wmap, x, w, R, K, N, bm))
    return (int)cudaErrorInvalidValue;
  if (bm == 64 && bn == 128)
    return (int)launch<W, To, 2, 64>(xmap, wmap, scale, out, R, K, N, Ck, s);
  if (bm == 64 && bn == 256)
    return (int)launch<W, To, 4, 64>(xmap, wmap, scale, out, R, K, N, Ck, s);
  if (bm == 128 && bn == 128)
    return (int)launch<W, To, 2, 128>(xmap, wmap, scale, out, R, K, N, Ck,
                                      s);
  if (bm == 128 && bn == 256)
    return (int)launch<W, To, 4, 128>(xmap, wmap, scale, out, R, K, N, Ck,
                                      s);
  if (bm == 256 && bn == 128)
    return (int)launch<W, To, 2, 256>(xmap, wmap, scale, out, R, K, N, Ck,
                                      s);
  return (int)cudaErrorInvalidValue;
}

// the weight formats' codes in p2t_quant_matmul_rows (kernels/
// quant_matmul.py _FORMATS)
enum Format : int { kInt8 = 0, kPlanes = 1, kBytes = 2, kPairs = 3 };

}  // namespace rows
}  // namespace

// K11a's and K11b's instantiations (BytesW, PairsW), in a translation unit
// of their own (quant_matmul_rows_int4.cu): p2t_quant_matmul_rows's
// arguments, fmt rows::kBytes or rows::kPairs
extern "C" int p2t_quant_matmul_rows_int4(const void* x, void* xp,
                                          const void* w, const void* scale,
                                          void* out, int R, int K, int N,
                                          int fmt, int bm, int bn, int ck,
                                          int dtype, void* stream);
