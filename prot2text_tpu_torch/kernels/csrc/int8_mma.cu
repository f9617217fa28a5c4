// K15f: int8 x int8 matmul on the int8 tensor cores, exact,
//
//   y[r, n] = sum_k x[r, k] * w[k, n]          (int32, no scale)
//
// x (R, K) int8, w (K, N) int8 row-major, y (R, N) int32.
//
// Replaces scripts/bench_int8_mxu.py mm_i8i8 (`:102`, body `_i8_kernel`
// `:85`), the TPU probe of whether an int8 x int8 product runs at the int8
// rate.  The TPU kernel walked an (N/bn, K/bk) grid in order, carrying an
// int32 sum in VMEM.
//
// Bound: at the probe's R 128, bytes.  The weight (4096, 14336) is 58.7 MB
// and the int32 output 7.3 MB: 19.9 us at 3.35 TB/s; its 15.0 G operations
// take 7.6 us at the int8 dense rate (1979 TOP/s).  A product reaches the
// int8 rate only from about 2R operations per weight byte = 590, R ~ 300.
// So the weight has to stream at the memory's rate, as K15g's does on the
// many-row body (quant_matmul_rows.cuh) over the same weight; this is that
// body with an integer policy, `S8W`:
//   - the product runs transposed, y^T = w^T x^T, on wgmma
//     m64nBMk32.s32.s8.s8: 8-bit operands have no transpose bit, so both
//     shared-memory operands would have to be K-major.  x (R, K) row-major
//     is: it is B, one TMA box of BM rows x 128 bytes (128 k values) a
//     tile in the 128-byte swizzle, read by the body's descriptor, whose
//     k32 step moves 32 bytes as a bf16 k16 step does.  The weight (K, N)
//     is N-major, so A comes from registers, as for every weight policy of
//     the body: a tile is 128 k rows x BN columns, BN / 128 boxes of 128
//     rows x 128 bytes;
//   - an A register of the m64k32 8-bit fragment holds 4 consecutive k of
//     one MMA row: a0 (row g, k 4t .. 4t+3), a1 (row g + 8), a2 and a3 the
//     same at k 16 + 4t.  Row g stands for column 2g of the warp's 16 and
//     row g + 8 for column 2g + 1 (the body's epilogue layout).  One
//     ldmatrix.x4.trans of 16-bit units a k32 step gives thread (g, t), in
//     matrix m, the two columns' bytes of the two k rows its lanes 8m + 2t
//     and 8m + 2t + 1 address; so lanes choose k rows 4t + h + 2((m & 1)
//     ^ (t >> 1)) (+ 16 for m >= 2): matrices 0 and 1 hold k 4t .. 4t+3
//     between them (swapped for t >= 2, so that each matrix's eight rows
//     fall on eight distinct 16-byte chunks of the swizzle: no bank
//     conflict), and one byte permute a register builds each column's
//     four k values;
//   - int32 sums are exact in any order: the cluster's split of K sums its
//     partials as int32 through distributed shared memory, one launch, and
//     two launches give the same bits.
// The weight is read once (BM 128 holds the probe's 128 rows); no int8 ->
// bf16 conversion runs, and a tile needs half of K15g's MMAs per k.
// Contract: any R >= 1, K % 16 == 0 and N % 16 == 0 (TMA's row strides;
// kernels/probe_quant_matmul.py pads N % 4 == 0 to it), x and w 16-byte
// aligned.
#include "quant_matmul_rows.cuh"

namespace {
namespace rows {

// d (the warpgroup's 64 weight columns x N rows, int32) += a (64 x 32 s8,
// registers) · b (32 x N s8 of x, K-major in shared memory)
template <int N>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int32_t (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int32_t (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int32_t (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The int8 x int8 policy (K15f): x int8, 128 k values a tile, int32 sums.
struct S8W {
  using Acc = int32_t;
  static constexpr CUtensorMapDataType kXType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int kXElem = 1;
  static constexpr int kTileK = 128;
  static constexpr bool kXTiled = false;
  template <int N>
  __device__ static void mma(int32_t (&d)[N / 2], const uint32_t (&a)[4],
                             uint64_t b) {
    wgmma_s8<N>(d, a, b);
  }
  static bool fits(int K, int N) { return K % 16 == 0 && N % 16 == 0; }
  static bool wmap(CUtensorMap* map, const void* w, int K, int N) {
    return make_wmap_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, 128,
                        kTileK);
  }
  template <int kBN>
  __host__ __device__ static constexpr int bytes() {
    return kTileK * kBN;
  }
  __host__ __device__ static int tiles(int K) {
    return (K + kTileK - 1) / kTileK;
  }
  template <int kBN>
  __device__ static void load(unsigned char* xs, unsigned char* ws,
                              const CUtensorMap* xmap,
                              const CUtensorMap* wmap, int kt, int r0,
                              int n0, uint64_t* bar) {
    tma_2d(xs, xmap, kt * kTileK, r0, bar);
#pragma unroll
    for (int h = 0; h < kBN / 128; ++h)
      tma_2d(ws + h * 128 * kTileK, wmap, n0 + 128 * h, kt * kTileK, bar);
  }
  // the A fragments of k32 steps 0 .. 3 of the tile at the warp's 16
  // columns col .. col + 15
  __device__ static void frags(const unsigned char* ws, int col, int lane,
                               uint32_t (&a)[4][4]) {
    const int m = lane >> 3, tq = (lane >> 1) & 3, h = lane & 1;
    const int kl = 16 * (m >> 1) + 4 * tq + h + 2 * ((m & 1) ^ (tq >> 1));
    const unsigned char* box = ws + (col >> 7) * 128 * kTileK;
    const int chunk = (col & 127) >> 4;
    // k 4t .. 4t+3 of column 2g from registers 0 and 1 (bytes 0 and 2 of
    // each), of column 2g + 1 bytes 1 and 3; swapped for t >= 2
    const int t = lane & 3;
    const uint32_t sel = (t & 2) ? 0x2064u : 0x6420u;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = 32 * s + kl;
      uint32_t r[4];
      ldmatrix_x4_trans(r, box + k * 128 + ((chunk ^ (k & 7)) << 4));
      a[s][0] = __byte_perm(r[0], r[1], sel);
      a[s][1] = __byte_perm(r[0], r[1], sel + 0x1111u);
      a[s][2] = __byte_perm(r[2], r[3], sel);
      a[s][3] = __byte_perm(r[2], r[3], sel + 0x1111u);
    }
  }
};

}  // namespace rows
}  // namespace

// x (R, K) int8, w (K, N) int8, out (R, N) int32: bm rows and bn columns
// a block, K split over ck blocks of a cluster (kernels/
// probe_quant_matmul.py i8_tiling picks them); K % 16 == 0, N % 16 == 0,
// x and w 16-byte aligned, else cudaErrorInvalidValue
extern "C" int p2t_int8_mma(const void* x, const void* w, void* out, int R,
                            int K, int N, int bm, int bn, int ck,
                            void* stream) {
  return rows::run<rows::S8W, int32_t>(x, nullptr, w, nullptr, out, R, K, N,
                                       bm, bn, ck,
                                       static_cast<cudaStream_t>(stream));
}
