// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels
// (flash_attention.cu and flash_attention_bwd.cu), as inline PTX:
//
//   * mbarriers: init, arrive, arrive with an expected transaction count,
//     and a parity wait;
//   * TMA: tensor maps encoded on the host (cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint, so nothing links against libcuda),
//     4-D bf16 tile loads with 128-byte swizzle and 2-D f32 row loads
//     (cp.async.bulk.tensor), each completing on an mbarrier;
//   * wgmma: shared-memory descriptors of 128-byte-swizzled tiles, the
//     products m64n64k16 and m64n128k16 with both operands in shared memory
//     (K-major) and m64n64k16 with A in registers and B MN-major, and
//     wgmma.fence, commit_group and wait_group;
//   * the accumulator-fragment -> bf16 A-fragment repack, and 2^x on the
//     special-function unit;
//   * the warpgroup index as a warp-uniform value.
//
// Tile layout. A (rows x D) bf16 tile sits in shared memory as ceil(D/64)
// column blocks of (rows x 64) elements, one 128-byte row each, written by
// TMA boxes of 64 x 64 with CU_TENSOR_MAP_SWIZZLE_128B (the 16-byte chunk c
// of row r lands at chunk c ^ (r % 8)); every block starts on 1024 bytes.
// Columns from D to the block's end are zero-filled by TMA, as are rows
// past the sequence, so D 96, 120 and 160 run unpadded in memory.
//
// Accumulator layout of wgmma.m64nN (f32): warp w of the warpgroup holds
// rows 16 w + g and 16 w + g + 8, g = lane / 4; register 4 j + e holds
// column 8 j + 2 (lane % 4) + (e & 1) of row g + 8 (e >> 1).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (B, H, S, D) bf16 tensor with D contiguous and the other strides in
// elements, cut in boxes of 64 rows x 64 columns, 128-byte swizzled.
inline bool tile_map(CUtensorMap* m, const void* base, int B, int H, int S,
                     int D, long long sb, long long sh, long long ss) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `rows` rows of n f32 values, ld apart (ld x 4 bytes a multiple of 16),
// read `box` values of one row at a time (past n: zeros).
inline bool rows_map(CUtensorMap* m, const float* base, long long rows,
                     int n, long long ld, int box) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t boxes[2] = {(cuuint32_t)box, 1};
  const cuuint32_t step[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(base), dims, strides, boxes, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = smem_u32(p);
  return p + ((1024 - (s & 1023)) & 1023);
}

// The calling thread's warpgroup, taken from lane 0 so that the compiler
// sees one value across the warp: branches on it are uniform, as wgmma
// needs them to be (ptxas serialises wgmma on a path it cannot prove
// uniform).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival, and `bytes` more to come from TMA before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. The poll loop
// sits inside the PTX, so the compiler sees no divergent branch around the
// products that follow; a wait that outlasts 2^26 polls (seconds, where a
// tile takes microseconds) traps, so a fault in the protocol fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 67108864;\n"
      "@p bra LAB_WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA ----------------------------------------------------------------------

// Brings a tensor map into the cache ahead of its first load.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One 64 x 64 box at (column c, row r, head h, batch b) into `dst`.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         int c, int r, int h, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(h), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// One box of f32 values from (element i, row r) into `dst`.
__device__ __forceinline__ void tma_row(void* dst, const CUtensorMap* map,
                                        int i, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(i), "r"(r),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma --------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `addr`: 8-row
// groups 1024 bytes apart (the stride byte offset). K-major (a row's K
// elements contiguous): the leading offset is unused and K steps of 16
// advance the address by 32 bytes. MN-major (rows along K, 64 elements of
// M or N a row): one 64-wide atom per product, K steps of 16 advance it by
// 2048 bytes; both offsets are 1024.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_D8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) (+)= a (64 x 16, shared, K-major) . b (16 x 64, shared,
// K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128) (+)= a (64 x 16, shared, K-major) . b (16 x 128, shared,
// K-major).
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// The product of N columns (64 or 128) with both operands in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_ss64(d, da, db, scale_d);
  else
    wgmma_ss128(d, da, db, scale_d);
}

// d (64 x 64) += a (64 x 16, registers: the A fragment) . b (16 x 64,
// shared, MN-major).
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HOPPER_D8

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The A fragments of a (64 x N) f32 accumulator as the left operand of a
// product over its N columns, 16 a step: step k holds rows g and g + 8 at
// columns 16 k + 2 (lane % 4) (+ 1) and + 8. A value enters as bf16 terms:
// hi its rounding, lo what the rounding left, so the two products carry 16
// bits of it. One conversion a pair for each term: the rounded pair's f32
// values are read back from its bits.
template <int N>
__device__ __forceinline__ void split_frags(const float (&s)[N / 2],
                                            uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = s[8 * k + 2 * i], y = s[8 * k + 2 * i + 1];
      const uint32_t h = pack_bf16x2(x, y);
      hi[k][i] = h;
      lo[k][i] = pack_bf16x2(x - __uint_as_float(h << 16),
                             y - __uint_as_float(h & 0xffff0000u));
    }
}

// Term `term` of split_frags alone (0: hi, 1: lo).
template <int N>
__device__ __forceinline__ void term_frags(const float (&s)[N / 2],
                                           uint32_t (&f)[N / 16][4],
                                           int term) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = s[8 * k + 2 * i], y = s[8 * k + 2 * i + 1];
      const uint32_t h = pack_bf16x2(x, y);
      f[k][i] = term == 0 ? h
                          : pack_bf16x2(x - __uint_as_float(h << 16),
                                        y - __uint_as_float(h & 0xffff0000u));
    }
}

}  // namespace hopper
