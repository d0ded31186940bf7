// Hopper (sm_90a) GEMM building blocks shared by the wgmma branches of
// matmul.cu (bf16) and matmul_w8a8.cu (int8), beside hopper.cuh's
// mbarriers, TMA loads and K-major descriptors:
//
//   * 2-D tensor maps of row-major bf16 or int8 matrices cut in boxes of one
//     128-byte row of K (64 bf16 or 128 int8 values) by up to 256 rows, or of
//     64 columns by 64 rows, with 128-byte swizzle (hopper.cuh's tile
//     layout: the 16-byte chunk c of row r lands at chunk c ^ (r % 8), every
//     box on 1024 bytes);
//   * a TMA tile store (shared -> global) with its bulk-group commit and
//     waits, and the proxy fence that orders plain shared-memory writes
//     before it;
//   * the descriptor of an MN-major operand of several 64-wide atoms;
//   * wgmma m64nNk16 bf16 -> f32 with A K-major and B MN-major (y (K, N)
//     row-major, read transposed: no K-major copy of y), N 64, 128 and 256;
//     and m64nNk32 .s32.s8.s8 with both operands K-major, N 8, 16, 32, 64,
//     128 and 256. Both take 32 bytes of K a step, so a K-major operand's
//     descriptor advances 32 bytes a step inside its 128-byte row;
//   * a named barrier over a thread count, the grouped tile order, and the
//     card's SM count.
//
// The accumulator layout is hopper.cuh's for f32 and s32 alike: warp w of
// the warpgroup holds rows 16 w + g and 16 w + g + 8, g = lane / 4;
// register 4 j + e holds column 8 j + 2 (lane % 4) + (e & 1) of row
// g + 8 (e >> 1).

#pragma once

#include "hopper.cuh"

namespace gemm {

// ---------------------------------------------------------------- host side

// A rows x cols row-major matrix (cols contiguous, cols * itemsize a
// multiple of 16 bytes, the base 16-byte aligned) cut in boxes of
// box_cols x box_rows (box_cols * itemsize <= 128), 128-byte swizzled;
// elements past the matrix read as zeros and are not written.
inline bool map2d(CUtensorMap* m, CUtensorMapDataType type, int itemsize,
                  const void* base, long long rows, long long cols,
                  int box_rows, int box_cols) {
  hopper::EncodeTiled enc = hopper::encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * itemsize)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return enc(m, type, 2, const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Streaming multiprocessors of the current device.
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// ------------------------------------------------------------- device side

// Tile `tile` of a tiles_m x tiles_n grid in grouped order: `group` row
// panels at a time, column-major inside a group, so the column panels a
// wave of blocks reads stay in L2 across the group's rows.
__host__ __device__ __forceinline__ void tile_coords(int tile, int tiles_m,
                                                     int tiles_n, int group,
                                                     int& pm, int& pn) {
  const int in_group = group * tiles_n;
  const int first_m = (tile / in_group) * group;
  const int group_m = tiles_m - first_m < group ? tiles_m - first_m : group;
  pm = first_m + (tile % in_group) % group_m;
  pn = (tile % in_group) / group_m;
}

// Waits for `threads` threads (a multiple of 32) at barrier `id` (1-15; 0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's plain shared-memory writes before the async proxy's
// reads (a TMA store).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box from `src` (shared) to (column c, row r) of the map's matrix.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(hopper::smem_u32(src)), "r"(c), "r"(r)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the stores of this thread's groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Until the stores of this thread's groups are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Descriptor of an MN-major 128-byte-swizzled operand (rows along K, 64
// values of M or N a row): 8-row groups 1024 bytes apart (the stride
// offset), 64-wide atoms `atom_bytes` apart (the leading offset). A K step
// of 16 rows advances the address by 2048 bytes.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr,
                                            uint32_t atom_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(atom_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving reads or writes of s32 accumulators
// across a wgmma issue or wait (hopper::fence_acc for f32).
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define GEMM_F8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define GEMM_I8(i)                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 64, f32) (+)= a (64 x 16, K-major) . b (16 x 64, MN-major).
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : GEMM_F8(0), GEMM_F8(8), GEMM_F8(16), GEMM_F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) (+)= a (64 x 16, K-major) . b (16 x 128, MN-major).
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : GEMM_F8(0), GEMM_F8(8), GEMM_F8(16), GEMM_F8(24), GEMM_F8(32),
        GEMM_F8(40), GEMM_F8(48), GEMM_F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256, f32) (+)= a (64 x 16, K-major) . b (16 x 256, MN-major).
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : GEMM_F8(0), GEMM_F8(8), GEMM_F8(16), GEMM_F8(24), GEMM_F8(32),
        GEMM_F8(40), GEMM_F8(48), GEMM_F8(56), GEMM_F8(64), GEMM_F8(72),
        GEMM_F8(80), GEMM_F8(88), GEMM_F8(96), GEMM_F8(104),
        GEMM_F8(112), GEMM_F8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 8, s32) (+)= a (64 x 32, K-major) . b (32 x 8, K-major).
__device__ __forceinline__ void wgmma_s8_n8(int (&d)[4], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16, s32) (+)= a (64 x 32, K-major) . b (32 x 16, K-major).
__device__ __forceinline__ void wgmma_s8_n16(int (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p;\n}\n"
      : GEMM_I8(0)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32, s32) (+)= a (64 x 32, K-major) . b (32 x 32, K-major).
__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p;\n}\n"
      : GEMM_I8(0), GEMM_I8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, s32) (+)= a (64 x 32, K-major) . b (32 x 64, K-major).
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : GEMM_I8(0), GEMM_I8(8), GEMM_I8(16), GEMM_I8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, s32) (+)= a (64 x 32, K-major) . b (32 x 128, K-major).
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : GEMM_I8(0), GEMM_I8(8), GEMM_I8(16), GEMM_I8(24), GEMM_I8(32),
        GEMM_I8(40), GEMM_I8(48), GEMM_I8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256, s32) (+)= a (64 x 32, K-major) . b (32 x 256, K-major).
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p;\n}\n"
      : GEMM_I8(0), GEMM_I8(8), GEMM_I8(16), GEMM_I8(24), GEMM_I8(32),
        GEMM_I8(40), GEMM_I8(48), GEMM_I8(56), GEMM_I8(64), GEMM_I8(72),
        GEMM_I8(80), GEMM_I8(88), GEMM_I8(96), GEMM_I8(104),
        GEMM_I8(112), GEMM_I8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}


#undef GEMM_F8
#undef GEMM_I8

// The bf16 product of N columns; scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_bf16_n64(d, da, db, scale_d);
  else if constexpr (N == 128)
    wgmma_bf16_n128(d, da, db, scale_d);
  else
    wgmma_bf16_n256(d, da, db, scale_d);
}

// The int8 product of N columns; scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 8)
    wgmma_s8_n8(d, da, db, scale_d);
  else if constexpr (N == 16)
    wgmma_s8_n16(d, da, db, scale_d);
  else if constexpr (N == 32)
    wgmma_s8_n32(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_s8_n64(d, da, db, scale_d);
  else if constexpr (N == 128)
    wgmma_s8_n128(d, da, db, scale_d);
  else
    wgmma_s8_n256(d, da, db, scale_d);
}

}  // namespace gemm
