// Device helpers of the f32 branch of the flash-attention kernels
// (flash_attention.cu, the forward, and flash_attention_bwd.cu): 16-byte
// cp.async staging of (rows, D) tiles into shared memory with the ragged
// edge zero-filled, and the products q.k and p.v with IEEE fmaf on the CUDA
// cores in the mma.sync accumulator-fragment layout: a warp holds 16 rows,
// lane (g, t) = (lane / 4, lane % 4) rows g and g + 8 at columns 8 j + 2t
// and + 1 of each 8-column tile j. The bf16 branch's wgmma, TMA and
// mbarrier helpers are in hopper.cuh; the row reductions and stores below
// serve both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

inline int round16(int d) { return (d + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 16 or 0 (0 zero-fills, reads nothing).
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage `rows` rows of dp elements (src rows `stride` elements apart; rows
// from `valid` on and columns from D on zero-filled) at row stride rs.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long stride,
                                      int rows, int valid, int rs, int D,
                                      int dp) {
  constexpr int E = 16 / sizeof(T);  // elements a chunk
  const int cpr = dp / E;            // chunks a staged row
  const int data = D / E;            // chunks that hold data
  for (int c = threadIdx.x; c < rows * cpr; c += blockDim.x) {
    const int r = c / cpr, ch = c - r * cpr;
    const bool ok = r < valid && ch < data;
    cp16(dst + r * rs + ch * E, ok ? src + r * stride + ch * E : src,
         ok ? 16 : 0);
  }
}

template <int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4], const float* qs,
                                   const float* ks, int rs, int dp,
                                   int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int d = 0; d < dp; d += 4) {
    const float4 qa = *reinterpret_cast<const float4*>(qs + g * rs + d);
    const float4 qb = *reinterpret_cast<const float4*>(qs + (g + 8) * rs + d);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* kp = ks + (j * 8 + 2 * t) * rs + d;
      const float4 ka = *reinterpret_cast<const float4*>(kp);
      const float4 kb = *reinterpret_cast<const float4*>(kp + rs);
      s[j][0] = fmaf(qa.w, ka.w, fmaf(qa.z, ka.z,
                fmaf(qa.y, ka.y, fmaf(qa.x, ka.x, s[j][0]))));
      s[j][1] = fmaf(qa.w, kb.w, fmaf(qa.z, kb.z,
                fmaf(qa.y, kb.y, fmaf(qa.x, kb.x, s[j][1]))));
      s[j][2] = fmaf(qb.w, ka.w, fmaf(qb.z, ka.z,
                fmaf(qb.y, ka.y, fmaf(qb.x, ka.x, s[j][2]))));
      s[j][3] = fmaf(qb.w, kb.w, fmaf(qb.z, kb.z,
                fmaf(qb.y, kb.y, fmaf(qb.x, kb.x, s[j][3]))));
    }
  }
}

// o (16 rows x DT 8-column tiles of D, accumulator layout) += p . v, p the
// probabilities in s's layout.
template <int NT, int DT>
__device__ __forceinline__ void pv(float (&o)[DT][4], const float (&s)[NT][4],
                                   const float* vs, int rs, int dp, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll 1
      for (int tt = 0; tt < 4; ++tt) {  // the quad lane holding key 2tt + e
        const int src = (lane & ~3) | tt;
        const float pg = __shfl_sync(0xffffffffu, s[j][e], src);
        const float pg8 = __shfl_sync(0xffffffffu, s[j][2 + e], src);
        const float* vr = vs + (j * 8 + 2 * tt + e) * rs + 2 * t;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          if (n * 8 < dp) {
            const float2 w = *reinterpret_cast<const float2*>(vr + n * 8);
            o[n][0] = fmaf(pg, w.x, o[n][0]);
            o[n][1] = fmaf(pg, w.y, o[n][1]);
            o[n][2] = fmaf(pg8, w.x, o[n][2]);
            o[n][3] = fmaf(pg8, w.y, o[n][3]);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
