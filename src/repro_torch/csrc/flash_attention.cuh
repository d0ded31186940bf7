// Device helpers shared by the flash-attention kernels (flash_attention.cu,
// the forward, and flash_attention_bwd.cu): 16-byte cp.async staging of
// (rows, D) tiles into shared memory with the ragged edge zero-filled, and
// the mma.sync m16n8k16 bf16 products (with their IEEE-FMA f32
// counterparts) in the accumulator-fragment layout both kernels keep: a
// warp holds 16 rows, lane (g, t) = (lane / 4, lane % 4) rows g and g + 8
// at columns 8 j + 2t and + 1 of each 8-column tile j.

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 and receives, of each matrix, row l / 4 at
// columns 2 (l % 4) and + 1 (with .trans: column l / 4 at rows 2 (l % 4)
// and + 1), the mma.sync fragment layouts.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// s (16 rows x NT 8-key tiles, accumulator layout) = q rows . k rows, over
// the dp staged columns. Lane (g, t) = (lane / 4, lane % 4) holds rows g
// and g + 8 at keys j * 8 + 2t and + 1 of tile j.
template <int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4], const bf16* qs,
                                   const bf16* ks, int rs, int dp, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  // q: matrices rows 0-7 and 8-15 at columns k0 and k0 + 8 (a0..a3); k:
  // keys j*8 and (j+1)*8 + 0..7 at columns k0 and k0 + 8 (b of tiles j and
  // j + 1)
  const bf16* qrow = qs + ((mi & 1) * 8 + ri) * rs + (mi >> 1) * 8;
  const bf16* krow = ks + ((mi >> 1) * 8 + ri) * rs + (mi & 1) * 8;
  for (int k0 = 0; k0 < dp; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, qrow + k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, krow + j * 8 * rs + k0);
      mma_bf16(s[j], a, b);
      mma_bf16(s[j + 1], a, b + 2);
    }
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
// x and y rounded to bf16 (hi) and what the rounding left (lo), packed.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const float xh = __bfloat162float(__float2bfloat16_rn(x));
  const float yh = __bfloat162float(__float2bfloat16_rn(y));
  hi = pack_bf16(xh, yh);
  lo = pack_bf16(x - xh, y - yh);
}

template <int NT, int DT>
__device__ __forceinline__ void pv(float (&o)[DT][4], const float (&s)[NT][4],
                                   const bf16* vs, int rs, int dp, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {  // 16 keys a step
    uint32_t hi[4], lo[4];
    split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
    // matrices: keys kk*16 + 0..7 and + 8..15, columns n0 + 0..7 and + 8..15
    const bf16* vrow = vs + (kk * 16 + (mi & 1) * 8 + ri) * rs + (mi >> 1) * 8;
#pragma unroll
    for (int np = 0; np < DT / 2; ++np) {
      if (np * 16 < dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vrow + np * 16);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(o[2 * np], hi, b0);
        mma_bf16(o[2 * np], lo, b0);
        mma_bf16(o[2 * np + 1], hi, b1);
        mma_bf16(o[2 * np + 1], lo, b1);
      }
    }
  }
}

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
