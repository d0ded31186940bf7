// Paged-KV decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `paged_decode` / `_paged_kernel` of
// src/repro/kernels/paged_decode.py: one query token per sequence attends
// its KV through a block table into a page pool shared by all sequences.
//
//   q            (B, Hq, D)                T = float or bf16
//   k/v pages    (Hkv, P, page_size, D)    T
//   block_tables (B, max_pages)            int32, page 0 is the scratch page
//   kv_len       (B,)                      int32, clamped to the capacity
//   out          (B, Hq, D)                T, f32 math cast at the end
//
// Bound: memory. At bf16 a call reads 2 * sum_b min(kv_len_b, cap) * Hkv *
// D * 2 bytes of K/V plus q and writes o; the arithmetic (4 flops per K/V
// element per query head of the group) is far below the card's balance
// point, so the design spends its effort on streaming K/V once:
//
//   * One block per (b, kv_head) when pack_gqa is set: the block scores all
//     `group` query heads against each K/V row, so each row crosses HBM
//     once. Without pack_gqa one block per (b, q_head) — more blocks, each
//     row read `group` times (the L2 may absorb part of it).
//   * The TPU grid's sequential axes (super-block, page) become a loop in
//     the block over chunks of `block_kv` rows. Each chunk's K and V rows
//     are copied into shared memory with 16-byte cp.async copies that
//     chase the block table row by row (the TPU kernel's scalar prefetch
//     becomes the block reading its own table), double-buffered so chunk
//     c+1 is in flight while chunk c is scored.
//   * The loop stops at min(kv_len, capacity): no page past the valid
//     prefix is fetched, and the in-chunk tail is never scored.
//   * A row group of `tpr` lanes owns one K/V row at a time: each lane holds
//     8 elements (one 16-byte bf16 vector or two f32 ones) of q per group
//     head in registers, reduces q.k over the row group with shuffles, and
//     keeps its own online-softmax state (m, l, acc) in fp32 registers.
//     The row groups' states are merged once at the end through shared
//     memory. A row with kv_len == 0 writes zeros.
//
// CUDA-core FMAs, no tensor cores: for one query token per head the
// product is a matrix-vector one; it uses neither wgmma nor TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxGroup = 8;
constexpr int kMaxHeadDim = 256;
constexpr int kLaneElems = 8;                   // elements a lane holds
constexpr int kMaxSmem = 232448;                // 227 KB opt-in per block

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16-byte async global->shared copy; src_bytes == 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

int lanes_per_row(int D, int vec) {
  int n_vec = D / vec, tpr = 1;
  while (tpr < n_vec && tpr < kWarp) tpr <<= 1;
  return tpr;
}

template <typename T, int G>
__global__ void paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ kv_len, T* __restrict__ out, int Hq, int Hkv,
    int D, int n_pages, int page_size, int max_pages, float scale,
    int block_kv, int packed, int group, int tpr) {
  constexpr int VEC = Vec<T>::N;
  constexpr int NV = kLaneElems / VEC;          // vectors per lane: 1 or 2
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int heads_per_row = packed ? Hkv : Hq;
  const int b = blockIdx.x / heads_per_row;
  const int h = blockIdx.x % heads_per_row;
  const int kvh = packed ? h : h / group;
  const int qh0 = packed ? h * group : h;
  const int cap = max_pages * page_size;
  int L = kv_len[b];
  L = L < 0 ? 0 : (L > cap ? cap : L);

  const int n_vec = D / VEC;
  const int sub = (threadIdx.x % kWarp) % tpr;  // lane within its row group
  const int rg = threadIdx.x / tpr;             // row group of this thread
  const int n_rg = blockDim.x / tpr;

  float qf[G][kLaneElems];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qrow = q + ((size_t)b * Hq + qh0 + g) * D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = sub + j * tpr;
      if (vi < n_vec) {
        load_vec(qrow + vi * VEC, &qf[g][j * VEC]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[g][j * VEC + e] *= scale;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[g][j * VEC + e] = 0.f;
      }
    }
  }

  float m[G], l[G], acc[G][kLaneElems];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) acc[g][e] = 0.f;
  }

  T* ks = reinterpret_cast<T*>(smem_raw);       // [2][block_kv][D]
  T* vs = ks + 2 * (size_t)block_kv * D;
  const size_t head_stride = (size_t)n_pages * page_size * D;
  const T* kbase = k_pages + kvh * head_stride;
  const T* vbase = v_pages + kvh * head_stride;
  const int* tbl = tables + (size_t)b * max_pages;
  const int n_chunks = (L + block_kv - 1) / block_kv;

  auto issue = [&](int c, int buf) {
    const int t0 = c * block_kv;
    const int total = block_kv * n_vec;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / n_vec, vi = i % n_vec;
      const int pos = t0 + r;
      const bool ok = pos < L;
      int page = ok ? tbl[pos / page_size] : 0;
      page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
      const size_t goff =
          ((size_t)page * page_size + (ok ? pos % page_size : 0)) * D +
          vi * VEC;
      const size_t soff = ((size_t)buf * block_kv + r) * D + vi * VEC;
      cp_async16(ks + soff, kbase + goff, ok);
      cp_async16(vs + soff, vbase + goff, ok);
    }
    cp_async_commit();
  };

  if (n_chunks > 0) issue(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      issue(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int rows = min(block_kv, L - c * block_kv);
    const T* kc = ks + (size_t)buf * block_kv * D;
    const T* vc = vs + (size_t)buf * block_kv * D;
    const int iters = (rows + n_rg - 1) / n_rg;   // uniform over the block
    for (int it = 0; it < iters; ++it) {
      const int r = it * n_rg + rg;
      const bool valid = r < rows;
      float kf[kLaneElems], vf[kLaneElems];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int vi = sub + j * tpr;
        if (valid && vi < n_vec) {
          load_vec(kc + (size_t)r * D + vi * VEC, &kf[j * VEC]);
          load_vec(vc + (size_t)r * D + vi * VEC, &vf[j * VEC]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            kf[j * VEC + e] = 0.f;
            vf[j * VEC + e] = 0.f;
          }
        }
      }
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e) dot = fmaf(qf[g][e], kf[e], dot);
        for (int off = tpr >> 1; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[g] = dot;
      }
      if (valid) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float m_new = fmaxf(m[g], s[g]);
          const float alpha = __expf(m[g] - m_new);
          const float p = __expf(s[g] - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < kLaneElems; ++e)
            acc[g][e] = fmaf(p, vf[e], acc[g][e] * alpha);
          m[g] = m_new;
        }
      }
    }
    __syncthreads();
  }

  // Merge the row groups' online-softmax states (staging smem reused).
  float* ms = reinterpret_cast<float*>(smem_raw);  // [n_rg][G]
  float* ls = ms + n_rg * G;                       // [n_rg][G]
  float* as = ls + n_rg * G;                       // [n_rg][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (sub == 0) {
      ms[rg * G + g] = m[g];
      ls[rg * G + g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = sub + j * tpr;
      if (vi < n_vec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          as[((size_t)rg * G + g) * D + vi * VEC + e] = acc[g][j * VEC + e];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float M = -INFINITY;
    for (int i = 0; i < n_rg; ++i) M = fmaxf(M, ms[i * G + g]);
    float o = 0.f;
    if (M != -INFINITY) {
      float lsum = 0.f, a = 0.f;
      for (int i = 0; i < n_rg; ++i) {
        const float mi = ms[i * G + g];
        const float w = mi == -INFINITY ? 0.f : __expf(mi - M);
        lsum += ls[i * G + g] * w;
        a += as[((size_t)i * G + g) * D + d] * w;
      }
      o = lsum > 0.f ? a / lsum : 0.f;
    }
    store_elem(out + ((size_t)b * Hq + qh0 + g) * D + d, o);
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tables, const int* kv_len, void* out, int B,
                   int Hq, int Hkv, int D, int n_pages, int page_size,
                   int max_pages, float scale, int block_kv, int packed,
                   int threads, int tpr, int smem, cudaStream_t stream) {
  auto kern = paged_decode_kernel<T, G>;
  static int configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const int rows = B * (packed ? Hkv : Hq);
  kern<<<rows, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, kv_len, static_cast<T*>(out), Hq,
      Hkv, D, n_pages, page_size, max_pages, scale, block_kv, packed,
      Hq / Hkv, tpr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int G, const void* q, const void* kp, const void* vp,
                     const int* tables, const int* kv_len, void* out, int B,
                     int Hq, int Hkv, int D, int n_pages, int page_size,
                     int max_pages, float scale, int block_kv, int packed,
                     int threads, int tpr, int smem, cudaStream_t stream) {
#define PD_CASE(g)                                                          \
  case g:                                                                   \
    return launch<T, g>(q, kp, vp, tables, kv_len, out, B, Hq, Hkv, D,      \
                        n_pages, page_size, max_pages, scale, block_kv,     \
                        packed, threads, tpr, smem, stream);
  switch (G) {
    PD_CASE(1) PD_CASE(2) PD_CASE(3) PD_CASE(4)
    PD_CASE(5) PD_CASE(6) PD_CASE(7) PD_CASE(8)
  }
#undef PD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs: the double-buffered K/V staging
// area, reused afterwards for the row-group merge.
int paged_decode_smem_bytes(int D, int dtype_bytes, int block_kv, int group,
                            int packed, int num_warps) {
  const int vec = 16 / dtype_bytes;
  const int G = packed ? group : 1;
  const int n_rg = num_warps * kWarp / lanes_per_row(D, vec);
  const int staging = 2 * 2 * block_kv * D * dtype_bytes;
  const int merge = n_rg * G * (D + 2) * 4;
  return staging > merge ? staging : merge;
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int paged_decode_launch(const void* q, const void* k_pages,
                        const void* v_pages, const int* block_tables,
                        const int* kv_len, void* out, int B, int Hq, int Hkv,
                        int D, int n_pages, int page_size, int max_pages,
                        float scale, int block_kv, int pack_gqa,
                        int num_warps, int dtype, void* stream) {
  const int dtype_bytes = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > kMaxHeadDim || (D * dtype_bytes) % 16 != 0 || block_kv <= 0 ||
      num_warps <= 0 || num_warps > 32 || page_size <= 0 || max_pages <= 0)
    return cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  const int packed = pack_gqa && group > 1 ? 1 : 0;
  const int G = packed ? group : 1;
  if (G > kMaxGroup) return cudaErrorInvalidValue;
  const int threads = num_warps * kWarp;
  const int tpr = lanes_per_row(D, 16 / dtype_bytes);
  const int smem = paged_decode_smem_bytes(D, dtype_bytes, block_kv, group,
                                           packed, num_warps);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(G, q, k_pages, v_pages, block_tables, kv_len, out,
                           B, Hq, Hkv, D, n_pages, page_size, max_pages,
                           scale, block_kv, packed, threads, tpr, smem, s);
  return dispatch<__nv_bfloat16>(G, q, k_pages, v_pages, block_tables,
                                 kv_len, out, B, Hq, Hkv, D, n_pages,
                                 page_size, max_pages, scale, block_kv,
                                 packed, threads, tpr, smem, s);
}

}  // extern "C"
