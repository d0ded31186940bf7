// Paged-KV decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `paged_decode` / `_paged_kernel` of
// src/repro/kernels/paged_decode.py: one query token per sequence attends
// its KV through a block table into a page pool shared by all sequences.
// Float pools, or int8 pools with per-token f32 scales (the kv8 policy,
// the TPU kernel's int8 branch).
//
//   q            (B, Hq, D)                Q = float or bf16
//   k/v pages    (Hkv, P, page_size, D)    KV = Q, or int8
//   k/v scales   (Hkv, P, page_size)       f32, int8 pools only
//   block_tables (B, max_pages)            int32, page 0 is the scratch page
//   kv_len       (B,)                      int32, clamped to the capacity
//   out          (B, Hq, D)                Q, f32 math cast at the end
//
// Bound: memory. At bf16 a call reads 2 * sum_b min(kv_len_b, cap) * Hkv *
// D * 2 bytes of K/V plus q and writes o (int8 pools: D + 4 bytes a row
// and head, the scale included); the arithmetic (4 flops per K/V element
// per query head of the group) is far below the card's balance point, so
// the design spends its effort on streaming K/V once:
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
//     c+1 is in flight while chunk c is scored. An int8 pool's scales ride
//     the same table: each row's two f32 scales are staged beside it with
//     4-byte cp.async copies.
//   * The loop stops at min(kv_len, capacity): no page past the valid
//     prefix is fetched, and the in-chunk tail is never scored.
//   * A row group of `tpr` lanes owns one K/V row at a time: each lane holds
//     8 elements (one 16-byte bf16 vector, two f32 ones, or one 8-byte
//     int8 one, so an int8 pool takes the registers of a bf16 one) of q
//     per group head in registers, reduces q.k over the row group with
//     shuffles, and keeps its own online-softmax state (m, l, acc) in fp32
//     registers. Under int8 the key's scale multiplies the finished q.k
//     and the value's scale the probability once l has taken it, both
//     exact in algebra, so the int8 values are converted to f32 as they
//     are. The row groups' states are merged once at the end through
//     shared memory. A row with kv_len == 0 writes zeros.
//
// CUDA-core FMAs, no tensor cores: for one query token per head the
// product is a matrix-vector one; it uses neither wgmma nor TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxGroup = 8;
constexpr int kMaxHeadDim = 256;
constexpr int kLaneElems = 8;                   // elements a lane holds
constexpr int kMaxSmem = 232448;                // 227 KB opt-in per block

// Elements of one lane read from a staged row: 16 bytes of f32 or bf16,
// 8 bytes of int8.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec<int8_t> { static constexpr int N = 8; };

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

__device__ __forceinline__ void load_vec(const int8_t* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = static_cast<float>(static_cast<int8_t>(v.x >> (8 * i)));
    out[4 + i] = static_cast<float>(static_cast<int8_t>(v.y >> (8 * i)));
  }
}

// Four consecutive elements of q as floats (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ void load4(const float* p, float* out) {
  load_vec(p, out);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
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
// 4-byte async global->shared copy (one f32 scale); zero-fills likewise.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Elements of a lane's read for a pool element of `kv_bytes` (1 = int8).
int lane_vec(int kv_bytes) { return kv_bytes == 1 ? 8 : 16 / kv_bytes; }

int lanes_per_row(int D, int vec) {
  int n_vec = D / vec, tpr = 1;
  while (tpr < n_vec && tpr < kWarp) tpr <<= 1;
  return tpr;
}

template <typename Q, typename KV, int G>
__global__ void paged_decode_kernel(
    const Q* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ tables,
    const int* __restrict__ kv_len, Q* __restrict__ out, int Hq, int Hkv,
    int D, int n_pages, int page_size, int max_pages, float scale,
    int block_kv, int packed, int group, int tpr) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int VEC = Vec<KV>::N;               // elements of a lane read
  constexpr int NV = kLaneElems / VEC;          // reads per lane: 1 or 2
  constexpr int CVEC = 16 / sizeof(KV);         // elements of a cp.async
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
  const int n_cvec = D / CVEC;
  const int sub = (threadIdx.x % kWarp) % tpr;  // lane within its row group
  const int rg = threadIdx.x / tpr;             // row group of this thread
  const int n_rg = blockDim.x / tpr;

  float qf[G][kLaneElems];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const Q* qrow = q + ((size_t)b * Hq + qh0 + g) * D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = sub + j * tpr;
      if (vi < n_vec) {
#pragma unroll
        for (int e0 = 0; e0 < VEC; e0 += 4)
          load4(qrow + vi * VEC + e0, &qf[g][j * VEC + e0]);
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

  KV* ks = reinterpret_cast<KV*>(smem_raw);     // [2][block_kv][D]
  KV* vs = ks + 2 * (size_t)block_kv * D;
  float* kss = reinterpret_cast<float*>(vs + 2 * (size_t)block_kv * D);
  float* vss = kss + 2 * block_kv;              // [2][block_kv], int8 only
  const size_t head_rows = (size_t)n_pages * page_size;
  const KV* kbase = k_pages + kvh * head_rows * D;
  const KV* vbase = v_pages + kvh * head_rows * D;
  const float* ksbase = kQuant ? k_scales + kvh * head_rows : nullptr;
  const float* vsbase = kQuant ? v_scales + kvh * head_rows : nullptr;
  const int* tbl = tables + (size_t)b * max_pages;
  const int n_chunks = (L + block_kv - 1) / block_kv;

  // The pool row (page * page_size + slot) of token `pos`, or row 0.
  auto pool_row = [&](int pos, bool ok) -> size_t {
    int page = ok ? tbl[pos / page_size] : 0;
    page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
    return (size_t)page * page_size + (ok ? pos % page_size : 0);
  };
  auto issue = [&](int c, int buf) {
    const int t0 = c * block_kv;
    const int total = block_kv * n_cvec;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / n_cvec, vi = i % n_cvec;
      const bool ok = t0 + r < L;
      const size_t goff = pool_row(t0 + r, ok) * D + vi * CVEC;
      const size_t soff = ((size_t)buf * block_kv + r) * D + vi * CVEC;
      cp_async16(ks + soff, kbase + goff, ok);
      cp_async16(vs + soff, vbase + goff, ok);
    }
    if constexpr (kQuant) {
      for (int r = threadIdx.x; r < block_kv; r += blockDim.x) {
        const bool ok = t0 + r < L;
        const size_t row = pool_row(t0 + r, ok);
        cp_async4(kss + buf * block_kv + r, ksbase + row, ok);
        cp_async4(vss + buf * block_kv + r, vsbase + row, ok);
      }
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
    const KV* kc = ks + (size_t)buf * block_kv * D;
    const KV* vc = vs + (size_t)buf * block_kv * D;
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
      // The row's scales (int8): the key's multiplies the finished q.k,
      // the value's the probability after l has taken it.
      float k_sc = 1.f, v_sc = 1.f;
      if constexpr (kQuant) {
        if (valid) {
          k_sc = kss[buf * block_kv + r];
          v_sc = vss[buf * block_kv + r];
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
        s[g] = kQuant ? dot * k_sc : dot;
      }
      if (valid) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float m_new = fmaxf(m[g], s[g]);
          const float alpha = __expf(m[g] - m_new);
          const float p = __expf(s[g] - m_new);
          l[g] = l[g] * alpha + p;
          const float pv = kQuant ? p * v_sc : p;
#pragma unroll
          for (int e = 0; e < kLaneElems; ++e)
            acc[g][e] = fmaf(pv, vf[e], acc[g][e] * alpha);
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scales;
  const float* v_scales;
  const int* tables;
  const int* kv_len;
  void* out;
  int rows, Hq, Hkv, D, n_pages, page_size, max_pages;
  float scale;
  int block_kv, packed, group, threads, tpr, smem;
};

template <typename Q, typename KV, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = paged_decode_kernel<Q, KV, G>;
  static int configured = 48 * 1024;
  if (a.smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (e != cudaSuccess) return e;
    configured = a.smem;
  }
  kern<<<a.rows, a.threads, a.smem, stream>>>(
      static_cast<const Q*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scales, a.v_scales, a.tables,
      a.kv_len, static_cast<Q*>(a.out), a.Hq, a.Hkv, a.D, a.n_pages,
      a.page_size, a.max_pages, a.scale, a.block_kv, a.packed, a.group,
      a.tpr);
  return cudaGetLastError();
}

template <typename Q, typename KV>
cudaError_t dispatch(int G, const Args& a, cudaStream_t s) {
#define PD_CASE(g) \
  case g:          \
    return launch<Q, KV, g>(a, s);
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
// area (with an int8 pool's two f32 scales a row), reused afterwards for
// the row-group merge. kv_bytes is the pool's element size (1 = int8).
int paged_decode_smem_bytes(int D, int kv_bytes, int block_kv, int group,
                            int packed, int num_warps) {
  const int G = packed ? group : 1;
  const int n_rg = num_warps * kWarp / lanes_per_row(D, lane_vec(kv_bytes));
  const int row = D * kv_bytes + (kv_bytes == 1 ? 4 : 0);
  const int staging = 2 * 2 * block_kv * row;
  const int merge = n_rg * G * (D + 2) * 4;
  return staging > merge ? staging : merge;
}

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: q_dtype, or 2 = int8 with
// k_scales and v_scales (null otherwise). Returns a cudaError_t (0 =
// launched).
int paged_decode_launch(const void* q, const void* k_pages,
                        const void* v_pages, const float* k_scales,
                        const float* v_scales, const int* block_tables,
                        const int* kv_len, void* out, int B, int Hq, int Hkv,
                        int D, int n_pages, int page_size, int max_pages,
                        float scale, int block_kv, int pack_gqa,
                        int num_warps, int q_dtype, int kv_dtype,
                        void* stream) {
  const bool quant = kv_dtype == 2;
  const int kv_bytes = quant ? 1 : (kv_dtype == 0 ? 4 : 2);
  const bool scales_ok = quant ? k_scales != nullptr && v_scales != nullptr
                               : k_scales == nullptr && v_scales == nullptr;
  if ((q_dtype != 0 && q_dtype != 1) || (kv_dtype != q_dtype && !quant) ||
      !scales_ok || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > kMaxHeadDim || (D * kv_bytes) % 16 != 0 || block_kv <= 0 ||
      num_warps <= 0 || num_warps > 32 || page_size <= 0 || max_pages <= 0)
    return cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  const int packed = pack_gqa && group > 1 ? 1 : 0;
  const int G = packed ? group : 1;
  if (G > kMaxGroup) return cudaErrorInvalidValue;
  Args a;
  a.smem = paged_decode_smem_bytes(D, kv_bytes, block_kv, group, packed,
                                   num_warps);
  if (a.smem > kMaxSmem) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  a.q = q; a.k = k_pages; a.v = v_pages;
  a.k_scales = k_scales; a.v_scales = v_scales;
  a.tables = block_tables; a.kv_len = kv_len; a.out = out;
  a.rows = B * (packed ? Hkv : Hq);
  a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.n_pages = n_pages; a.page_size = page_size; a.max_pages = max_pages;
  a.scale = scale;
  a.block_kv = block_kv;
  a.packed = packed;
  a.group = group;
  a.threads = num_warps * kWarp;
  a.tpr = lanes_per_row(D, lane_vec(kv_bytes));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return quant ? dispatch<float, int8_t>(G, a, s)
                 : dispatch<float, float>(G, a, s);
  return quant ? dispatch<__nv_bfloat16, int8_t>(G, a, s)
               : dispatch<__nv_bfloat16, __nv_bfloat16>(G, a, s);
}

}  // extern "C"
