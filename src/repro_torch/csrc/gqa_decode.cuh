// Ragged GQA flash-decode over a dense KV cache for Hopper (sm_90a): the
// kernel template shared by gqa_decode.cu (float caches) and
// gqa_decode_kv8.cu (int8 caches with per-token f32 scales). Each source
// instantiates it for its cache type and exports a plain C interface; the
// two build in parallel as separate libraries. The design notes are in the
// sources' headers.
//
//   Q   the type of q and out (float or bf16); q is staged in f32
//   KV  the cache element type: Q itself, or int8_t with f32 scales
//       k_scale, v_scale (B, Hkv, T_len) read through strides (ssb, ssh,
//       sst) in elements; the key's scale multiplies its finished dot
//       product and the value's scale its probability, so the rows are
//       converted to f32 as they are, 16 bytes at a time

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxGroup = 8;
constexpr int kMaxHeadDim = 256;
constexpr int kUnit = 4;                          // elements per lane load
constexpr int kMaxSmem = 232448;                  // 227 KB opt-in per block
constexpr float kNegInf = -1e30f;                 // lse of an empty split

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive elements as floats (16 bytes of f32, 8 bytes of bf16,
// 4 bytes of int8).
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = static_cast<float>(v.x); o[1] = static_cast<float>(v.y);
  o[2] = static_cast<float>(v.z); o[3] = static_cast<float>(v.w);
}
// One 16-byte vector as floats: 4 f32, 8 bf16 or 16 int8.
__device__ __forceinline__ void load16(const float* p, float* o) {
  load4(p, o);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float* o) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    o[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
}
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// The lane's slice of one D-row: NU units (lane, lane + 32) of 4 elements
// each; zeros past D.
template <int NU, typename S>
__device__ __forceinline__ void load_slice(const S* row, int lane,
                                           int n_units, float* o) {
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int u = lane + j * kWarp;
    if (u < n_units) {
      load4(row + u * kUnit, o + j * kUnit);
    } else {
#pragma unroll
      for (int e = 0; e < kUnit; ++e) o[j * kUnit + e] = 0.f;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 16-byte async global->shared copy.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// G: query rows of a block (the packed group, or 1). NU: 4-element units of
// D a lane holds for p.V (1 up to D = 128, else 2).
template <typename Q, typename KV, int G, int NU>
__global__ void gqa_decode_kernel(
    const Q* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ kv_len,
    Q* __restrict__ out, float* __restrict__ part_o,
    float* __restrict__ part_lse, int Hq, int Hkv, int t_len, int D,
    long long sb, long long sh, long long st, long long ssb, long long ssh,
    long long sst, float scale, int block_kv, int span, int packed,
    int group) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int VEC = 16 / sizeof(KV);            // elements per cp.async
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int row = blockIdx.x;
  const int si = blockIdx.y;
  const int S = gridDim.y;
  const int heads_per_b = packed ? Hkv : Hq;
  const int b = row / heads_per_b;
  const int h = row % heads_per_b;
  const int kvh = packed ? h : h / group;
  const int qh0 = packed ? h * group : h;
  int L = kv_len[b];
  L = L < 0 ? 0 : (L > t_len ? t_len : L);
  const int s0 = si * span;                       // this split's first key
  const int n_keys = max(min(s0 + span, L) - s0, 0);
  const int n_chunks = (n_keys + block_kv - 1) / block_kv;

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int n_units = D / kUnit;
  const int n_vec = D / VEC;
  const int ld = D + VEC;                         // staged row, padded 16 B

  float* qs = reinterpret_cast<float*>(smem_raw);            // [G][D]
  KV* ks = reinterpret_cast<KV*>(qs + (size_t)G * D);        // [2][bkv][ld]
  KV* vs = ks + 2 * (size_t)block_kv * ld;                   // [2][bkv][ld]

  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    qs[i] = to_float(q[((size_t)b * Hq + qh0 + i / D) * D + i % D]);

  const KV* kb = k + (size_t)b * sb + (size_t)kvh * sh;
  const KV* vb = v + (size_t)b * sb + (size_t)kvh * sh;
  // Per-token scales of this (b, kv head), int8 caches only.
  const float* ksb = kQuant ? k_scale + (size_t)b * ssb + (size_t)kvh * ssh
                            : nullptr;
  const float* vsb = kQuant ? v_scale + (size_t)b * ssb + (size_t)kvh * ssh
                            : nullptr;

  auto issue = [&](int c, int buf) {
    const int t0 = s0 + c * block_kv;
    const int rows = min(block_kv, n_keys - c * block_kv);
    const int total = rows * n_vec;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / n_vec, vi = i % n_vec;
      const size_t goff = (size_t)(t0 + r) * st + vi * VEC;
      const size_t soff = ((size_t)buf * block_kv + r) * ld + vi * VEC;
      cp_async16(ks + soff, kb + goff);
      cp_async16(vs + soff, vb + goff);
    }
    cp_async_commit();
  };

  float m[G], l[G], acc[G][NU * kUnit];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < NU * kUnit; ++e) acc[g][e] = 0.f;
  }

  __syncthreads();
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
    const int rows = min(block_kv, n_keys - c * block_kv);
    const KV* kc = ks + (size_t)buf * block_kv * ld;
    const KV* vc = vs + (size_t)buf * block_kv * ld;
    for (int j0 = warp * kWarp; j0 < rows; j0 += n_warps * kWarp) {
      // q.k: lane `lane` scores key j0 + lane (clamped into the chunk's
      // rows, so every read is of staged data), 16 bytes of its row at a
      // time; the padded rows keep the 32 lanes' reads on distinct banks
      // and every lane reads the same q elements (a broadcast).
      const bool valid = j0 + lane < rows;
      const int jk = min(j0 + lane, rows - 1);
      const KV* krow = kc + (size_t)jk * ld;
      // The key's scales (int8): a plain load by the lane that owns the
      // key, issued before its dot product so the latency hides behind it.
      float k_sc = 1.f, v_sc = 1.f;
      if constexpr (kQuant) {
        const size_t t = (size_t)(s0 + c * block_kv + jk) * sst;
        k_sc = ksb[t];
        v_sc = vsb[t];
      }
      // kUnit partial sums a row: independent FMA chains a quarter long.
      float part[G][kUnit];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < kUnit; ++e) part[g][e] = 0.f;
#pragma unroll 2
      for (int vi = 0; vi < n_vec; ++vi) {
        float kf[VEC];
        load16(krow + vi * VEC, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int e0 = 0; e0 < VEC; e0 += kUnit) {
            float qf[kUnit];
            load4(qs + (size_t)g * D + vi * VEC + e0, qf);
#pragma unroll
            for (int e = 0; e < kUnit; ++e)
              part[g][e] = fmaf(qf[e], kf[e0 + e], part[g][e]);
          }
        }
      }
      const float s_scale = kQuant ? k_sc * scale : scale;
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        dot[g] = (part[g][0] + part[g][1]) + (part[g][2] + part[g][3]);
      float p[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float s = valid ? dot[g] * s_scale : -INFINITY;
        const float m_new = fmaxf(m[g], warp_max(s));
        const float alpha = expf(m[g] - m_new);
        p[g] = valid ? expf(s - m_new) : 0.f;
        l[g] = l[g] * alpha + warp_sum(p[g]);
#pragma unroll
        for (int e = 0; e < NU * kUnit; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
        if constexpr (kQuant) p[g] *= v_sc;       // weights the int8 row
      }
      const int nb = min(kWarp, rows - j0);
      for (int jj = 0; jj < nb; ++jj) {
        float vf[NU * kUnit];
        load_slice<NU>(vc + (size_t)(j0 + jj) * ld, lane, n_units, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(0xffffffffu, p[g], jj);
#pragma unroll
          for (int e = 0; e < NU * kUnit; ++e)
            acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();
  }

  // Merge the warps' states through the staging area (a warp that saw no
  // key has m = -inf and weighs nothing).
  float* accs = qs + (size_t)G * D;               // [n_warps][G][D]
  float* ms = accs + (size_t)n_warps * G * D;     // [n_warps][G]
  float* ls = ms + n_warps * G;                   // [n_warps][G]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int st_i = warp * G + g;
    if (lane == 0) {
      ms[st_i] = m[g];
      ls[st_i] = l[g];
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const int uu = lane + j * kWarp;
      if (uu < n_units)
        store4(accs + (size_t)st_i * D + uu * kUnit, acc[g] + j * kUnit);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
    for (int w = 0; w < n_warps; ++w) M = fmaxf(M, ms[w * G + g]);
    float num = 0.f, den = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < n_warps; ++w) {
        const float mw = ms[w * G + g];
        const float wt = mw == -INFINITY ? 0.f : expf(mw - M);
        num += wt * accs[((size_t)w * G + g) * D + d];
        den += wt * ls[w * G + g];
      }
    }
    const float o = den > 0.f ? num / den : 0.f;
    if (S == 1) {
      store_elem(out + ((size_t)row * G + g) * D + d, o);
    } else {
      const size_t part = ((size_t)row * S + si) * G + g;
      part_o[part * D + d] = o;
      if (d == 0) part_lse[part] = den > 0.f ? M + logf(den) : kNegInf;
    }
  }
}

// The TPU wrapper's logsumexp combine of the S partials of each row.
template <typename Q>
__global__ void gqa_combine_kernel(const float* __restrict__ part_o,
                                   const float* __restrict__ part_lse,
                                   Q* __restrict__ out, int S, int G, int D) {
  const int row = blockIdx.x;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
    for (int s = 0; s < S; ++s)
      M = fmaxf(M, part_lse[((size_t)row * S + s) * G + g]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t part = ((size_t)row * S + s) * G + g;
      const float w = expf(part_lse[part] - M);
      num += w * part_o[part * D + d];
      den += w;
    }
    store_elem(out + ((size_t)row * G + g) * D + d, num / fmaxf(den, 1e-30f));
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* kv_len;
  void* out;
  float* part_o;
  float* part_lse;
  int rows, S, Hq, Hkv, t_len, D;
  long long sb, sh, st, ssb, ssh, sst;
  float scale;
  int block_kv, span, packed, group, threads, smem;
};

template <typename Q, typename KV, int G, int NU>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = gqa_decode_kernel<Q, KV, G, NU>;
  static int configured = 48 * 1024;
  if (a.smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (e != cudaSuccess) return e;
    configured = a.smem;
  }
  kern<<<dim3(a.rows, a.S), a.threads, a.smem, stream>>>(
      static_cast<const Q*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scale, a.v_scale, a.kv_len,
      static_cast<Q*>(a.out), a.part_o, a.part_lse, a.Hq, a.Hkv, a.t_len,
      a.D, a.sb, a.sh, a.st, a.ssb, a.ssh, a.sst, a.scale, a.block_kv,
      a.span, a.packed, a.group);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.S == 1) return e;
  gqa_combine_kernel<Q><<<a.rows, 128, 0, stream>>>(
      a.part_o, a.part_lse, static_cast<Q*>(a.out), a.S, G, a.D);
  return cudaGetLastError();
}

template <typename Q, typename KV, int NU>
cudaError_t dispatch_group(int G, const Args& a, cudaStream_t s) {
#define GQ_CASE(g) \
  case g:          \
    return launch<Q, KV, g, NU>(a, s);
  switch (G) {
    GQ_CASE(1) GQ_CASE(2) GQ_CASE(3) GQ_CASE(4)
    GQ_CASE(5) GQ_CASE(6) GQ_CASE(7) GQ_CASE(8)
  }
#undef GQ_CASE
  return cudaErrorInvalidValue;
}

// Dynamic shared memory one launch needs: the block's query rows in f32,
// then the double-buffered K/V staging area (rows padded by 16 bytes),
// reused afterwards for the warps' f32 (acc, m, l).
inline int smem_bytes(int D, int kv_bytes, int block_kv, int rows,
                      int num_warps) {
  const int staging = 2 * 2 * block_kv * (D * kv_bytes + 16);
  const int merge = num_warps * rows * (D + 2) * 4;
  return rows * D * 4 + (staging > merge ? staging : merge);
}

// Checks the launch, fills its arguments and launches the instantiation
// for q's type Q and the cache type KV. Strides are the cache's (k's and
// v's, the same) and the scales' (int8 only), in elements.
template <typename Q, typename KV>
cudaError_t run(const void* q, const void* k, const void* v,
                const float* k_scale, const float* v_scale,
                const int* kv_len, void* out, void* part_o, void* part_lse,
                int B, int Hq, int Hkv, int t_len, int D, long long sb,
                long long sh, long long st, long long ssb, long long ssh,
                long long sst, float scale, int block_kv, int k_splits,
                int pack_gqa, int num_warps, cudaStream_t s) {
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > kMaxHeadDim ||
      (D * (int)sizeof(KV)) % 16 != 0 || block_kv <= 0 ||
      k_splits <= 0 || num_warps <= 0 || num_warps > 32 || t_len <= 0)
    return cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  const int packed = pack_gqa && group > 1 ? 1 : 0;
  const int G = packed ? group : 1;
  if (G > kMaxGroup) return cudaErrorInvalidValue;
  Args a;
  a.smem = smem_bytes(D, sizeof(KV), block_kv, G, num_warps);
  if (a.smem > kMaxSmem) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int per_split = block_kv * k_splits;
  a.q = q; a.k = k; a.v = v; a.k_scale = k_scale; a.v_scale = v_scale;
  a.kv_len = kv_len; a.out = out;
  a.part_o = static_cast<float*>(part_o);
  a.part_lse = static_cast<float*>(part_lse);
  a.rows = B * (packed ? Hkv : Hq);
  a.S = k_splits;
  a.Hq = Hq; a.Hkv = Hkv; a.t_len = t_len; a.D = D;
  a.sb = sb; a.sh = sh; a.st = st;
  a.ssb = ssb; a.ssh = ssh; a.sst = sst;
  a.scale = scale;
  a.block_kv = block_kv;
  a.span = (t_len + per_split - 1) / per_split * block_kv;
  a.packed = packed;
  a.group = group;
  a.threads = num_warps * kWarp;
  if (D <= kWarp * kUnit) return dispatch_group<Q, KV, 1>(G, a, s);
  return dispatch_group<Q, KV, 2>(G, a, s);
}

}  // namespace
