// Paged-KV speculative-verify attention for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the TPU kernel `paged_verify` / `_verify_kernel` of
// src/repro/kernels/paged_verify.py: K consecutive query positions per
// sequence (the last committed token plus K-1 drafts) attend their KV
// through a block table into the page pool that paged_decode serves, each
// with its own causal tail. Float pools, or int8 pools with per-token f32
// scales (the kv8 policy, the TPU kernel's int8 branch).
//
//   q            (B, K, Hq, D)             Q = float or bf16
//   k/v pages    (Hkv, P, page_size, D)    KV = Q, or int8
//   k/v scales   (Hkv, P, page_size)       f32, int8 pools only
//   block_tables (B, max_pages)            int32, page 0 is the scratch page
//   kv_len       (B,)                      int32, counts the K drafts,
//                                          clamped to the capacity
//   out          (B, K, Hq, D)             Q, f32 math cast at the end
//
// Query t of sequence b sits at position L_b - K + t (L_b = min(kv_len_b,
// cap)) and attends k_pos <= L_b - K + t.
//
// Bound: memory. A call reads 2 * sum_b L_b * Hkv * D * itemsize bytes of
// K/V (int8 pools: D + 4 bytes a row and head, the scale included) plus q
// and writes o -- the bytes of one paged_decode call -- and does
// K times paged_decode's arithmetic, still far below the card's balance
// point at K <= 8. So the design streams each K/V row from HBM once for
// all K query positions of all the heads that share it:
//
//   * One block per (b, kv_head) when pack_gqa is set, scoring all K * g
//     query rows (row r = t * g + gi: draft position t, group head gi)
//     against each staged K/V row. Without pack_gqa one block per
//     (b, q_head) scoring K rows -- more blocks, each K/V row read `group`
//     times (the L2 may absorb part of it).
//   * As in paged_decode, the TPU grid's sequential page axes become a
//     loop over chunks of `block_kv` rows, copied into shared memory with
//     16-byte cp.async copies that chase the block table, double-buffered.
//     The loop stops at L_b. An int8 pool's scales ride the same table:
//     each row's two f32 scales are staged beside it with 4-byte cp.async
//     copies (zero-filled past L_b, as the rows are).
//   * Where the query rows live. paged_decode holds its query in
//     registers per row group; at K * g = 12 to 64 rows that would spill.
//     Here the rows' q and running (m, l, acc) wait in shared memory, and
//     warps own query rows. With at least two warps a row (n_warps >= 2R)
//     the S = n_warps / R warps of a row split its keys, each keeping its
//     own (m, l, acc), merged once at the end: a verify has few rows per
//     block (K at pack_gqa off), and one warp a row leaves the SMs with a
//     few warps each to hide latency with. Otherwise warp w scores rows
//     w, w + n_warps, .... A warp works 32 keys at a time: for q.k each
//     lane takes one
//     key and runs the whole D-long dot product from shared memory, so no
//     reduction crosses lanes (each lane starts at another column, which
//     keeps the 32 rows' reads off each other's banks). One online-softmax
//     update per 32 keys follows (two warp reductions), then p.V with the
//     lanes splitting D: a lane holds 4 or 8 elements of the f32
//     accumulator and takes each key's probability by a broadcast
//     shuffle. The registers a thread needs do not grow with K * g.
//   * The scale multiplies the finished dot product and the probabilities
//     use the accurate expf, as the plain version computes them: the
//     closer the f32 result, the fewer bf16 outputs round the other way,
//     and a deep model amplifies each one that does. It costs one exp a
//     key and lane.
//   * Int8 pools. The key's scale multiplies the finished q.k (before the
//     softmax scale) and the value's the key's probability before p.V (l
//     takes the unscaled one): both exact in algebra, so the int8 values
//     are converted to f32 as they are, four a 4-byte read. A row is D
//     bytes, D / 16 copies; its scales are staged as said above.
//   * Masking. Row r's keys are the prefix k_pos <= L - K + r / g, so a
//     warp scores only that prefix of each chunk and skips chunks past it.
//     A masked key adds nothing (its probability is zero, not exp of a
//     large negative), so a row whose window is empty (kv_len == 0,
//     kv_len < K tails) ends with l == 0 and writes exact zeros.
//
// CUDA-core FMAs, no tensor cores, no split over KV: speed is later work
// (mma.sync over the K * g rows, split-KV for short batches).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxHeadDim = 256;
constexpr int kUnit = 4;                          // elements per lane load
constexpr int kMaxSmem = 232448;                  // 227 KB opt-in per block

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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
  const unsigned v = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = static_cast<float>(static_cast<int8_t>(v >> (8 * i)));
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

// Q: q's type; KV: the pool's (Q, or int8 with scales). NU: 4-element
// units of D a lane holds for p.V (1 up to D = 128, else 2).
template <typename Q, typename KV, int NU>
__global__ void paged_verify_kernel(
    const Q* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ tables,
    const int* __restrict__ kv_len, Q* __restrict__ out, int K, int Hq,
    int Hkv, int D, int n_pages, int page_size, int max_pages, float scale,
    int block_kv, int packed, int group) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int VEC = 16 / sizeof(KV);            // elements per cp.async
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int g = packed ? group : 1;               // query heads per block
  const int R = K * g;                            // query rows of the block
  const int heads_per_b = packed ? Hkv : Hq;
  const int b = blockIdx.x / heads_per_b;
  const int h = blockIdx.x % heads_per_b;
  const int kvh = packed ? h : h / group;
  const int qh0 = packed ? h * group : h;
  const int cap = max_pages * page_size;
  int L = kv_len[b];
  L = L < 0 ? 0 : (L > cap ? cap : L);

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  // S warps split each row's keys; running state st = s * R + r.
  const int S = n_warps >= 2 * R ? n_warps / R : 1;
  const int n_states = R * S;
  const int n_units = D / kUnit;
  const int n_vec = D / VEC;
  const int u0 = lane % n_units;                  // q.k's first column unit

  KV* ks = reinterpret_cast<KV*>(smem_raw);       // [2][block_kv][D]
  KV* vs = ks + 2 * (size_t)block_kv * D;         // [2][block_kv][D]
  float* kss = reinterpret_cast<float*>(vs + 2 * (size_t)block_kv * D);
  float* vss = kss + 2 * block_kv;                // [2][block_kv], int8 only
  Q* qs = reinterpret_cast<Q*>(kQuant ? vss + 2 * block_kv : kss);  // [R][D]
  float* accs = reinterpret_cast<float*>(qs + (size_t)R * D);
  float* ms = accs + (size_t)n_states * D;        // accs [n_states][D]
  float* ls = ms + n_states;                      // ms, ls [n_states]

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int t = r / g, gi = r % g;
    qs[i] = q[(((size_t)b * K + t) * Hq + qh0 + gi) * D + d];
  }
  for (int i = threadIdx.x; i < n_states * D; i += blockDim.x) accs[i] = 0.f;
  for (int st = threadIdx.x; st < n_states; st += blockDim.x) {
    ms[st] = -INFINITY;
    ls[st] = 0.f;
  }

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
    const int total = block_kv * n_vec;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / n_vec, vi = i % n_vec;
      const bool ok = t0 + r < L;
      const size_t goff = pool_row(t0 + r, ok) * D + vi * VEC;
      const size_t soff = ((size_t)buf * block_kv + r) * D + vi * VEC;
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
    const int k0 = c * block_kv;
    const int rows = min(block_kv, L - k0);
    const KV* kc = ks + (size_t)buf * block_kv * D;
    const KV* vc = vs + (size_t)buf * block_kv * D;
    for (int st = warp; st < n_states; st += n_warps) {
      const int r = st % R, split = st / R;
      // Keys of this chunk inside row r's causal window (warp-uniform).
      const int n = min(rows, L - K + r / g - k0 + 1);
      if (n <= split * kWarp) continue;
      const Q* qrow = qs + (size_t)r * D;
      float acc[NU * kUnit];
      load_slice<NU>(accs + (size_t)st * D, lane, n_units, acc);
      float m = ms[st], l = ls[st];
      for (int j0 = split * kWarp; j0 < n; j0 += S * kWarp) {
        // q.k: lane `lane` scores key j0 + lane (clamped into the chunk's
        // valid rows, so every read is of finite data), starting at
        // column unit u0 and wrapping.
        const bool valid = j0 + lane < n;
        const int j = min(j0 + lane, n - 1);
        const KV* krow = kc + (size_t)j * D;
        float dot = 0.f;
        int u = u0;
        for (int iu = 0; iu < n_units; ++iu) {
          float qf[kUnit], kf[kUnit];
          load4(qrow + u * kUnit, qf);
          load4(krow + u * kUnit, kf);
#pragma unroll
          for (int e = 0; e < kUnit; ++e) dot = fmaf(qf[e], kf[e], dot);
          if (++u == n_units) u = 0;
        }
        float v_sc = 1.f;
        if constexpr (kQuant) {
          dot *= kss[buf * block_kv + j];
          v_sc = vss[buf * block_kv + j];
        }
        const float s = valid ? dot * scale : -INFINITY;
        const float m_new = fmaxf(m, warp_max(s));
        const float alpha = expf(m - m_new);
        const float p = valid ? expf(s - m_new) : 0.f;
        l = l * alpha + warp_sum(p);
        const float pv = kQuant ? p * v_sc : p;   // the value's scale
#pragma unroll
        for (int e = 0; e < NU * kUnit; ++e) acc[e] *= alpha;
        const int nb = min(kWarp, n - j0);
        for (int jj = 0; jj < nb; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, pv, jj);
          float vf[NU * kUnit];
          load_slice<NU>(vc + (size_t)(j0 + jj) * D, lane, n_units, vf);
#pragma unroll
          for (int e = 0; e < NU * kUnit; ++e)
            acc[e] = fmaf(pj, vf[e], acc[e]);
        }
        m = m_new;
      }
#pragma unroll
      for (int jn = 0; jn < NU; ++jn) {
        const int uu = lane + jn * kWarp;
        if (uu < n_units)
          store4(accs + (size_t)st * D + uu * kUnit, acc + jn * kUnit);
      }
      if (lane == 0) {
        ms[st] = m;
        ls[st] = l;
      }
    }
    __syncthreads();
  }

  // Merge each row's S states (a state that saw no key has m = -inf and
  // weighs nothing).
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int t = r / g, gi = r % g;
    float M = -INFINITY;
    for (int sp = 0; sp < S; ++sp) M = fmaxf(M, ms[sp * R + r]);
    float num = 0.f, den = 0.f;
    if (M != -INFINITY) {
      for (int sp = 0; sp < S; ++sp) {
        const int st = sp * R + r;
        const float w = ms[st] == -INFINITY ? 0.f : expf(ms[st] - M);
        num += w * accs[(size_t)st * D + d];
        den += w * ls[st];
      }
    }
    store_elem(out + (((size_t)b * K + t) * Hq + qh0 + gi) * D + d,
               den > 0.f ? num / den : 0.f);
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
  int blocks, K, Hq, Hkv, D, n_pages, page_size, max_pages;
  float scale;
  int block_kv, packed, group, threads, smem;
};

template <typename Q, typename KV, int NU>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = paged_verify_kernel<Q, KV, NU>;
  static int configured = 48 * 1024;
  if (a.smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (e != cudaSuccess) return e;
    configured = a.smem;
  }
  kern<<<a.blocks, a.threads, a.smem, stream>>>(
      static_cast<const Q*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scales, a.v_scales, a.tables,
      a.kv_len, static_cast<Q*>(a.out), a.K, a.Hq, a.Hkv, a.D, a.n_pages,
      a.page_size, a.max_pages, a.scale, a.block_kv, a.packed, a.group);
  return cudaGetLastError();
}

template <typename Q, typename KV>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.D <= kWarp * kUnit) return launch<Q, KV, 1>(a, s);
  return launch<Q, KV, 2>(a, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs: the double-buffered K/V staging
// area in the pool's type (with an int8 pool's two f32 scales a row), the
// query rows in q's type, then the running (acc, m, l) in f32 of each
// row's key splits. q_bytes is q's element size, kv_bytes the pool's
// (1 = int8).
int paged_verify_smem_bytes(int D, int q_bytes, int kv_bytes, int block_kv,
                            int draft_k, int group, int packed,
                            int num_warps) {
  const int rows = draft_k * (packed && group > 1 ? group : 1);
  const int splits = num_warps >= 2 * rows ? num_warps / rows : 1;
  const int row = D * kv_bytes + (kv_bytes == 1 ? 4 : 0);
  return 2 * 2 * block_kv * row + rows * D * q_bytes +
         rows * splits * (D + 2) * 4;
}

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: q_dtype, or 2 = int8 with
// k_scales and v_scales (null otherwise). Returns a cudaError_t (0 =
// launched).
int paged_verify_launch(const void* q, const void* k_pages,
                        const void* v_pages, const float* k_scales,
                        const float* v_scales, const int* block_tables,
                        const int* kv_len, void* out, int B, int K, int Hq,
                        int Hkv, int D, int n_pages, int page_size,
                        int max_pages, float scale, int block_kv,
                        int pack_gqa, int num_warps, int q_dtype,
                        int kv_dtype, void* stream) {
  const bool quant = kv_dtype == 2;
  const int q_bytes = q_dtype == 0 ? 4 : 2;
  const int kv_bytes = quant ? 1 : q_bytes;
  const bool scales_ok = quant ? k_scales != nullptr && v_scales != nullptr
                               : k_scales == nullptr && v_scales == nullptr;
  if ((q_dtype != 0 && q_dtype != 1) || (kv_dtype != q_dtype && !quant) ||
      !scales_ok || K <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > kMaxHeadDim || (D * kv_bytes) % 16 != 0 ||
      (D * q_bytes) % 16 != 0 || block_kv <= 0 || num_warps <= 0 ||
      num_warps > 32 || page_size <= 0 || max_pages <= 0)
    return cudaErrorInvalidValue;
  Args a;
  a.group = Hq / Hkv;
  a.packed = pack_gqa && a.group > 1 ? 1 : 0;
  a.smem = paged_verify_smem_bytes(D, q_bytes, kv_bytes, block_kv, K,
                                   a.group, a.packed, num_warps);
  if (a.smem > kMaxSmem) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  a.q = q; a.k = k_pages; a.v = v_pages;
  a.k_scales = k_scales; a.v_scales = v_scales;
  a.tables = block_tables; a.kv_len = kv_len; a.out = out;
  a.blocks = B * (a.packed ? Hkv : Hq);
  a.K = K; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.n_pages = n_pages; a.page_size = page_size; a.max_pages = max_pages;
  a.scale = scale;
  a.block_kv = block_kv;
  a.threads = num_warps * kWarp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return quant ? dispatch<float, int8_t>(a, s)
                 : dispatch<float, float>(a, s);
  return quant ? dispatch<__nv_bfloat16, int8_t>(a, s)
               : dispatch<__nv_bfloat16, __nv_bfloat16>(a, s);
}

}  // extern "C"
