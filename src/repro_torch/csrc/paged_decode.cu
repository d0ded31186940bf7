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
// per query head of the group) is far below the card's balance point. A
// continuous batch gives few (sequence, head) rows (8 x 8 packed at the
// serving batch, on 132 SMs) and ragged lengths, so the design spreads
// each row's sequence over several SMs and keeps every SM's copies in
// flight:
//
//   * Split-KV over a thread-block cluster. The grid is rows x kv_splits
//     blocks, one cluster of kv_splits blocks a row (no cluster when it is
//     1). Rank s of a cluster takes an equal share of the row's chunks of
//     `block_kv` tokens of min(kv_len, capacity), cut on chunk boundaries
//     on the device from kv_len, and runs the online softmax over its span
//     in f32.
//   * The partials merge in distributed shared memory. Each block leaves
//     its (m, l, acc) for the group's heads in its own shared memory; after
//     a cluster barrier rank 0 reads the other ranks' partials (mapa +
//     ld.shared::cluster) and merges them in rank order, so every bit of
//     the result is the same whatever the timing; a second cluster barrier
//     keeps every block alive until rank 0 has read it. No workspace in
//     global memory, no counter and no second launch. Every thread of
//     every block reaches both barriers (a block with an empty span too:
//     its partial is (-inf, 0, 0) and weighs 0).
//   * A ring of two chunks in shared memory, each stage completing on its
//     own mbarrier, so the copy of the next chunk overlaps the scoring of
//     this one (deeper rings were measured and never won). A page of one KV head is page_size x D
//     contiguous elements, so a chunk is one 1-D bulk copy
//     (cp.async.bulk ... mbarrier::complete_tx) per page run for K, for V
//     and, for an int8 pool, for each scale run; the lanes of warp 0 issue
//     them, each reading its own entry of the block table (the TPU
//     kernel's scalar prefetch). Where a bulk copy cannot go (an int8
//     pool whose scale runs are not 16-byte multiples or aligned: a page
//     size or block_kv not a multiple of 4 rows), every thread copies rows
//     with 16-byte cp.async (4-byte for the scales) and the stage's
//     mbarrier tracks them (cp.async.mbarrier.arrive.noinc). The wrapper
//     chooses the path from the layout and reports it.
//   * One block per (b, kv_head) when pack_gqa is set: the block scores all
//     `group` query heads against each K/V row, so each row crosses HBM
//     once. Without pack_gqa one block per (b, q_head).
//   * A row group of `tpr` lanes owns R K/V rows at a time (4 for a group
//     of one or two heads, 2 up to four, else 1): each lane holds 8
//     elements (one 16-byte bf16 vector, two f32 ones, or one 8-byte int8
//     one) of q per group head in registers, reduces the R rows' q.k over
//     the row group with interleaved shuffle trees, and keeps its own
//     online-softmax state (m, l, acc) in fp32 registers (IEEE FMAs),
//     rescaled once for the R rows. The R rows' chains are independent,
//     which is what hides the shuffles' and the exps' latency. Under int8
//     the key's scale multiplies the finished q.k and the value's scale
//     the probability once l has taken it, both exact in algebra. The row
//     groups' states merge through shared memory into the block's
//     partial. A row with kv_len == 0 writes zeros.
//
// CUDA-core FMAs, no tensor cores: for one query token per head the
// product is a matrix-vector one. An int8 value becomes an f32 by integer
// byte moves and one add, not the quarter-rate I2F. At the deployment
// shape int8 and bf16 pools take about the same time, so the score loop's
// instructions, not HBM, bound the kernel there (PERF.md): mma.sync for
// the packed group's heads is the next lever.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxGroup = 8;
constexpr int kMaxWarps = 8;                    // 256 threads: the launch bounds
constexpr int kMaxHeadDim = 256;
constexpr int kLaneElems = 8;                   // elements a lane holds
constexpr int kMaxSmem = 232448;                // 227 KB opt-in per block
constexpr int kMaxSplits = 8;                   // the portable cluster size
constexpr int kStages = 2;                      // the ring's depth
constexpr int kBarBytes = 64;                   // the ring's mbarriers

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

// int8 -> f32 without the quarter-rate I2F: x + 128 (the sign bit
// flipped) placed in the low byte of 2^23's mantissa, then 2^23 + 128
// taken off, exact for every int8 value.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650 + i)) -
             8388736.f;
}

__device__ __forceinline__ void load_vec(const int8_t* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  int8x4_to_float(v.x, out);
  int8x4_to_float(v.y, out + 4);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (the parity wait traps after 2^26 polls, as in hopper.cuh: a
// fault in the protocol fails the launch instead of hanging the card) --

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, and `bytes` more to come from bulk copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

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

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16-byte and 4-byte async global->shared copies of one thread, and the
// arrival on `bar` once they have all landed (the barrier counts one
// arrival a thread: noinc).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

// Thread-block clusters --------------------------------------------------

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The f32 at `p` in the shared memory of cluster rank `rank`.
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// Elements of a lane's read for a pool element of `kv_bytes` (1 = int8).
int lane_vec(int kv_bytes) { return kv_bytes == 1 ? 8 : 16 / kv_bytes; }

int lanes_per_row(int D, int vec) {
  int n_vec = D / vec, tpr = 1;
  while (tpr < n_vec && tpr < kWarp) tpr <<= 1;
  return tpr;
}

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// The block's partial (m, l per head, then acc per head and dim), f32.
__host__ __device__ inline int partial_bytes(int G, int D) {
  return round_up(G * (D + 2) * 4, 16);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scales;
  const float* v_scales;
  const int* tables;
  const int* kv_len;
  void* out;
  int Hq, Hkv, D, n_pages, page_size, max_pages;
  float scale;
  int block_kv, packed, group, tpr, splits, bulk;
};

// Two blocks of 8 warps an SM where the registers allow it (128 a
// thread): the float pools' and the large groups' states do not fit.
template <typename KV, int G>
constexpr int kMinBlocks =
    !std::is_same<KV, float>::value && G <= 4 ? 2 : 1;

template <typename Q, typename KV, int G>
__global__ void __launch_bounds__(kMaxWarps * kWarp, (kMinBlocks<KV, G>))
paged_decode_kernel(const Params p) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int VEC = Vec<KV>::N;               // elements of a lane read
  constexpr int NV = kLaneElems / VEC;          // reads per lane: 1 or 2
  constexpr int CVEC = 16 / sizeof(KV);         // elements of a cp.async
  constexpr int R = G <= 2 ? 4 : (G <= 4 ? 2 : 1);  // rows in flight
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int D = p.D, ps = p.page_size, block_kv = p.block_kv;
  const int S = p.splits;
  constexpr int NS = kStages;
  const int rank = blockIdx.x % S;              // cluster rank (1-D)
  const int row = blockIdx.x / S;
  const int heads_per_row = p.packed ? p.Hkv : p.Hq;
  const int b = row / heads_per_row;
  const int h = row % heads_per_row;
  const int kvh = p.packed ? h : h / p.group;
  const int qh0 = p.packed ? h * p.group : h;
  const int cap = p.max_pages * ps;
  int L = p.kv_len[b];
  L = L < 0 ? 0 : (L > cap ? cap : L);

  // This rank's chunks: an equal share of the row's, cut on chunks.
  const int n_chunks = (L + block_kv - 1) / block_kv;
  const int per_rank = (n_chunks + S - 1) / S;
  const int c0 = min(rank * per_rank, n_chunks);
  const int n = min(c0 + per_rank, n_chunks) - c0;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // [NS]
  float* pm = reinterpret_cast<float*>(smem_raw + kBarBytes);  // [G]
  float* pl = pm + G;                                          // [G]
  float* pa = pl + G;                                          // [G][D]
  unsigned char* ring = smem_raw + kBarBytes + partial_bytes(G, D);
  KV* ks = reinterpret_cast<KV*>(ring);         // [NS][block_kv][D]
  KV* vs = ks + (size_t)NS * block_kv * D;
  float* kss = reinterpret_cast<float*>(vs + (size_t)NS * block_kv * D);
  float* vss = kss + NS * block_kv;             // [NS][block_kv], int8 only

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(&full[i], p.bulk ? 1 : blockDim.x);
    mbar_fence_init();
  }

  const int n_vec = D / VEC;
  const int n_cvec = D / CVEC;
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % p.tpr;                 // lane within its row group
  const int rg = threadIdx.x / p.tpr;           // row group of this thread
  const int n_rg = blockDim.x / p.tpr;
  const int tpr = p.tpr;

  float qf[G][kLaneElems];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const Q* qrow = static_cast<const Q*>(p.q) + ((size_t)b * p.Hq + qh0 + g) * D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = sub + j * tpr;
      if (vi < n_vec) {
#pragma unroll
        for (int e0 = 0; e0 < VEC; e0 += 4)
          load4(qrow + vi * VEC + e0, &qf[g][j * VEC + e0]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[g][j * VEC + e] *= p.scale;
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

  const size_t head_rows = (size_t)p.n_pages * ps;
  const KV* kbase = static_cast<const KV*>(p.k) + kvh * head_rows * D;
  const KV* vbase = static_cast<const KV*>(p.v) + kvh * head_rows * D;
  const float* ksbase = kQuant ? p.k_scales + kvh * head_rows : nullptr;
  const float* vsbase = kQuant ? p.v_scales + kvh * head_rows : nullptr;
  const int* tbl = p.tables + (size_t)b * p.max_pages;

  auto page_of = [&](int i) -> size_t {         // table entry i, clamped
    int page = tbl[i];
    page = page < 0 ? 0 : (page >= p.n_pages ? p.n_pages - 1 : page);
    return (size_t)page;
  };
  // Chunk c into stage st: bulk copies, one per page run, issued by the
  // lanes of warp 0; or every thread's cp.async rows.
  auto issue = [&](int c, int st) {
    const int t0 = c * block_kv;
    const int rows = min(block_kv, L - t0);
    if (p.bulk) {
      if (threadIdx.x >= kWarp) return;
      if (lane == 0) {
        int bytes = 2 * rows * D * (int)sizeof(KV);
        if (kQuant) bytes += 2 * round_up(rows, 4) * 4;
        mbar_expect_tx(&full[st], bytes);
      }
      __syncwarp();
      const int first = t0 / ps, last = (t0 + rows - 1) / ps;
      for (int pi = first + lane; pi <= last; pi += kWarp) {
        const int r0 = max(t0, pi * ps);
        const int r1 = min(t0 + rows, (pi + 1) * ps);
        const size_t g = page_of(pi) * ps + (r0 - pi * ps);  // pool row
        const size_t srow = (size_t)st * block_kv + (r0 - t0);
        const int bytes = (r1 - r0) * D * (int)sizeof(KV);
        bulk_copy(ks + srow * D, kbase + g * D, bytes, &full[st]);
        bulk_copy(vs + srow * D, vbase + g * D, bytes, &full[st]);
        if constexpr (kQuant) {
          // page runs start on 4 rows; the last rounds up inside its page
          const int sb = round_up(r1 - r0, 4) * 4;
          bulk_copy(kss + srow, ksbase + g, sb, &full[st]);
          bulk_copy(vss + srow, vsbase + g, sb, &full[st]);
        }
      }
    } else {
      for (int i = threadIdx.x; i < rows * n_cvec; i += blockDim.x) {
        const int r = i / n_cvec, vi = i % n_cvec;
        const int pos = t0 + r;
        const size_t g = page_of(pos / ps) * ps + pos % ps;
        const size_t soff = ((size_t)st * block_kv + r) * D + vi * CVEC;
        cp_async16(ks + soff, kbase + g * D + vi * CVEC);
        cp_async16(vs + soff, vbase + g * D + vi * CVEC);
      }
      if constexpr (kQuant) {
        for (int r = threadIdx.x; r < rows; r += blockDim.x) {
          const int pos = t0 + r;
          const size_t g = page_of(pos / ps) * ps + pos % ps;
          cp_async4(kss + st * block_kv + r, ksbase + g);
          cp_async4(vss + st * block_kv + r, vsbase + g);
        }
      }
      cp_async_arrive(&full[st]);
    }
  };

  __syncthreads();                              // the barriers are set
  for (int i = 0; i < min(n, NS); ++i) issue(c0 + i, i);
  for (int i = 0; i < n; ++i) {
    const int st = i % NS;
    mbar_wait(&full[st], (i / NS) & 1);
    const int rows = min(block_kv, L - (c0 + i) * block_kv);
    const KV* kc = ks + (size_t)st * block_kv * D;
    const KV* vc = vs + (size_t)st * block_kv * D;
    const int iters = (rows + n_rg * R - 1) / (n_rg * R);  // uniform
    for (int it = 0; it < iters; ++it) {
      // R rows a row group, n_rg apart: their dot products, shuffle trees
      // and exps are independent, and the running state is rescaled once.
      int r[R];
      bool valid[R];
      float kf[R][kLaneElems], vf[R][kLaneElems];
      float k_sc[R], v_sc[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        r[rr] = (it * R + rr) * n_rg + rg;
        valid[rr] = r[rr] < rows;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int vi = sub + j * tpr;
          if (valid[rr] && vi < n_vec) {
            load_vec(kc + (size_t)r[rr] * D + vi * VEC, &kf[rr][j * VEC]);
            load_vec(vc + (size_t)r[rr] * D + vi * VEC, &vf[rr][j * VEC]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              kf[rr][j * VEC + e] = 0.f;
              vf[rr][j * VEC + e] = 0.f;
            }
          }
        }
        // The row's scales (int8): the key's multiplies the finished q.k,
        // the value's the probability after l has taken it.
        k_sc[rr] = 1.f;
        v_sc[rr] = 1.f;
        if constexpr (kQuant) {
          if (valid[rr]) {
            k_sc[rr] = kss[st * block_kv + r[rr]];
            v_sc[rr] = vss[st * block_kv + r[rr]];
          }
        }
      }
      // the shuffles span the warp: skip only what no lane of it scores
      if (!__any_sync(0xffffffffu, valid[0])) continue;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < kLaneElems; ++e)
            dot = fmaf(qf[g][e], kf[rr][e], dot);
          s[rr] = dot;
        }
        for (int off = tpr >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
            s[rr] += __shfl_xor_sync(0xffffffffu, s[rr], off, tpr);
        }
        float m_new = m[g];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          if (kQuant) s[rr] *= k_sc[rr];
          if (valid[rr]) m_new = fmaxf(m_new, s[rr]);
        }
        // a row group with no valid row keeps (-inf, 0, 0)
        const float alpha = m_new == -INFINITY ? 0.f : __expf(m[g] - m_new);
        float pv[R], psum = 0.f;
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const float pr = valid[rr] ? __expf(s[rr] - m_new) : 0.f;
          psum += pr;
          pv[rr] = kQuant ? pr * v_sc[rr] : pr;
        }
        l[g] = l[g] * alpha + psum;
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e) {
          float a = acc[g][e] * alpha;
#pragma unroll
          for (int rr = 0; rr < R; ++rr) a = fmaf(pv[rr], vf[rr][e], a);
          acc[g][e] = a;
        }
        m[g] = m_new;
      }
    }
    __syncthreads();                            // stage st is free again
    if (i + NS < n) issue(c0 + i + NS, st);
  }

  // Merge the row groups' online-softmax states (the ring's memory reused)
  // into the block's partial.
  float* ms = reinterpret_cast<float*>(ring);   // [n_rg][G]
  float* ls = ms + n_rg * G;                    // [n_rg][G]
  float* as = ls + n_rg * G;                    // [n_rg][G][D]
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
  Q* out = static_cast<Q*>(p.out);
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float M = -INFINITY;
    for (int i = 0; i < n_rg; ++i) M = fmaxf(M, ms[i * G + g]);
    float lsum = 0.f, a = 0.f;
    if (M != -INFINITY) {
      for (int i = 0; i < n_rg; ++i) {
        const float mi = ms[i * G + g];
        const float w = mi == -INFINITY ? 0.f : __expf(mi - M);
        lsum += ls[i * G + g] * w;
        a += as[((size_t)i * G + g) * D + d] * w;
      }
    }
    if (S == 1) {
      store_elem(out + ((size_t)b * p.Hq + qh0 + g) * D + d,
                 lsum > 0.f ? a / lsum : 0.f);
    } else {
      pa[idx] = a;
      if (d == 0) {
        pm[g] = M;
        pl[g] = lsum;
      }
    }
  }
  if (S == 1) return;                           // uniform: no cluster

  // Rank 0 merges the cluster's partials in rank order, reading the other
  // ranks' shared memory; every thread of every rank passes both barriers.
  cluster_sync();
  if (rank == 0) {
    for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
      const int g = idx / D, d = idx % D;
      float M = -INFINITY;
      for (int r = 0; r < S; ++r) M = fmaxf(M, ld_cluster(pm + g, r));
      float lsum = 0.f, a = 0.f;
      if (M != -INFINITY) {
        for (int r = 0; r < S; ++r) {
          const float mr = ld_cluster(pm + g, r);
          const float w = mr == -INFINITY ? 0.f : __expf(mr - M);
          lsum += ld_cluster(pl + g, r) * w;
          a += ld_cluster(pa + idx, r) * w;
        }
      }
      store_elem(out + ((size_t)b * p.Hq + qh0 + g) * D + d,
                 lsum > 0.f ? a / lsum : 0.f);
    }
  }
  cluster_sync();                               // rank 0 has read them all
}

template <typename Q, typename KV, int G>
cudaError_t launch(const Params& a, int blocks, int threads, int smem,
                   cudaStream_t stream) {
  auto kern = paged_decode_kernel<Q, KV, G>;
  static int configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  if (a.splits > 1) {
    // A cluster that cannot be resident is refused here, never launched
    // another way (checked once per shape of the cluster).
    static long long checked = -1;
    const long long key = ((long long)smem << 16) | (threads << 4) | a.splits;
    if (key != checked) {
      int clusters = 0;
      cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
      if (e != cudaSuccess) return e;
      if (clusters < 1) return cudaErrorInvalidConfiguration;
      checked = key;
    }
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename Q, typename KV>
cudaError_t dispatch(int G, const Params& a, int blocks, int threads,
                     int smem, cudaStream_t s) {
#define PD_CASE(g) \
  case g:          \
    return launch<Q, KV, g>(a, blocks, threads, smem, s);
  switch (G) {
    PD_CASE(1) PD_CASE(2) PD_CASE(3) PD_CASE(4)
    PD_CASE(5) PD_CASE(6) PD_CASE(7) PD_CASE(8)
  }
#undef PD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs: the ring's mbarriers, the
// block's partial (what rank 0 reads), and the ring of kStages chunks
// of K and V rows (with an int8 pool's two f32 scales a row), reused
// afterwards for the row-group merge. kv_bytes is the pool's element size
// (1 = int8).
int paged_decode_smem_bytes(int D, int kv_bytes, int block_kv, int group,
                            int packed, int num_warps) {
  const int G = packed ? group : 1;
  const int n_rg = num_warps * kWarp / lanes_per_row(D, lane_vec(kv_bytes));
  const int row = D * kv_bytes + (kv_bytes == 1 ? 4 : 0);
  const int ring = kStages * 2 * block_kv * row;
  const int merge = n_rg * G * (D + 2) * 4;
  return kBarBytes + partial_bytes(G, D) + (ring > merge ? ring : merge);
}

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: q_dtype, or 2 = int8 with
// k_scales and v_scales (null otherwise). kv_splits: blocks (a cluster)
// a row, 1, 2, 4 or 8; bulk: 1 for bulk copies (an int8 pool needs
// page_size and block_kv multiples of 4), 0 for cp.async. Returns a
// cudaError_t (0 = launched).
int paged_decode_launch(const void* q, const void* k_pages,
                        const void* v_pages, const float* k_scales,
                        const float* v_scales, const int* block_tables,
                        const int* kv_len, void* out, int B, int Hq, int Hkv,
                        int D, int n_pages, int page_size, int max_pages,
                        float scale, int block_kv, int pack_gqa,
                        int num_warps, int kv_splits, int bulk,
                        int q_dtype, int kv_dtype, void* stream) {
  const bool quant = kv_dtype == 2;
  const int kv_bytes = quant ? 1 : (kv_dtype == 0 ? 4 : 2);
  const bool scales_ok = quant ? k_scales != nullptr && v_scales != nullptr
                               : k_scales == nullptr && v_scales == nullptr;
  const bool splits_ok = kv_splits == 1 || kv_splits == 2 ||
                         kv_splits == 4 || kv_splits == kMaxSplits;
  const bool bulk_ok = !bulk || !quant ||
                       (page_size % 4 == 0 && block_kv % 4 == 0);
  if ((q_dtype != 0 && q_dtype != 1) || (kv_dtype != q_dtype && !quant) ||
      !scales_ok || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > kMaxHeadDim || (D * kv_bytes) % 16 != 0 || block_kv <= 0 ||
      num_warps <= 0 || num_warps > kMaxWarps || page_size <= 0 ||
      max_pages <= 0 || !splits_ok || (bulk != 0 && bulk != 1) || !bulk_ok)
    return cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  const int packed = pack_gqa && group > 1 ? 1 : 0;
  const int G = packed ? group : 1;
  if (G > kMaxGroup) return cudaErrorInvalidValue;
  const int smem = paged_decode_smem_bytes(D, kv_bytes, block_kv, group,
                                           packed, num_warps);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Params a;
  a.q = q; a.k = k_pages; a.v = v_pages;
  a.k_scales = k_scales; a.v_scales = v_scales;
  a.tables = block_tables; a.kv_len = kv_len; a.out = out;
  a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.n_pages = n_pages; a.page_size = page_size; a.max_pages = max_pages;
  a.scale = scale;
  a.block_kv = block_kv;
  a.packed = packed;
  a.group = group;
  a.tpr = lanes_per_row(D, lane_vec(kv_bytes));
  a.splits = kv_splits;
  a.bulk = bulk;
  const int blocks = B * (packed ? Hkv : Hq) * kv_splits;
  const int threads = num_warps * kWarp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return quant ? dispatch<float, int8_t>(G, a, blocks, threads, smem, s)
                 : dispatch<float, float>(G, a, blocks, threads, smem, s);
  return quant
             ? dispatch<__nv_bfloat16, int8_t>(G, a, blocks, threads, smem, s)
             : dispatch<__nv_bfloat16, __nv_bfloat16>(G, a, blocks, threads,
                                                      smem, s);
}

}  // extern "C"
