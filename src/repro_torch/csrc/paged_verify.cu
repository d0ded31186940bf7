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
// cap)) and attends k_pos <= L_b - K + t; a query whose window is empty
// writes exact zeros.
//
// Bound: memory. A call reads 2 * sum_b L_b * Hkv * D * itemsize bytes of
// K/V (int8 pools: D + 4 bytes a row and head, the scale included) plus q
// and writes o -- the bytes of one paged_decode call -- and does K times
// paged_decode's arithmetic, still far below the card's balance point at
// K <= 8. The design is paged_decode's (csrc/paged_decode.cu), carried
// over to K * g query rows: each K/V row crosses HBM once for all the
// query rows that share it, and each row of the grid is spread over
// several SMs:
//
//   * Split-KV over a thread-block cluster. The grid is rows x kv_splits
//     blocks, one cluster of kv_splits blocks a row (no cluster when it is
//     1); a row is (b, kv_head) when pack_gqa is set (its K * g query rows,
//     row r = t * g + gi: draft position t, group head gi), else (b,
//     q_head) (K query rows). Rank s takes an equal share of the row's
//     chunks of `block_kv` tokens of [0, L), cut on chunk boundaries on the
//     device from kv_len, and runs the online softmax over its span in f32.
//   * The partials merge in distributed shared memory. Each block leaves
//     its (m, l, acc) for every query row in its own shared memory; after a
//     cluster barrier rank 0 reads the other ranks' partials (mapa +
//     ld.shared::cluster) and merges them in rank order, so every bit of
//     the result is the same whatever the timing; a second cluster barrier
//     keeps every block alive until rank 0 has read it. No workspace in
//     global memory and no second launch. Every thread of every block
//     reaches both barriers (a block with an empty span too: its partial is
//     (-inf, 0, 0) and weighs 0).
//   * A ring of two chunks in shared memory, each stage completing on its
//     own mbarrier. A chunk is one 1-D bulk copy (cp.async.bulk ...
//     mbarrier::complete_tx) per page run for K, for V and, for an int8
//     pool, for each scale run, issued by the lanes of warp 0, each reading
//     its own entry of the block table; a chunk may be a part of one page.
//     Where a bulk copy cannot go (an int8 pool whose scale runs are not
//     16-byte multiples: a page size or block_kv not a multiple of 4 rows),
//     every thread copies rows with 16-byte cp.async (4-byte for the
//     scales) and the stage's mbarrier tracks them
//     (cp.async.mbarrier.arrive.noinc). The wrapper reports the path.
//   * Query rows and their state in registers. A row group of `tpr` lanes
//     holds one query set -- at most kMaxSet rows -- with 8 elements of
//     each row's q and of its running (m, l, acc) per lane in f32
//     registers, and scores the set against R staged K/V rows at a time
//     (4 for a set of one or two rows, else 2, as paged_decode's groups),
//     the set's q.k reduced over the row group with interleaved shuffle
//     trees and its state rescaled once for the R rows. The block's rows
//     are cut into the fewest sets of at most kMaxSet (K 2 x group 3: two
//     sets of 3; K 8 x group 3: six of 4); the row groups are dealt to the
//     sets, each set's row groups splitting the chunk's keys, so every set
//     reads the same staged chunk. kMaxSet is 4, not paged_decode's 8:
//     phi4-mini's deployment shape ran fastest with sets of up to 4 rows
//     (scripts/paged_verify_sweep.py times 2, 4 and 8; PERF.md gives the
//     times). A block with more sets than row groups streams its span
//     once per pass of sets. At
//     the end of a pass the row groups' states merge through shared memory
//     (the ring's memory) into the block's partial; no state makes a round
//     trip through shared memory per chunk.
//   * One exponential a lane. The set's R probabilities a row and its G
//     rescales are computed once for the row group, not once a lane:
//     lane j of the group takes exponent j, and shuffles share the
//     results (the sweep's `lane_exps` variant computes them all in every
//     lane).
//   * The causal tail. Keys below L - K + 1 are unmasked for every query
//     row, so only a chunk that reaches past L - K masks, per row, the
//     keys past that row's position. A masked key adds nothing (its
//     probability is zero, not exp of a large negative).
//   * Accuracy. The scale multiplies the finished dot product and the
//     exponentials are the accurate expf, as the plain version computes
//     them: the closer the f32 result, the fewer bf16 outputs round the
//     other way, and a deep model amplifies each one that does. Under int8
//     the key's scale multiplies the finished q.k and the value's scale the
//     probability once l has taken it, both exact in algebra; an int8 value
//     becomes an f32 by integer byte moves and one add, not the
//     quarter-rate I2F.
//
// CUDA-core FMAs, no tensor cores. At the serving depth a packed row scores
// K 2 x group 3 = 6 query rows against each K/V row: 6 of mma.sync's 16
// rows, and far below the card's balance point (about 295 bf16 operations
// a byte). Tensor cores over the K * g rows would be a second pass, taken
// only once a measurement shows that the score loop's instructions bound
// this kernel: its time at the deployment shape against its byte bound
// and against paged_decode's under the same timer, int8 pools against
// bf16 ones (equal times mean instructions, not bytes, bound it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxSet = 4;                      // query rows a row group holds
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

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// x[i] for an index i known only at run time, without local memory: a
// tree of selects on i's bits (-inf for i >= N).
template <int N>
__device__ __forceinline__ float pick(const float (&x)[N], int i) {
  constexpr int P2 = pow2_at_least(N);
  float t[P2];
#pragma unroll
  for (int j = 0; j < P2; ++j) t[j] = j < N ? x[j] : -INFINITY;
#pragma unroll
  for (int w = 1; w < P2; w <<= 1) {
#pragma unroll
    for (int j = 0; j < P2; j += 2 * w) t[j] = (i & w) ? t[j + w] : t[j];
  }
  return i < N ? t[0] : -INFINITY;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (the parity wait traps after 2^26 polls: a fault in the
// protocol fails the launch instead of hanging the card) -----------------

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

// This thread's writes to shared memory ordered before later bulk copies
// into the same bytes (the ring, reused for the merge between passes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Query rows of a block: K draft positions of each packed head.
int query_rows(int draft_k, int group, int packed) {
  return draft_k * (packed && group > 1 ? group : 1);
}

// The fewest query sets of at most kMaxSet rows, and the rows of each
// (the last set may hold fewer).
int query_sets(int rows) { return (rows + kMaxSet - 1) / kMaxSet; }

int set_rows(int rows) {
  const int sets = query_sets(rows);
  return (rows + sets - 1) / sets;
}

// The block's partial (m, l per query row, then acc per row and dim), f32.
__host__ __device__ inline int partial_bytes(int rows, int D) {
  return round_up(rows * (D + 2) * 4, 16);
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
  int K, Hq, Hkv, D, n_pages, page_size, max_pages;
  float scale;
  int block_kv, packed, group, rows, sets, tpr, splits, bulk;
};

// Two blocks of 8 warps an SM where the registers allow it (128 a
// thread): the float pools' states do not fit.
template <typename KV>
constexpr int kMinBlocks = std::is_same<KV, float>::value ? 1 : 2;

// G: the rows of a query set (1..kMaxSet).
template <typename Q, typename KV, int G>
__global__ void __launch_bounds__(kMaxWarps * kWarp, kMinBlocks<KV>)
paged_verify_kernel(const Params p) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int VEC = Vec<KV>::N;               // elements of a lane read
  constexpr int NV = kLaneElems / VEC;          // reads per lane: 1 or 2
  constexpr int CVEC = 16 / sizeof(KV);         // elements of a cp.async
  constexpr int R = G <= 2 ? 4 : 2;             // K/V rows in flight
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
  const int gq = p.packed ? p.group : 1;        // query heads of the block
  const int cap = p.max_pages * ps;
  int L = p.kv_len[b];
  L = L < 0 ? 0 : (L > cap ? cap : L);
  const int first_tail = L - p.K + 1;           // keys past it are masked

  // This rank's chunks: an equal share of the row's, cut on chunks.
  const int n_chunks = (L + block_kv - 1) / block_kv;
  const int per_rank = (n_chunks + S - 1) / S;
  const int c0 = min(rank * per_rank, n_chunks);
  const int n = min(c0 + per_rank, n_chunks) - c0;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // [NS]
  float* pm = reinterpret_cast<float*>(smem_raw + kBarBytes);  // [rows]
  float* pl = pm + p.rows;                                     // [rows]
  float* pa = pl + p.rows;                                     // [rows][D]
  unsigned char* ring = smem_raw + kBarBytes + partial_bytes(p.rows, D);
  KV* ks = reinterpret_cast<KV*>(ring);         // [NS][block_kv][D]
  KV* vs = ks + (size_t)NS * block_kv * D;
  float* kss = reinterpret_cast<float*>(vs + (size_t)NS * block_kv * D);
  float* vss = kss + NS * block_kv;             // [NS][block_kv], int8 only
  // the row groups' merge, the ring's memory reused after each pass
  float* ms = reinterpret_cast<float*>(ring);   // [n_rg][G]

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(&full[i], p.bulk ? 1 : blockDim.x);
    mbar_fence_init();
  }

  const int n_vec = D / VEC;
  const int n_cvec = D / CVEC;
  const int lane = threadIdx.x % kWarp;
  const int tpr = p.tpr;
  const int sub = lane % tpr;                   // lane within its row group
  const int rg = threadIdx.x / tpr;             // row group of this thread
  const int n_rg = blockDim.x / tpr;
  float* ls = ms + n_rg * G;                    // [n_rg][G]
  float* as = ls + n_rg * G;                    // [n_rg][G][D]
  // Row groups dealt to the query sets: spp sets a pass, each scored by
  // `slots` row groups that split the chunk's keys.
  const int spp = min(p.sets, n_rg);
  const int slots = n_rg / spp;
  const int passes = (p.sets + spp - 1) / spp;
  const int s_local = rg % spp;
  const int slot = rg / spp;

  const size_t head_rows = (size_t)p.n_pages * ps;
  const KV* kbase = static_cast<const KV*>(p.k) + kvh * head_rows * D;
  const KV* vbase = static_cast<const KV*>(p.v) + kvh * head_rows * D;
  const float* ksbase = kQuant ? p.k_scales + kvh * head_rows : nullptr;
  const float* vsbase = kQuant ? p.v_scales + kvh * head_rows : nullptr;
  const int* tbl = p.tables + (size_t)b * p.max_pages;
  auto row_off = [&](int r) -> size_t {         // query row r in q and out
    return (((size_t)b * p.K + r / gq) * p.Hq + qh0 + r % gq) * D;
  };
  Q* out = static_cast<Q*>(p.out);

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
  for (int pass = 0; pass < passes; ++pass) {
    const int set = pass * spp + s_local;
    const bool active = slot < slots && set < p.sets;
    // This row group's query rows set * G + g: q and the last key each
    // attends (the padding rows of a short last set score and are dropped).
    float qf[G][kLaneElems];
    int lim[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = set * G + g;
      const bool ok = active && r < p.rows;
      lim[g] = L - p.K + r / gq;
      const Q* qrow = static_cast<const Q*>(p.q) + row_off(r);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int vi = sub + j * tpr;
        if (ok && vi < n_vec) {
#pragma unroll
          for (int e0 = 0; e0 < VEC; e0 += 4)
            load4(qrow + vi * VEC + e0, &qf[g][j * VEC + e0]);
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

    const int it0 = pass * n;                   // ring uses before this pass
    for (int i = 0; i < min(n, NS); ++i) issue(c0 + i, (it0 + i) % NS);
    for (int i = 0; i < n; ++i) {
      const int st = (it0 + i) % NS;
      mbar_wait(&full[st], ((it0 + i) / NS) & 1);
      const int t0 = (c0 + i) * block_kv;
      const int chunk = min(block_kv, L - t0);
      const int rows = active ? chunk : 0;
      const bool tail = t0 + chunk > first_tail;  // the causal tail's chunk
      const KV* kc = ks + (size_t)st * block_kv * D;
      const KV* vc = vs + (size_t)st * block_kv * D;
      const int iters = (chunk + slots * R - 1) / (slots * R);  // uniform
      for (int it = 0; it < iters; ++it) {
        // R K/V rows a row group, `slots` apart: their dot products,
        // shuffle trees and exps are independent, and the running state
        // is rescaled once.
        int r[R];
        bool valid[R];
        float kf[R][kLaneElems], vf[R][kLaneElems];
        float k_sc[R], v_sc[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          r[rr] = (it * R + rr) * slots + slot;
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
          // The row's scales (int8): the key's multiplies the finished
          // q.k, the value's the probability after l has taken it.
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
        // q.k of the set's G rows and the R keys, reduced over the row
        // group by interleaved shuffle trees
        float sc[G][R];
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < kLaneElems; ++e)
              dot = fmaf(qf[g][e], kf[rr][e], dot);
            sc[g][rr] = dot;
          }
        }
        for (int off = tpr >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int rr = 0; rr < R; ++rr)
              sc[g][rr] += __shfl_xor_sync(0xffffffffu, sc[g][rr], off, tpr);
          }
        }
        // The scores (int8: the key's scale on the finished q.k, then the
        // softmax scale), the causal tail's mask, each row's new running
        // max, and the G * R + G exponents: the keys' probabilities, then
        // the rows' rescales (-inf for a masked key and for a row that
        // has seen no key: exp gives 0).
        constexpr int NX = G * R + G;
        float x[NX], m_new[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          bool ok[R];
          m_new[g] = m[g];
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            if (kQuant) sc[g][rr] *= k_sc[rr];
            sc[g][rr] *= p.scale;
            ok[rr] = valid[rr] && (!tail || t0 + r[rr] <= lim[g]);
            if (ok[rr]) m_new[g] = fmaxf(m_new[g], sc[g][rr]);
          }
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
            x[g * R + rr] = ok[rr] ? sc[g][rr] - m_new[g] : -INFINITY;
          x[G * R + g] = m_new[g] == -INFINITY ? -INFINITY : m[g] - m_new[g];
        }
        // One accurate expf a lane: lane j of the row group takes exponent
        // j (and j + tpr in a second round where tpr < NX), and the row
        // group's lanes share the results by shuffles.
        for (int j0 = 0; j0 < NX; j0 += tpr) {      // uniform
          const float ex = expf(pick(x, sub + j0));
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            if (j >= j0 && j < j0 + tpr)
              x[j] = __shfl_sync(0xffffffffu, ex, j - j0, tpr);
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float alpha = x[G * R + g];
          float pv[R], psum = 0.f;
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            psum += x[g * R + rr];
            pv[rr] = kQuant ? x[g * R + rr] * v_sc[rr] : x[g * R + rr];
          }
          l[g] = l[g] * alpha + psum;
#pragma unroll
          for (int e = 0; e < kLaneElems; ++e) {
            float a = acc[g][e] * alpha;
#pragma unroll
            for (int rr = 0; rr < R; ++rr) a = fmaf(pv[rr], vf[rr][e], a);
            acc[g][e] = a;
          }
          m[g] = m_new[g];
        }
      }
      __syncthreads();                          // stage st is free again
      if (i + NS < n) issue(c0 + i + NS, st);
    }

    // Merge the row groups' states of this pass's sets (the ring's memory
    // reused) into the block's partial, or into out at one split.
    if (active) {
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
              as[((size_t)rg * G + g) * D + vi * VEC + e] =
                  acc[g][j * VEC + e];
          }
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < spp * G * D; idx += blockDim.x) {
      const int sl = idx / (G * D), g = idx / D % G, d = idx % D;
      const int r = (pass * spp + sl) * G + g;
      if (pass * spp + sl >= p.sets || r >= p.rows) continue;
      float M = -INFINITY;
      for (int j = 0; j < slots; ++j)
        M = fmaxf(M, ms[(j * spp + sl) * G + g]);
      float lsum = 0.f, a = 0.f;
      if (M != -INFINITY) {
        for (int j = 0; j < slots; ++j) {
          const int i = (j * spp + sl) * G + g;
          const float w = ms[i] == -INFINITY ? 0.f : expf(ms[i] - M);
          lsum += ls[i] * w;
          a += as[(size_t)i * D + d] * w;
        }
      }
      if (S == 1) {
        store_elem(out + row_off(r) + d, lsum > 0.f ? a / lsum : 0.f);
      } else {
        pa[(size_t)r * D + d] = a;
        if (d == 0) {
          pm[r] = M;
          pl[r] = lsum;
        }
      }
    }
    if (pass + 1 < passes) {                    // the ring takes copies again
      fence_proxy_async();
      __syncthreads();
    }
  }
  if (S == 1) return;                           // uniform: no cluster

  // Rank 0 merges the cluster's partials in rank order, reading the other
  // ranks' shared memory; every thread of every rank passes both barriers.
  cluster_sync();
  if (rank == 0) {
    for (int idx = threadIdx.x; idx < p.rows * D; idx += blockDim.x) {
      const int r = idx / D, d = idx % D;
      float M = -INFINITY;
      for (int k = 0; k < S; ++k) M = fmaxf(M, ld_cluster(pm + r, k));
      float lsum = 0.f, a = 0.f;
      if (M != -INFINITY) {
        for (int k = 0; k < S; ++k) {
          const float mk = ld_cluster(pm + r, k);
          const float w = mk == -INFINITY ? 0.f : expf(mk - M);
          lsum += ld_cluster(pl + r, k) * w;
          a += ld_cluster(pa + idx, k) * w;
        }
      }
      store_elem(out + row_off(r) + d, lsum > 0.f ? a / lsum : 0.f);
    }
  }
  cluster_sync();                               // rank 0 has read them all
}

template <typename Q, typename KV, int G>
cudaError_t launch(const Params& a, int blocks, int threads, int smem,
                   cudaStream_t stream) {
  auto kern = paged_verify_kernel<Q, KV, G>;
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
  static_assert(kMaxSet == 4, "a set of G rows instantiates G = 1..4");
  switch (G) {
    case 1: return launch<Q, KV, 1>(a, blocks, threads, smem, s);
    case 2: return launch<Q, KV, 2>(a, blocks, threads, smem, s);
    case 3: return launch<Q, KV, 3>(a, blocks, threads, smem, s);
    case 4: return launch<Q, KV, 4>(a, blocks, threads, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs: the ring's mbarriers, the
// block's partial (what rank 0 reads: m, l and acc of every query row),
// and the ring of kStages chunks of K and V rows (with an int8 pool's two
// f32 scales a row), reused after each pass for the row groups' merge.
// kv_bytes is the pool's element size (1 = int8).
int paged_verify_smem_bytes(int D, int kv_bytes, int block_kv, int draft_k,
                            int group, int packed, int num_warps) {
  const int rows = query_rows(draft_k, group, packed);
  const int n_rg = num_warps * kWarp / lanes_per_row(D, lane_vec(kv_bytes));
  const int row = D * kv_bytes + (kv_bytes == 1 ? 4 : 0);
  const int ring = kStages * 2 * block_kv * row;
  const int merge = n_rg * set_rows(rows) * (D + 2) * 4;
  return kBarBytes + partial_bytes(rows, D) + (ring > merge ? ring : merge);
}

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: q_dtype, or 2 = int8 with
// k_scales and v_scales (null otherwise). kv_splits: blocks (a cluster)
// a row, 1, 2, 4 or 8; bulk: 1 for bulk copies (an int8 pool needs
// page_size and block_kv multiples of 4), 0 for cp.async. Returns a
// cudaError_t (0 = launched).
int paged_verify_launch(const void* q, const void* k_pages,
                        const void* v_pages, const float* k_scales,
                        const float* v_scales, const int* block_tables,
                        const int* kv_len, void* out, int B, int K, int Hq,
                        int Hkv, int D, int n_pages, int page_size,
                        int max_pages, float scale, int block_kv,
                        int pack_gqa, int num_warps, int kv_splits, int bulk,
                        int q_dtype, int kv_dtype, void* stream) {
  const bool quant = kv_dtype == 2;
  const int q_bytes = q_dtype == 0 ? 4 : 2;
  const int kv_bytes = quant ? 1 : q_bytes;
  const bool scales_ok = quant ? k_scales != nullptr && v_scales != nullptr
                               : k_scales == nullptr && v_scales == nullptr;
  const bool splits_ok = kv_splits == 1 || kv_splits == 2 ||
                         kv_splits == 4 || kv_splits == kMaxSplits;
  const bool bulk_ok = !bulk || !quant ||
                       (page_size % 4 == 0 && block_kv % 4 == 0);
  if ((q_dtype != 0 && q_dtype != 1) || (kv_dtype != q_dtype && !quant) ||
      !scales_ok || K <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > kMaxHeadDim || (D * kv_bytes) % 16 != 0 ||
      (D * q_bytes) % 16 != 0 || block_kv <= 0 || num_warps <= 0 ||
      num_warps > kMaxWarps || page_size <= 0 || max_pages <= 0 ||
      !splits_ok || (bulk != 0 && bulk != 1) || !bulk_ok)
    return cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  const int packed = pack_gqa && group > 1 ? 1 : 0;
  const int smem = paged_verify_smem_bytes(D, kv_bytes, block_kv, K, group,
                                           packed, num_warps);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Params a;
  a.q = q; a.k = k_pages; a.v = v_pages;
  a.k_scales = k_scales; a.v_scales = v_scales;
  a.tables = block_tables; a.kv_len = kv_len; a.out = out;
  a.K = K; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.n_pages = n_pages; a.page_size = page_size; a.max_pages = max_pages;
  a.scale = scale;
  a.block_kv = block_kv;
  a.packed = packed;
  a.group = group;
  a.rows = query_rows(K, group, packed);
  a.sets = query_sets(a.rows);
  a.tpr = lanes_per_row(D, lane_vec(kv_bytes));
  a.splits = kv_splits;
  a.bulk = bulk;
  const int G = set_rows(a.rows);
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
