// Ragged GQA flash-decode over a dense float KV cache for Hopper (sm_90a),
// in one launch, with a plain C interface.
//
// Replaces the TPU kernel `_decode_kernel` of src/repro/kernels/
// decode_attention.py and its two launchers, `gqa_decode`
// (src/repro/kernels/gqa_decode.py) and `decode_attention`: one query
// token per head attends its request's cache up to the request's own length.
//
//   q        (B, Hq, D)          T = float or bf16, contiguous
//   k, v     (B, Hkv, T_len, D)  T, read through strides (sb, sh, st) in
//                                elements with D contiguous: the serving
//                                cache is stored (B, T_len, Hkv, D) and
//                                handed over as a transposed view
//   kv_len   (B,)                int32, clamped to [0, T_len]
//   out      (B, Hq, D)          T, f32 math cast at the end
//
// Bound: memory. A call reads 2 * sum_b min(kv_len_b, T) * Hkv * D *
// itemsize bytes of K/V and does 4 operations per K/V element and query
// head of the group, far below the card's balance point. A static batch
// gives few rows (8 x 8 packed at the serving shape, on 132 SMs) and
// ragged lengths, so the design spreads each row over several SMs, keeps
// every SM's copies in flight, and writes nothing but o:
//
//   * Split-KV over a thread-block cluster. A row is one (b, kv head) with
//     the query group packed (its G = Hq / Hkv heads scored against each
//     staged K/V row, so each row crosses HBM once), or one (b, q head)
//     unpacked. The grid is rows x k_splits blocks, one cluster of
//     k_splits blocks a row (no cluster when it is 1). Rank s takes an
//     equal share of the row's chunks of `block_kv` keys of min(kv_len,
//     T_len): chunks [s n / S, (s + 1) n / S) of n, cut on the device from
//     kv_len, so a short request's ranks find its keys and a long one is
//     cut as finely as a short one.
//   * The partials merge in distributed shared memory. Each block leaves
//     its (m, l, acc) for the row's heads in its own shared memory; after
//     a cluster barrier rank 0 reads the other ranks' partials (mapa +
//     ld.shared::cluster) and merges them in rank order, so every bit of
//     the result is the same from call to call; a second cluster barrier
//     keeps every block alive until rank 0 has read it. No workspace, no
//     second launch. Every thread of every rank reaches both barriers (an
//     empty span too: its partial is (-inf, 0, 0) and weighs 0), so
//     kv_len 0 gives exact zeros.
//   * The rows are taken longest request first. Blocks start roughly in
//     the order of their index, so each block maps its row to the request
//     of that rank in decreasing kv_len (read and ranked on the device):
//     at the deployment lengths (920 to 31,275 of 32,768) the longest
//     request's blocks no longer start last and run alone at the end.
//   * A ring of two chunks in shared memory, each stage completing on its
//     own mbarrier, so the copy of the next chunk overlaps the scoring of
//     this one. bf16 caches: thread 0 loads a chunk of K and of V by TMA,
//     one box of block_kv rows x 64 columns per 64-column block of D
//     (128-byte swizzled), and a box of 32 columns (64-byte swizzled) for
//     a row's last 1-32 columns past them (D 96 and 160), so a staged row
//     takes the bytes it has. The tensor maps over the strided (B, Hkv,
//     T_len, D) view are encoded on the host (hopper::encode_tiled); rows
//     past T_len and columns past D are filled with zeros. f32 caches (for
//     parity only) copy the same layout with 16-byte cp.async, every
//     thread arriving on the stage's mbarrier (cp.async.mbarrier.arrive
//     .noinc). A stage is refilled once every warp has left it.
//   * The swizzle is undone in the address (chunk_off): 16-byte chunk c of
//     row r sits at chunk c ^ (r % 8) of a 128-byte row, c ^ (r / 2 % 4)
//     of a 64-byte row, which keeps the lanes' reads on distinct banks
//     without padding.
//
// The score loop keeps one key a lane, the design this kernel had before
// the split moved into the cluster: a warp takes 32 keys of a chunk, each
// lane runs the whole D-long q.k of its key for the G query rows (q waits
// in shared memory in f32 and every lane reads the same element, a
// broadcast) into four partial sums a row, one online-softmax update per
// 32 keys and head follows (a warp max; each lane sums its own keys'
// probabilities, reduced over the warp once at the end), then p.V with
// the lanes splitting D, four keys' probabilities read at a time from the
// warp's own shared scratch, eight keys' rows at offsets fixed for the
// lane. Row groups (paged_decode's R rows on interleaved shuffle
// trees) were not taken: they spend a shuffle tree, an exp and a rescale
// per row on every lane of the row group, about twice the instructions a
// key of the packed group that this loop spends, where every dot product
// stays in one lane and an exp is one lane's. Each warp keeps its own (m,
// l, acc) in registers, merged in warp order through shared memory at the
// end. IEEE f32 FMAs and the accurate expf; the scale multiplies the
// finished dot product, as the plain version computes it; a masked key
// adds nothing (probability 0).
//
// CUDA-core FMAs, no tensor cores: for one query token per head the
// product is a matrix-vector one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxGroup = 8;
constexpr int kMaxWarps = 8;                    // 256 threads: the launch bounds
constexpr int kMaxHeadDim = 256;
constexpr int kMaxBlockKv = 256;                // a TMA box's rows
constexpr int kUnit = 4;                        // elements of a lane's p.V load
constexpr int kMaxSmem = 232448;                // 227 KB opt-in per block
constexpr int kMaxSplits = 8;                   // the portable cluster size
constexpr int kStages = 2;                      // the ring's depth
constexpr int kBarBytes = 64;                   // the ring's mbarriers
constexpr int kMaxSorted = 256;                 // requests ordered by length
constexpr int kAlign = 1024;                    // slack to a swizzle atom

using bf16 = __nv_bfloat16;
using hopper::smem_u32;

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

// One 16-byte chunk as floats: 4 f32 or 8 bf16.
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// Four consecutive elements as floats (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ void load4(const float* p, float* o) {
  load16(p, o);
}
__device__ __forceinline__ void load4(const bf16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
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

// 16-byte async copy of one thread, and its arrival on `bar` once its
// copies have landed (the barrier counts one arrival a thread: noinc).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

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

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Bytes of one stage of K (or of V), block_kv rows of each column block
// of D: 128-byte rows (64 bf16 or 32 f32 columns), and for a row whose
// last 1-64 bytes are left over, a block of 64-byte rows for them.
__host__ __device__ inline int tile_bytes(int D, int kv_bytes, int block_kv) {
  const int row = D * kv_bytes;
  const int tail = row % 128;
  return (row - tail + (tail > 64 ? 128 : tail > 0 ? 64 : 0)) * block_kv;
}

// Byte offset in a stage's tile of 16-byte chunk ch of row r, with n128
// blocks of 128-byte rows (128-byte swizzle: chunk c ^ (r % 8)) before a
// block of 64-byte rows (64-byte swizzle: chunk c ^ (r / 2 % 4)), as TMA
// lays the boxes down.
__device__ __forceinline__ int chunk_off(int ch, int r, int bkv, int n128) {
  if (ch < 8 * n128)
    return (ch >> 3) * bkv * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
  return n128 * bkv * 128 + r * 64 +
         (((ch - 8 * n128) ^ ((r >> 1) & 3)) << 4);
}

// The block's partial (m, l per head, then acc per head and dim), f32.
__host__ __device__ inline int partial_bytes(int G, int D) {
  return round_up(G * (D + 2) * 4, 16);
}

struct Params {
  const void* q;
  const void* k;                                // f32 caches: cp.async
  const void* v;
  const int* kv_len;
  void* out;
  long long sb, sh, st;
  int B, Hq, Hkv, t_len, D;
  float scale;
  int block_kv, packed, group, splits;
};

// Two blocks of 8 warps an SM where the registers allow it (128 a
// thread); the large groups' states do not fit.
template <int G>
constexpr int kMinBlocks = G <= 4 ? 2 : 1;

// T: the cache's type (and q's); G: query rows of a block (the packed
// group, or 1); NU: 4-element units of D a lane holds for p.V (1 up to D =
// 128, else 2).
template <typename T, int G, int NU>
__global__ void __launch_bounds__(kMaxWarps * kWarp, (kMinBlocks<G>))
gqa_decode_kernel(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tk64,
                  const __grid_constant__ CUtensorMap tv64, const Params p) {
  constexpr bool kTma = std::is_same<T, bf16>::value;
  constexpr int VEC = 16 / sizeof(T);           // elements of a 16-byte chunk
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);

  constexpr int NS = kStages;
  const int D = p.D, bkv = p.block_kv, S = p.splits;
  const int n_warps = blockDim.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int rank = blockIdx.x % S;              // cluster rank (1-D)
  const int row = blockIdx.x / S;
  const int heads_per_row = p.packed ? p.Hkv : p.Hq;
  const int h = row % heads_per_row;
  const int kvh = p.packed ? h : h / p.group;
  const int qh0 = p.packed ? h * p.group : h;
  // The rows are taken longest request first (the blocks start roughly in
  // their index's order, so the last to start are the shortest): request
  // b of rank row / heads_per_row in decreasing min(kv_len, T_len), ties
  // by index. Past kMaxSorted requests, in index order.
  int b = row / heads_per_row;
  if (p.B <= kMaxSorted) {
    int* lens = reinterpret_cast<int*>(ring);   // the ring, before its loads
    int* row_b = lens + kMaxSorted;
    for (int i = threadIdx.x; i < p.B; i += blockDim.x)
      lens[i] = min(max(p.kv_len[i], 0), p.t_len);
    __syncthreads();
    for (int i = threadIdx.x; i < p.B; i += blockDim.x) {
      int rank_i = 0;
      for (int j = 0; j < p.B; ++j)
        rank_i += lens[j] > lens[i] || (lens[j] == lens[i] && j < i);
      if (rank_i == b) *row_b = i;
    }
    __syncthreads();
    b = *row_b;
  }
  int L = p.kv_len[b];
  L = L < 0 ? 0 : (L > p.t_len ? p.t_len : L);

  // This rank's chunks: an equal share of the row's, cut on chunks.
  const int n_chunks = (L + bkv - 1) / bkv;
  const int c0 = rank * n_chunks / S;
  const int n = (rank + 1) * n_chunks / S - c0;

  // [ring or warp merge][q][p scratch][partial][mbarriers]
  const int tile = tile_bytes(D, sizeof(T), bkv);
  const int row_bytes = D * (int)sizeof(T);
  const int n128 = row_bytes / 128 + (row_bytes % 128 > 64);
  const bool tail64 = n128 * 128 < row_bytes;   // a block of 64-byte rows
  const int merge = round_up(n_warps * G * (D + 2) * 4, 16);
  unsigned char* ks = ring;                     // [NS][tile]
  unsigned char* vs = ring + NS * tile;         // [NS][tile]
  float* qs = reinterpret_cast<float*>(
      ring + (2 * NS * tile > merge ? 2 * NS * tile : merge));  // [G][D]
  float* pscr = qs + G * D;                     // [n_warps][G][32]
  float* pm = pscr + n_warps * G * kWarp;       // [G]
  float* pl = pm + G;                           // [G]
  float* pa = pl + G;                           // [G][D]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(pm) + partial_bytes(G, D));  // [NS]
  // The lane's p.V reads: unit u = lane + 32 j of 4 elements sits in
  // row r at r * pitch[j] + voff[j][r % 8] (the swizzle depends on r % 8
  // alone).
  const int n_units = D / kUnit;
  int voff[NU][8], pitch[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int byte = (lane + j * kWarp) * kUnit * (int)sizeof(T);
    const int ch = byte >> 4;
    pitch[j] = ch < 8 * n128 ? 128 : 64;
#pragma unroll
    for (int x = 0; x < 8; ++x)
      voff[j][x] = chunk_off(ch, x, bkv, n128) - x * pitch[j] + (byte & 15);
  }

  if (threadIdx.x == 0) {
    if constexpr (kTma) {
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      if (tail64) {
        hopper::tma_prefetch(&tk64);
        hopper::tma_prefetch(&tv64);
      }
    }
    for (int i = 0; i < NS; ++i)
      hopper::mbar_init(&full[i], kTma ? 1 : blockDim.x);
    hopper::mbar_fence_init();
  }
  const T* q = static_cast<const T*>(p.q) + ((size_t)b * p.Hq + qh0) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    qs[i] = to_float(q[i]);

  const int n_vec = D / VEC;                    // 16-byte chunks of a row
  // Chunk c into stage st: TMA boxes from thread 0 (bf16), or every
  // thread's cp.async chunks into the same swizzled places (f32).
  auto issue = [&](int c, int st) {
    const int t0 = c * bkv;
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        hopper::mbar_expect_tx(&full[st], 2 * tile);
        for (int cb = 0; cb < n128; ++cb) {
          const int off = st * tile + cb * bkv * 128;
          hopper::tma_tile(ks + off, &tk, cb * 64, t0, kvh, b, &full[st]);
          hopper::tma_tile(vs + off, &tv, cb * 64, t0, kvh, b, &full[st]);
        }
        if (tail64) {
          const int off = st * tile + n128 * bkv * 128;
          hopper::tma_tile(ks + off, &tk64, n128 * 64, t0, kvh, b, &full[st]);
          hopper::tma_tile(vs + off, &tv64, n128 * 64, t0, kvh, b, &full[st]);
        }
      }
    } else {
      const int rows = min(bkv, L - t0);
      const T* kb = static_cast<const T*>(p.k) + (size_t)b * p.sb +
                    (size_t)kvh * p.sh + (size_t)t0 * p.st;
      const T* vb = static_cast<const T*>(p.v) + (size_t)b * p.sb +
                    (size_t)kvh * p.sh + (size_t)t0 * p.st;
      for (int i = threadIdx.x; i < rows * n_vec; i += blockDim.x) {
        const int r = i / n_vec, ch = i % n_vec;
        const int off = st * tile + chunk_off(ch, r, bkv, n128);
        const size_t g = (size_t)r * p.st + ch * VEC;
        cp_async16(ks + off, kb + g);
        cp_async16(vs + off, vb + g);
      }
      cp_async_arrive(&full[st]);
    }
  };

  float m[G], l[G], acc[G][NU * kUnit];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < NU * kUnit; ++e) acc[g][e] = 0.f;
  }
  float* my_p = pscr + warp * G * kWarp;

  __syncthreads();                              // barriers set, q staged
  for (int i = 0; i < min(n, NS); ++i) issue(c0 + i, i);
  for (int i = 0; i < n; ++i) {
    const int st = i % NS;
    hopper::mbar_wait(&full[st], (i / NS) & 1);
    const int rows = min(bkv, L - (c0 + i) * bkv);
    const unsigned char* kc = ks + st * tile;
    const unsigned char* vc = vs + st * tile;
    for (int j0 = warp * kWarp; j0 < rows; j0 += n_warps * kWarp) {
      // q.k: lane `lane` scores key j0 + lane (clamped into the chunk's
      // rows, so every read is of staged data), one 16-byte chunk of its
      // row at a time, the swizzle undone in the address.
      const bool valid = j0 + lane < rows;
      const int jk = min(j0 + lane, rows - 1);
      float part[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[g][e] = 0.f;
#pragma unroll 4
      for (int ch = 0; ch < n_vec; ++ch) {
        float kf[VEC];
        load16(reinterpret_cast<const T*>(kc + chunk_off(ch, jk, bkv, n128)),
               kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int e0 = 0; e0 < VEC; e0 += 4) {
            const float4 qf = *reinterpret_cast<const float4*>(
                qs + g * D + ch * VEC + e0);
            part[g][0] = fmaf(qf.x, kf[e0], part[g][0]);
            part[g][1] = fmaf(qf.y, kf[e0 + 1], part[g][1]);
            part[g][2] = fmaf(qf.z, kf[e0 + 2], part[g][2]);
            part[g][3] = fmaf(qf.w, kf[e0 + 3], part[g][3]);
          }
        }
      }
      // One online-softmax update per 32 keys and head; the probabilities
      // go to the warp's scratch for p.V.
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float dot = (part[g][0] + part[g][1]) + (part[g][2] + part[g][3]);
        const float s = valid ? dot * p.scale : -INFINITY;
        const float m_new = fmaxf(m[g], warp_max(s));
        const float alpha = expf(m[g] - m_new);
        const float pr = valid ? expf(s - m_new) : 0.f;
        l[g] = l[g] * alpha + pr;               // the lane's own keys
#pragma unroll
        for (int e = 0; e < NU * kUnit; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
        my_p[g * kWarp + lane] = pr;
      }
      __syncwarp();
      // p.V: the lanes split D. A whole pass of 32 keys (j0 a multiple of
      // 8) reads row j0 + jj + t at the lane's offset for t, eight keys a
      // step; the chunk's last pass reads four keys a step, a key past the
      // chunk's rows with probability 0 from the last row (staged, finite).
      const int nk = min(kWarp, rows - j0);
      if (nk == kWarp) {
#pragma unroll 1
        for (int jj = 0; jj < kWarp; jj += 8) {
          const unsigned char* vb[NU];
#pragma unroll
          for (int j = 0; j < NU; ++j) vb[j] = vc + (j0 + jj) * pitch[j];
#pragma unroll
          for (int t0 = 0; t0 < 8; t0 += 4) {
            float vf[4][NU * kUnit];
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
              for (int j = 0; j < NU; ++j) {
                if (lane + j * kWarp < n_units) {
                  load4(reinterpret_cast<const T*>(
                            vb[j] + (t0 + t) * pitch[j] + voff[j][t0 + t]),
                        vf[t] + j * kUnit);
                } else {
#pragma unroll
                  for (int e = 0; e < kUnit; ++e) vf[t][j * kUnit + e] = 0.f;
                }
              }
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float4 p4 = *reinterpret_cast<const float4*>(
                  my_p + g * kWarp + jj + t0);
              const float pt[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
              for (int t = 0; t < 4; ++t)
#pragma unroll
                for (int e = 0; e < NU * kUnit; ++e)
                  acc[g][e] = fmaf(pt[t], vf[t][e], acc[g][e]);
            }
          }
        }
      } else {
      for (int jj = 0; jj < nk; jj += 4) {
        float vf[4][NU * kUnit];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int r = min(j0 + jj + t, rows - 1);
#pragma unroll
          for (int j = 0; j < NU; ++j) {
            if (lane + j * kWarp < n_units) {
              load4(reinterpret_cast<const T*>(vc + r * pitch[j] +
                                               voff[j][r & 7]),
                    vf[t] + j * kUnit);
            } else {
#pragma unroll
              for (int e = 0; e < kUnit; ++e) vf[t][j * kUnit + e] = 0.f;
            }
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(my_p + g * kWarp + jj);
          const float pt[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int e = 0; e < NU * kUnit; ++e)
              acc[g][e] = fmaf(pt[t], vf[t][e], acc[g][e]);
        }
      }
      }
      __syncwarp();                             // the scratch is free again
    }
    __syncthreads();                            // stage st is free again
    if (i + NS < n) issue(c0 + i + NS, st);
  }

  // Merge the warps' states in warp order through the ring's memory (a
  // warp that saw no key has m = -inf and weighs nothing) into the
  // block's partial.
  float* ms = reinterpret_cast<float*>(ring);   // [n_warps][G]
  float* ls = ms + n_warps * G;                 // [n_warps][G]
  float* as = ls + n_warps * G;                 // [n_warps][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l[g] = warp_sum(l[g]);                      // the warp's keys
    if (lane == 0) {
      ms[warp * G + g] = m[g];
      ls[warp * G + g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const int u = lane + j * kWarp;
      if (u < n_units)
#pragma unroll
        for (int e = 0; e < kUnit; ++e)
          as[((size_t)warp * G + g) * D + u * kUnit + e] =
              acc[g][j * kUnit + e];
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out) + ((size_t)b * p.Hq + qh0) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float M = -INFINITY;
    for (int w = 0; w < n_warps; ++w) M = fmaxf(M, ms[w * G + g]);
    float lsum = 0.f, a = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < n_warps; ++w) {
        const float mw = ms[w * G + g];
        const float wt = mw == -INFINITY ? 0.f : expf(mw - M);
        lsum += ls[w * G + g] * wt;
        a += as[((size_t)w * G + g) * D + d] * wt;
      }
    }
    if (S == 1) {
      store_elem(out + idx, lsum > 0.f ? a / lsum : 0.f);
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
      const int g = idx / D;
      float M = -INFINITY;
      for (int r = 0; r < S; ++r) M = fmaxf(M, ld_cluster(pm + g, r));
      float lsum = 0.f, a = 0.f;
      if (M != -INFINITY) {
        for (int r = 0; r < S; ++r) {
          const float mr = ld_cluster(pm + g, r);
          const float w = mr == -INFINITY ? 0.f : expf(mr - M);
          lsum += ld_cluster(pl + g, r) * w;
          a += ld_cluster(pa + idx, r) * w;
        }
      }
      store_elem(out + idx, lsum > 0.f ? a / lsum : 0.f);
    }
  }
  cluster_sync();                               // rank 0 has read them all
}

template <typename T, int G, int NU>
cudaError_t launch(const CUtensorMap* maps, const Params& a, int blocks,
                   int threads, int smem, cudaStream_t stream) {
  auto kern = gqa_decode_kernel<T, G, NU>;
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
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, kern, maps[0], maps[1], maps[2], maps[3], a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int NU>
cudaError_t dispatch(int G, const CUtensorMap* maps, const Params& a,
                     int blocks, int threads, int smem, cudaStream_t s) {
#define GQ_CASE(g) \
  case g:          \
    return launch<T, g, NU>(maps, a, blocks, threads, smem, s);
  switch (G) {
    GQ_CASE(1) GQ_CASE(2) GQ_CASE(3) GQ_CASE(4)
    GQ_CASE(5) GQ_CASE(6) GQ_CASE(7) GQ_CASE(8)
  }
#undef GQ_CASE
  return cudaErrorInvalidValue;
}

// A (B, H, T_len, D) bf16 cache with D contiguous and the other strides in
// elements, cut in boxes of `rows` rows x `cols` columns: 64 columns
// 128-byte swizzled, or 32 columns 64-byte swizzled; rows past T_len and
// columns past D read as zeros.
bool cache_map(CUtensorMap* m, const void* base, int B, int H, int t_len,
               int D, long long sb, long long sh, long long st, int rows,
               int cols) {
  hopper::EncodeTiled enc = hopper::encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)t_len,
                              (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs: slack to align the ring on a
// swizzle atom, the ring of kStages chunks of K and V (reused afterwards
// for the warps' f32 (m, l, acc) when that is larger), the block's query
// rows in f32, the warps' probability scratch, the block's partial (what
// rank 0 reads) and the ring's mbarriers.
int gqa_decode_smem_bytes(int D, int dtype_bytes, int block_kv, int rows,
                          int num_warps) {
  const int ring = kStages * 2 * tile_bytes(D, dtype_bytes, block_kv);
  const int merge = round_up(num_warps * rows * (D + 2) * 4, 16);
  return kAlign + (ring > merge ? ring : merge) + rows * D * 4 +
         num_warps * rows * kWarp * 4 + partial_bytes(rows, D) + kBarBytes;
}

// dtype: 0 = float32, 1 = bfloat16. k_splits: blocks (a cluster) a row, 1,
// 2, 4 or 8; block_kv a multiple of 16 up to 256 (every
// block of a stage starts on its swizzle atom); num_warps 1-8. Strides
// are k's and v's (the same), in elements, 16-byte multiples, the bases
// 16-byte aligned. Returns a cudaError_t (0 = launched); a bf16 cache a
// tensor map cannot take returns cudaErrorInvalidValue.
int gqa_decode_launch(const void* q, const void* k, const void* v,
                      const int* kv_len, void* out, int B, int Hq, int Hkv,
                      int t_len, int D, long long sb, long long sh,
                      long long st, float scale, int block_kv, int k_splits,
                      int pack_gqa, int num_warps, int dtype, void* stream) {
  const int isz = dtype == 1 ? 2 : 4;
  const bool splits_ok = k_splits == 1 || k_splits == 2 || k_splits == 4 ||
                         k_splits == kMaxSplits;
  if ((dtype != 0 && dtype != 1) || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > kMaxHeadDim || (D * isz) % 16 != 0 || block_kv <= 0 ||
      block_kv > kMaxBlockKv || block_kv % 16 != 0 || !splits_ok ||
      num_warps <= 0 || num_warps > kMaxWarps || t_len <= 0)
    return cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  const int packed = pack_gqa && group > 1 ? 1 : 0;
  const int G = packed ? group : 1;
  if (G > kMaxGroup) return cudaErrorInvalidValue;
  const int smem =
      gqa_decode_smem_bytes(D, isz, block_kv, G, num_warps);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  // bf16: K and V by 64-column boxes, and a row's last 1-32 columns
  // past them by 32-column boxes
  CUtensorMap maps[4] = {};
  const int rem = D * isz % 128;
  if (dtype == 1 &&
      (!cache_map(&maps[0], k, B, Hkv, t_len, D, sb, sh, st, block_kv, 64) ||
       !cache_map(&maps[1], v, B, Hkv, t_len, D, sb, sh, st, block_kv, 64) ||
       (rem > 0 && rem <= 64 &&
        (!cache_map(&maps[2], k, B, Hkv, t_len, D, sb, sh, st, block_kv,
                    32) ||
         !cache_map(&maps[3], v, B, Hkv, t_len, D, sb, sh, st, block_kv,
                    32)))))
    return cudaErrorInvalidValue;
  Params a;
  a.q = q; a.k = k; a.v = v; a.kv_len = kv_len; a.out = out;
  a.sb = sb; a.sh = sh; a.st = st;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.t_len = t_len; a.D = D;
  a.scale = scale;
  a.block_kv = block_kv;
  a.packed = packed;
  a.group = group;
  a.splits = k_splits;
  const int blocks = B * (packed ? Hkv : Hq) * k_splits;
  const int threads = num_warps * kWarp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = D > kWarp * kUnit;
  if (dtype == 0)
    return wide ? dispatch<float, 2>(G, maps, a, blocks, threads, smem, s)
                : dispatch<float, 1>(G, maps, a, blocks, threads, smem, s);
  return wide ? dispatch<bf16, 2>(G, maps, a, blocks, threads, smem, s)
              : dispatch<bf16, 1>(G, maps, a, blocks, threads, smem, s);
}

}  // extern "C"
