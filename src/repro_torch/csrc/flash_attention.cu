// Flash attention forward for Hopper (sm_90a): causal and sliding-window GQA
// attention over (B, H, S, D) operands, with the log-sum-exp of every row,
// behind a plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (`flash_attention`, one pallas_call):
// the dense prefill of `attn_impl="pallas"` and the forward of training.
//
//   q    (B, Hq, Sq, D)    bf16 or f32, any strides with D contiguous
//   k, v (B, Hkv, Skv, D)  q's type, any strides with D contiguous; query
//                          head h reads KV head h / (Hq / Hkv)
//   o    (B, Hq, Sq, D)    q's type, any strides with D contiguous
//   lse  (B, Hq, Sq)       f32, contiguous
//
// Query row i sits at position i + q_offset and sees key j when j < Skv,
// (causal) i + q_offset >= j and (window > 0) i + q_offset - j < window.
// Scores s = q.k * scale and their sums are f32; o = softmax(s) v and
// lse = log(sum exp(s)) per row. A row with no visible key gives o = 0 and
// lse = -1e30, never NaN.
//
// Bound: at the serving prefill (B 8, 24/8 heads of 128, Sq = Skv = 512,
// bf16, causal) bytes: q and o (2 B Hq Sq D 2), k and v (2 B Hkv Skv D 2)
// and the lse, 67.5 MB, take 0.0201 ms at 3.35 TB/s, against 0.0131 ms for
// the 12.9 GFLOP the causal mask admits at 989 TFLOP/s; at 4,096 tokens
// the operations bound it. The bf16 design (flash_fwd_wgmma, the tools in
// hopper.cuh):
//
//   * One block per (batch, query head, q tile of 64 W rows), W
//     warpgroups (1 or 2) of 64 rows each; the q tiles with the most keys
//     are launched first. The TPU grid's sequential kv axis is a loop over
//     the kv tiles of block_kv (64 or 128) keys from the window's first
//     visible tile to the causal last one: tiles no row of the block sees
//     are never loaded, and a warpgroup only waits for and releases the
//     tiles none of its rows sees.
//   * Thread 0 loads the q tile once and keeps a ring of num_stages K and
//     V tiles in flight with TMA (128-byte swizzle): each tile's arrival
//     completes a full mbarrier, every warp's release of a stage an empty
//     one, after which thread 0 loads the stage's next tile. Rows past Sq
//     or Skv and the columns from D to a multiple of 64 are zero-filled by
//     TMA: D 96, 120 and 160 run unpadded in memory. There is no producer
//     warp: ptxas (CUDA 12.8) gives a block with a producer warp or
//     warpgroup beside two consumer warpgroups 168 registers a thread,
//     setmaxnreg notwithstanding, and o, s and P then spilled and
//     serialised the wgmma (measured on the H100, PERF.md); without one
//     each thread may take 255.
//   * s = q.k^T by wgmma.m64n{block_kv}k16 with both operands in shared
//     memory (K-major), f32 in registers; the online softmax (m, l, and the
//     o accumulator, f32) runs on the accumulator fragment, base 2 on the
//     special-function unit; only the tiles that cross the causal
//     diagonal, the window's edge or Skv compute a mask.
//   * o += p.v by wgmma.m64n64k16, one per 64 columns of D, with p the A
//     operand in registers, repacked from s's accumulator, and V in shared
//     memory as an MN-major B (the transpose bit of 16-bit types). P enters
//     as two bf16 terms, its rounding and the remainder (two products a
//     step), so p.v carries 16 bits of P where the TPU kernel's f32 p.v
//     carries 24; a single rounding would carry 8 (PERF.md gives both
//     deviations).
//   * o / l and the lse are written once at the end, from registers.
//
//   Not taken: issuing s of tile t + 1 before p.v of tile t to overlap the
//   softmax with the products (ptxas serialised every wgmma of that loop,
//   "non wgmma instructions reading accumulator registers", and it ran
//   slower), ping-pong scheduling of two warpgroups, and packing the GQA
//   group into one block.
//
// The f32 branch (flash_kernel) keeps its IEEE-FMA design, wgmma having no
// IEEE f32: q and K/V tiles staged with 16-byte cp.async (K and V double
// buffered), each warp 16 or 32 rows in the mma.sync fragment layout, fmaf
// on the CUDA cores (no TF32), so f32 results hold to 1e-4 of the f32
// reference. The wrapper chooses the branch by dtype.

#include <climits>

#include "flash_attention.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB opt-in per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kEmptyLse = -1e30f;  // lse of a row with no visible key

// ------------------------------------------------------------- f32 branch

// Bytes of dynamic shared memory: the q tile and two stages of K and V
// tiles, each row D rounded up to 16 elements plus 16 bytes.
int f32_smem(int D, int bq, int bkv) {
  return (bq + 4 * bkv) * (round16(D) * 4 + 16);
}

// A thread holds rt (16-row tiles a warp owns) x (hd + bkv) / 2 f32
// accumulators of o and s; the kernel is instantiated where they fit 160.
__host__ __device__ constexpr bool f32_regs_fit(int hd, int bkv, int rt) {
  return rt * (hd + bkv) <= 320;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, Hq, Hkv, Sq, Skv, D, dp;  // dp: D rounded up to 16
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  float scale_log2;  // scale * log2(e): scores are kept in base 2
  int causal, window, q_offset, block_q, stages;
};

// HD: D's class (64, 128 or 256: o's column tiles); BKV: keys a tile; RT:
// 16-row tiles a warp owns. block_q = 16 RT warps.
template <int HD, int BKV, int RT>
__global__ void __launch_bounds__(256) flash_kernel(const Args a) {
  using T = float;
  constexpr int NT = BKV / 8;  // 8-key tiles of s
  constexpr int DT = HD / 8;   // 8-column tiles of o
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = a.dp + 16 / static_cast<int>(sizeof(T));  // staged row
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + a.block_q * rs;  // two stages of BKV rows
  T* vs = ks + 2 * BKV * rs;    // two stages of BKV rows

  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.x * a.block_q;
  const int rows = min(a.block_q, a.Sq - q0);
  const T* qg = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh +
                static_cast<long long>(q0) * a.sqs;
  const T* kg = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vg = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;

  // The keys any row of the block sees: the window's first to the causal
  // last; tiles outside are skipped (the TPU kernel's pl.when).
  const int qp0 = q0 + a.q_offset, qp1 = q0 + rows - 1 + a.q_offset;
  const int kv_first = a.window > 0 ? max(0, qp0 - a.window + 1) : 0;
  const int kv_last = a.causal ? min(qp1, a.Skv - 1) : a.Skv - 1;
  const int t_first = kv_first / BKV;
  const int n_tiles = kv_last >= kv_first ? kv_last / BKV - t_first + 1 : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16 * RT;  // the warp's first row in the tile

  float o[RT][DT][4];
  float m[RT][2], l[RT][2];  // running max (base 2) and partial row sums
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][n][e] = 0.f;
    m[r][0] = m[r][1] = -INFINITY;
    l[r][0] = l[r][1] = 0.f;
  }

  if (n_tiles > 0) {
    stage(qs, qg, a.sqs, a.block_q, rows, rs, a.D, a.dp);
    const int kv0 = t_first * BKV;
    stage(ks, kg + kv0 * a.sks, a.sks, BKV, a.Skv - kv0, rs, a.D, a.dp);
    stage(vs, vg + kv0 * a.svs, a.svs, BKV, a.Skv - kv0, rs, a.D, a.dp);
    cp_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = (t_first + it) * BKV;
    if (it + 1 < n_tiles) {
      const int nx = kv0 + BKV, st = (it + 1) & 1;
      stage(ks + st * BKV * rs, kg + nx * a.sks, a.sks, BKV, a.Skv - nx, rs,
            a.D, a.dp);
      stage(vs + st * BKV * rs, vg + nx * a.svs, a.svs, BKV, a.Skv - nx, rs,
            a.D, a.dp);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* kst = ks + (it & 1) * BKV * rs;
    const T* vst = vs + (it & 1) * BKV * rs;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row0 = q0 + wrow + r * 16;  // first row of these 16
      if (row0 >= a.Sq) continue;
      const int p0 = row0 + a.q_offset;
      const int p1 = min(row0 + 15, a.Sq - 1) + a.q_offset;
      if ((a.causal && p1 < kv0) ||
          (a.window > 0 && p0 - a.window + 1 > kv0 + BKV - 1))
        continue;  // no key of this tile is visible to these rows
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      qk<NT>(s, qs + (wrow + r * 16) * rs, kst, rs, a.dp, lane);

      // every key of the tile visible to every row: no mask to apply
      const bool inside = kv0 + BKV <= a.Skv &&
                          (!a.causal || kv0 + BKV - 1 <= p0) &&
                          (a.window <= 0 || p1 - kv0 < a.window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kv = kv0 + j * 8 + 2 * t + (e & 1);
          const int qp = p0 + g + (e >> 1) * 8;
          const bool vis = inside ||
                           (kv < a.Skv && (!a.causal || qp >= kv) &&
                            (a.window <= 0 || qp - kv < a.window));
          s[j][e] = vis ? s[j][e] * a.scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float mu[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[r][i], quad_max(mx[i]));
        mu[i] = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
        alpha[i] = exp2f(m[r][i] - mu[i]);
        m[r][i] = m_new;
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - mu[e >> 1]);  // masked: exp2(-inf) = 0
          ls[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[r][i] = l[r][i] * alpha[i] + ls[i];
#pragma unroll
      for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][n][e] *= alpha[e >> 1];
      pv<NT, DT>(o[r], s, vst, rs, a.dp, lane);
    }
    __syncthreads();  // the stage is overwritten by the next copies
  }

  T* og = static_cast<T*>(a.o) + b * a.sob + h * a.soh;
  float* lse = a.lse + (static_cast<long long>(b) * a.Hq + h) * a.Sq;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float sum = quad_sum(l[r][i]);
      const int row = q0 + wrow + r * 16 + g + i * 8;
      if (row >= a.Sq) continue;
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      T* orow = og + static_cast<long long>(row) * a.sos;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < a.D)
          store2(orow + col, o[r][n][2 * i] * inv, o[r][n][2 * i + 1] * inv);
      }
      if (t == 0)
        lse[row] = sum > 0.f ? m[r][i] * kLn2 + logf(sum) : kEmptyLse;
    }
}

template <int HD, int BKV, int RT>
cudaError_t launch_f32(const Args& a, int warps, int smem,
                       cudaStream_t stream) {
  if constexpr (!f32_regs_fit(HD, BKV, RT)) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = flash_kernel<HD, BKV, RT>;
    static int configured = 48 * 1024;
    if (smem > configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      configured = smem;
    }
    const dim3 grid((a.Sq + a.block_q - 1) / a.block_q, a.B * a.Hq);
    kern<<<grid, warps * 32, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

template <int HD, int BKV>
cudaError_t f32_by_rt(int rt, const Args& a, int warps, int smem,
                      cudaStream_t s) {
  if (rt == 1) return launch_f32<HD, BKV, 1>(a, warps, smem, s);
  if (rt == 2) return launch_f32<HD, BKV, 2>(a, warps, smem, s);
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t f32_by_bkv(int bkv, int rt, const Args& a, int warps, int smem,
                       cudaStream_t s) {
  if (bkv == 32) return f32_by_rt<HD, 32>(rt, a, warps, smem, s);
  if (bkv == 64) return f32_by_rt<HD, 64>(rt, a, warps, smem, s);
  if (bkv == 128) return f32_by_rt<HD, 128>(rt, a, warps, smem, s);
  if (bkv == 256) return f32_by_rt<HD, 256>(rt, a, warps, smem, s);
  return cudaErrorInvalidValue;
}

cudaError_t run_f32(int bkv, int rt, const Args& a, int warps, int smem,
                    cudaStream_t s) {
  if (a.D <= 64) return f32_by_bkv<64>(bkv, rt, a, warps, smem, s);
  if (a.D <= 128) return f32_by_bkv<128>(bkv, rt, a, warps, smem, s);
  if (a.D <= 256) return f32_by_bkv<256>(bkv, rt, a, warps, smem, s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ bf16 branch

// Shared memory of the bf16 kernel: 1024 bytes of alignment slack, 256 of
// mbarriers, the q tile and num_stages K and V tiles, each as ceil(D/64)
// column blocks of 128-byte rows.
int bf16_smem(int D, int bq, int bkv, int stages) {
  const int nb = (D + 63) / 64;
  return 1024 + 256 + nb * 128 * (bq + 2 * stages * bkv);
}

// A thread holds 32 NB f32 accumulators of o, block_kv / 2 of s
// and block_kv / 2 registers of P's two bf16 terms.
__host__ __device__ constexpr bool bf16_regs_fit(int nb, int bkv) {
  return 32 * nb + bkv <= 192;
}

// NB: 64-column blocks of D; BKV: keys a tile; W: warpgroups (64
// rows each).
template <int NB, int BKV, int W>
__global__ void __launch_bounds__(128 * W, W == 1 ? 2 : 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a) {
  using namespace hopper;
  constexpr int BQ = 64 * W;
  constexpr int QBYTES = NB * BQ * 128;   // the q tile
  constexpr int KBYTES = NB * BKV * 128;  // one stage of K (or of V)
  constexpr int NS = BKV / 2;             // s accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ks = qs + QBYTES;
  unsigned char* vs = ks + a.stages * KBYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + a.stages * KBYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + a.stages;
  uint64_t* empty = v_full + a.stages;

  // x: batch and head; y: q tiles, the last (the most keys under a causal
  // mask) launched first
  const int b = blockIdx.x / a.Hq, h = blockIdx.x % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int rows = min(BQ, a.Sq - q0);
  const int qp0 = q0 + a.q_offset, qp1 = q0 + rows - 1 + a.q_offset;
  const int kv_first = a.window > 0 ? max(0, qp0 - a.window + 1) : 0;
  const int kv_last = a.causal ? min(qp1, a.Skv - 1) : a.Skv - 1;
  const int t_first = kv_first / BKV;
  const int n_tiles = kv_last >= kv_first ? kv_last / BKV - t_first + 1 : 0;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    mbar_init(q_full, 1);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 4 * W);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 issues every load: the q tile and the first num_stages K/V
  // tiles here, tile it + num_stages once every warp has released tile it
  // (release below).
  auto load = [&](int it) {
    const int s = it % a.stages, ph = (it / a.stages) & 1;
    const int kv0 = (t_first + it) * BKV;
    mbar_wait(empty + s, ph ^ 1);
    mbar_expect_tx(k_full + s, KBYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int r = 0; r < BKV / 64; ++r)
        tma_tile(ks + s * KBYTES + c * BKV * 128 + r * 8192, &tk, c * 64,
                 kv0 + 64 * r, hk, b, k_full + s);
    mbar_expect_tx(v_full + s, KBYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int r = 0; r < BKV / 64; ++r)
        tma_tile(vs + s * KBYTES + c * BKV * 128 + r * 8192, &tv, c * 64,
                 kv0 + 64 * r, hk, b, v_full + s);
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(q_full, QBYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int r = 0; r < W; ++r)
        tma_tile(qs + c * BQ * 128 + r * 8192, &tq, c * 64, q0 + 64 * r, h,
                 b, q_full);
    for (int it = 0; it < min(a.stages, n_tiles); ++it) load(it);
  }
  __syncwarp();

  // warpgroup wg: rows q0 + 64 wg .. + 63
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = 64 * wg + 16 * warp;  // the warp's first row
  const int p0 = q0 + wrow + a.q_offset;  // its position
  const int p1 = min(q0 + wrow + 15, a.Sq - 1) + a.q_offset;
  const uint32_t q_base = smem_u32(qs) + wg * 8192;
  // The warpgroup's own tiles, w_first to w_last of the block's: it waits
  // for the others and releases them untouched.
  int w_first = n_tiles, w_last = -1;
  if (q0 + 64 * wg < a.Sq) {
    const int wp0 = q0 + 64 * wg + a.q_offset;
    const int wp1 = min(q0 + 64 * wg + 63, a.Sq - 1) + a.q_offset;
    const int f = a.window > 0 ? max(0, wp0 - a.window + 1) : 0;
    const int e = a.causal ? min(wp1, a.Skv - 1) : a.Skv - 1;
    if (e >= f) {
      w_first = f / BKV - t_first;
      w_last = e / BKV - t_first;
    }
  }

  float o[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float sacc[NS];                                 // s, then p
  uint32_t phi[BKV / 16][4], plo[BKV / 16][4];  // P's A fragments

  auto release = [&](int it) {  // tile it's K and V are read no more
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + it % a.stages);
    if (threadIdx.x == 0 && it + a.stages < n_tiles) load(it + a.stages);
    __syncwarp();
  };
  auto pass = [&](int it) {  // a tile none of the warpgroup's rows sees
    mbar_wait(k_full + it % a.stages, (it / a.stages) & 1);
    mbar_wait(v_full + it % a.stages, (it / a.stages) & 1);
    release(it);
  };
  // s = q.k^T of tile it, issued and committed
  auto issue_s = [&](int it) {
    mbar_wait(k_full + it % a.stages, (it / a.stages) & 1);
    const uint32_t k_base = smem_u32(ks + (it % a.stages) * KBYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      wgmma_ss<BKV>(
          sacc, desc_kmajor(q_base + (kk / 4) * BQ * 128 + (kk % 4) * 32),
          desc_kmajor(k_base + (kk / 4) * BKV * 128 + (kk % 4) * 32), kk > 0);
    wgmma_commit();
  };
  // The online softmax of tile it's finished s, base 2: the mask only where
  // the tile crosses the diagonal, the window's edge or Skv; p in place of
  // s; l; alpha, o's rescale.
  auto softmax = [&](int it, float (&alpha)[2]) {
    fence_acc(sacc);
    const int kv0 = (t_first + it) * BKV;
    const bool inside = kv0 + BKV <= a.Skv &&
                        (!a.causal || kv0 + BKV - 1 <= p0) &&
                        (a.window <= 0 || p1 - kv0 < a.window);
    float mx[2] = {-INFINITY, -INFINITY};
    // The keys row r sees, as offsets from the thread's first column
    // kv0 + 2t: element i sits at offset 8 (i / 4) + (i & 1).
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = p0 + g + 8 * r;
      hi[r] = (a.causal ? min(qp, a.Skv - 1) : a.Skv - 1) - (kv0 + 2 * t);
      lo[r] = a.window > 0 ? qp - a.window + 1 - (kv0 + 2 * t) : INT_MIN;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int e = i & 3, off = (i >> 2) * 8 + (e & 1);
      if (!inside && (off < lo[e >> 1] || off > hi[e >> 1]))
        sacc[i] = -INFINITY;  // masked
      sacc[i] *= a.scale_log2;
      mx[e >> 1] = fmaxf(mx[e >> 1], sacc[i]);
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
      alpha[r] = fast_exp2(m[r] - mu[r]);
      m[r] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      sacc[i] = fast_exp2(sacc[i] - mu[r]);  // masked: 2^-inf = 0
      ls[r] += sacc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
  };
  auto pack = [&] { split_frags<BKV>(sacc, phi, plo); };  // P's two terms
  // o += p.v of tile it, issued and committed
  auto issue_pv = [&](int it) {
    mbar_wait(v_full + it % a.stages, (it / a.stages) & 1);
    const uint32_t v_base = smem_u32(vs + (it % a.stages) * KBYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const uint64_t dv = desc_mnmajor(v_base + c * BKV * 128 + kk * 2048);
        wgmma_rs64(o[c], phi[kk], dv);
        wgmma_rs64(o[c], plo[kk], dv);
      }
    wgmma_commit();
  };
  auto finish_pv = [&](int it) {
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NB; ++c) fence_acc(o[c]);
    release(it);
  };

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int it = 0; it < w_first; ++it) pass(it);
  if (w_first <= w_last) {
    float alpha[2];
    issue_s(w_first);
    wgmma_wait<0>();
    softmax(w_first, alpha);  // o is still 0: nothing to rescale
    pack();
    for (int it = w_first; it <= w_last; ++it) {
      issue_pv(it);
      finish_pv(it);
      if (it < w_last) {
        issue_s(it + 1);
        wgmma_wait<0>();
        softmax(it + 1, alpha);
        rescale(alpha);
        pack();
      }
    }
  }
  for (int it = max(w_last + 1, w_first); it < n_tiles; ++it) pass(it);

  bf16* og = static_cast<bf16*>(a.o) + b * a.sob + h * a.soh;
  float* lse = a.lse + (static_cast<long long>(b) * a.Hq + h) * a.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = q0 + wrow + g + 8 * r;
    if (row >= a.Sq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    bf16* orow = og + static_cast<long long>(row) * a.sos;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + j * 8 + 2 * t;
        if (col < a.D)
          store2(orow + col, o[c][4 * j + 2 * r] * inv,
                 o[c][4 * j + 2 * r + 1] * inv);
      }
    if (t == 0) lse[row] = sum > 0.f ? m[r] * kLn2 + logf(sum) : kEmptyLse;
  }
}

template <int NB, int BKV, int W>
cudaError_t launch_bf16(const CUtensorMap* maps, const Args& a, int smem,
                        cudaStream_t stream) {
  if constexpr (!bf16_regs_fit(NB, BKV)) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = flash_fwd_wgmma<NB, BKV, W>;
    static int configured = 48 * 1024;
    if (smem > configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      configured = smem;
    }
    const dim3 grid(a.B * a.Hq, (a.Sq + 64 * W - 1) / (64 * W));
    kern<<<grid, 128 * W, smem, stream>>>(maps[0], maps[1], maps[2],
                                                a);
    return cudaGetLastError();
  }
}

template <int NB, int BKV>
cudaError_t bf16_by_w(int w, const CUtensorMap* maps, const Args& a,
                      int smem, cudaStream_t s) {
  if (w == 1) return launch_bf16<NB, BKV, 1>(maps, a, smem, s);
  if (w == 2) return launch_bf16<NB, BKV, 2>(maps, a, smem, s);
  return cudaErrorInvalidValue;
}

template <int NB>
cudaError_t bf16_by_bkv(int bkv, int w, const CUtensorMap* maps,
                        const Args& a, int smem, cudaStream_t s) {
  if (bkv == 64) return bf16_by_w<NB, 64>(w, maps, a, smem, s);
  if (bkv == 128) return bf16_by_w<NB, 128>(w, maps, a, smem, s);
  return cudaErrorInvalidValue;
}

cudaError_t run_bf16(int bkv, int w, const CUtensorMap* maps, const Args& a,
                     int smem, cudaStream_t s) {
  switch ((a.D + 63) / 64) {
    case 1: return bf16_by_bkv<1>(bkv, w, maps, a, smem, s);
    case 2: return bf16_by_bkv<2>(bkv, w, maps, a, smem, s);
    case 3: return bf16_by_bkv<3>(bkv, w, maps, a, smem, s);
    case 4: return bf16_by_bkv<4>(bkv, w, maps, a, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (itemsize 2: the bf16 kernel with
// num_stages K/V stages; 4: the f32 kernel, two stages).
int flash_attention_smem_bytes(int D, int itemsize, int block_q,
                               int block_kv, int num_stages) {
  return itemsize == 2 ? bf16_smem(D, block_q, block_kv, num_stages)
                       : f32_smem(D, block_q, block_kv);
}

// dtype 0 = f32, 1 = bf16; D <= 256 with rows of 16-byte multiples; strides
// in elements, 16-byte multiples, bases 16-byte aligned; window <= 0 is
// none.
//   f32:  block_q = 16 x rt x num_warps with rt 1 or 2 and num_warps 1-8;
//         block_kv in {32, 64, 128, 256}; num_stages 2.
//   bf16: block_q = 64 x W (W = 1 or 2 warpgroups, num_warps =
//         4 W); block_kv 64 or 128; num_stages 2-4.
// Returns a cudaError_t (0 = launched); a combination the kernels do not
// instantiate (accumulators past the registers) or a tensor map TMA
// refuses returns cudaErrorInvalidValue.
int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sob,
    long long soh, long long sos, float scale, int causal, int window,
    int q_offset, int block_q, int block_kv, int num_warps, int num_stages,
    int dtype, void* stream) {
  const int isz = dtype == 1 ? 2 : 4;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || D <= 0 || D > 256 || (D * isz) % 16 != 0 ||
      B * Hq > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int smem =
      flash_attention_smem_bytes(D, isz, block_q, block_kv, num_stages);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const Args a{q,   k,   v,   o,   lse, B,   Hq,  Hkv, Sq,  Skv,
               D,   round16(D),   sqb, sqh, sqs, skb, skh, sks, svb,
               svh, svs, sob, soh, sos, scale * kLog2e,   causal,
               window,   q_offset,  block_q, num_stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (num_warps < 1 || num_warps > 8 || block_q % (16 * num_warps) != 0 ||
        num_stages != 2)
      return cudaErrorInvalidValue;
    return run_f32(block_kv, block_q / (16 * num_warps), a, num_warps, smem,
                   s);
  }
  if ((block_q != 64 && block_q != 128) || num_warps != block_q / 16 ||
      num_stages < 2 || num_stages > 4)
    return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  if (!hopper::tile_map(&maps[0], q, B, Hq, Sq, D, sqb, sqh, sqs) ||
      !hopper::tile_map(&maps[1], k, B, Hkv, Skv, D, skb, skh, sks) ||
      !hopper::tile_map(&maps[2], v, B, Hkv, Skv, D, svb, svh, svs))
    return cudaErrorInvalidValue;
  return run_bf16(block_kv, block_q / 64, maps, a, smem, s);
}

}  // extern "C"
