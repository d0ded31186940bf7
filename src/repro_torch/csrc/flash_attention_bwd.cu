// Flash attention backward for Hopper (sm_90a): the gradients dq, dk and dv
// of causal and sliding-window GQA attention over (B, H, S, D) operands,
// recomputed from the forward's log-sum-exp, behind a plain C interface.
//
// Replaces the TPU kernels `_dkv_kernel` and `_dq_kernel` of
// src/repro/kernels/flash_attention_bwd.py (`flash_attention_bwd`, two
// pallas_calls): the backward of `attn_impl="pallas"` in training.
//
//   q, do      (B, Hq, Sq, D)   bf16 or f32, any strides with D contiguous
//   k, v       (B, Hkv, Skv, D) q's type, any strides with D contiguous;
//                               query head h reads KV head h / (Hq / Hkv)
//   lse, delta (B, Hq, Sq)      f32, rows sl >= Sq apart (sl a multiple of
//                               4), the forward's lse and rowsum(do * o),
//                               computed by the caller
//   dq         (B, Hq, Sq, D)   q's type, any strides with D contiguous
//   dk, dv     (B, Hkv, Skv, D) k's type, any strides with D contiguous
//
// Query row i sits at position i + q_offset and sees key j when j < Skv,
// (causal) i + q_offset >= j and (window > 0) i + q_offset - j < window, the
// forward's mask. Over the visible pairs p = exp(s - lse) with s = q.k *
// scale, ds = p (do.v - delta) scale; dv = sum p do and dk = sum ds q over
// the rows (and the G query heads of the group), dq = sum ds k over the
// keys. The mask is applied before the exp: a pair that is not visible
// gives p = 0 whatever lse holds, so a row that sees no key (lse -1e30
// from the forward) has dq = 0 and adds nothing to dk and dv.
//
// Bound: at the training shape (B 4, 24/8 heads of 128, Sq = Skv = 512,
// bf16, causal) the least work is 5 products of 2 D operations a visible
// pair and query head (s, dp, dv, dk, dq): 16.1 GFLOP, 0.0163 ms at 989
// TFLOP/s, against 52.9 MB (q, k, v, do, lse and delta read once, dq, dk
// and dv written once), 0.0158 ms at 3.35 TB/s; at 4,096 tokens the
// operations bound it. The design keeps the reference's two-kernel
// recompute split, atomic-free, so a run is deterministic. bf16 (dkv_wgmma
// and dq_wgmma, the tools in hopper.cuh):
//
//   * Both kernels: W warpgroups (1 or 2) of 64 rows of their own tile
//     each; thread 0 keeps a ring of num_stages tiles in flight with TMA
//     (128-byte swizzle) on full/empty mbarriers, loading a stage's next
//     tile once every warp has released it (no producer warp: ptxas would
//     then hold every thread to 168 registers, see flash_attention.cu).
//     Rows past Sq or Skv and the columns from D to a multiple of 64 are
//     zero-filled by TMA. The tiles with the most work are launched first.
//   * dkv: one block per (batch, kv head, 64 W keys). K and V are loaded
//     once; the ring streams the q and do tiles of block_q rows of the G
//     query heads x q tiles that see the block's keys, with their lse and
//     delta (2-D TMA over rows padded to 16 bytes by the wrapper). s^T =
//     k.q^T and dp^T = v.do^T by wgmma.m64n{block_q}k16 from shared memory
//     (K-major); p^T and ds^T are formed on the accumulator fragment; dv
//     += p^T.do, then dk += ds^T.q, by wgmma.m64n64k16, one per 64 columns
//     of D, A from registers (repacked from the accumulators) and B
//     MN-major from shared memory, one product group each so their
//     fragments are never live together. dk and dv stay in f32 registers
//     across the group and are written once.
//   * dq: one block per (batch, query head, 64 W rows), the forward's
//     layout: q and do loaded once, lse and delta read into registers, the
//     ring streams K and V tiles of block_kv keys; s = q.k^T and dp =
//     do.v^T from shared memory, ds in registers, dq += ds.k with K as an
//     MN-major B, a product group a bf16 term of ds; dq is written once.
//   * Only tiles that cross the causal diagonal, the window's edge or a
//     sequence's end compute the mask; a warpgroup skips the tiles none of
//     its rows (keys) meets.
//   * p and ds enter their products as two bf16 terms (the rounding and the
//     remainder), as P does in the forward, so they carry 16 bits where a
//     single rounding would carry 8 (PERF.md gives both deviations).
//
// s and dp are still computed in both kernels: 7 products where 5 would do
// (one kernel that also accumulates dq would need atomics or a reduction).
//
// The f32 branch (dkv_kernel and dq_kernel) keeps its IEEE-FMA design,
// wgmma having no IEEE f32: the same split with cp.async double buffering,
// each warp 16 or 32 rows (keys) in the mma.sync fragment layout, fmaf on
// the CUDA cores (no TF32), so f32 gradients hold to 1e-4 of the f32
// reference. The wrapper chooses the branch by dtype.

#include <climits>

#include "flash_attention.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB opt-in per block
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------- f32 branch

// Bytes of a staged row: D rounded up to 16 elements, plus 16 bytes.
int row_bytes(int D, int isz) { return round16(D) * isz + 16; }

// Dynamic shared memory of the dkv kernel (K and V tiles, two stages of q
// and do tiles and of their lse and delta) and of the dq kernel (q and do
// tiles with their lse and delta, two stages of K and V tiles).
int dkv_smem(int D, int isz, int bq, int bkv) {
  return (2 * bkv + 4 * bq) * row_bytes(D, isz) + 4 * bq * 4;
}

int dq_smem(int D, int isz, int bq, int bkv) {
  return (2 * bq + 4 * bkv) * row_bytes(D, isz) + 2 * bq * 4;
}

// f32 accumulators a thread holds: dkv rt x hd (dk and dv, hd / 2 each)
// plus bi (s and dp of one 16-key tile against bi q rows); dq rt x hd / 2
// plus bi (s and dp of one 16-row tile against bi keys).
__host__ __device__ constexpr bool dkv_regs_fit(int hd, int bi, int rt) {
  return rt * hd + bi <= 192;
}

__host__ __device__ constexpr bool dq_regs_fit(int hd, int bi, int rt) {
  return rt * hd / 2 + bi <= 160;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, Hq, Hkv, Sq, Skv, D, dp;  // dp: D rounded up to 16
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sdb, sdh, sds;
  long long sgqb, sgqh, sgqs, sgkb, sgkh, sgks, sgvb, sgvh, sgvs;
  long long sl;  // lse's and delta's row stride (Sq up to a multiple of 4)
  float scale;
  float scale_log2;  // scale * log2(e): exponents are taken in base 2
  int causal, window, q_offset, block_q, block_kv, stages;
};

// 4 bytes global -> shared; `bytes` 4 or 0 (0 zero-fills, reads nothing).
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// `rows` f32 values of a (B, Hq, Sq) row from `src`, zeros from `valid` on.
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int rows, int valid) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    cp4(dst + i, i < valid ? src + i : src, i < valid ? 4 : 0);
}

__device__ __forceinline__ bool visible(int qi, int kv, const Args& a) {
  const int qp = qi + a.q_offset;
  return qi < a.Sq && kv < a.Skv && (!a.causal || qp >= kv) &&
         (a.window <= 0 || qp - kv < a.window);
}

// Write a warp's 16 x D f32 accumulator rows row0 + g and + 8 (rows from
// `limit` on are not written) to `out` at row stride `ss`.
template <typename T, int DT>
__device__ __forceinline__ void write_rows(T* out, long long ss,
                                           const float (&acc)[DT][4],
                                           int row0, int limit, int D,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + i * 8;
    if (row >= limit) continue;
    T* orow = out + static_cast<long long>(row) * ss;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D) store2(orow + col, acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

// HD: D's class (64 or 128: the accumulators' column tiles); BQ: q rows a
// tile; RT: 16-key tiles a warp owns. block_kv = 16 RT warps.
template <typename T, int HD, int BQ, int RT>
__global__ void __launch_bounds__(256) dkv_kernel(const Args a) {
  constexpr int NT = BQ / 8;  // 8-row q tiles: the columns of s^T
  constexpr int DT = HD / 8;  // 8-column tiles of dk and dv
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = a.dp + 16 / static_cast<int>(sizeof(T));  // staged row
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + a.block_kv * rs;
  T* qs = vs + a.block_kv * rs;  // two stages of BQ rows
  T* ds = qs + 2 * BQ * rs;      // two stages of BQ rows of do
  float* lses = reinterpret_cast<float*>(ds + 2 * BQ * rs);  // two stages
  float* dels = lses + 2 * BQ;                               // two stages

  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int kv0 = blockIdx.x * a.block_kv;
  const int kv1 = min(kv0 + a.block_kv, a.Skv) - 1;
  // The q rows that see any key of the tile, for each head of the group;
  // tiles outside are skipped (the TPU kernel's pl.when).
  const int i_first = a.causal ? max(0, kv0 - a.q_offset) : 0;
  const int i_last = a.window > 0
                         ? min(a.Sq - 1, kv1 + a.window - 1 - a.q_offset)
                         : a.Sq - 1;
  const int t_first = i_first / BQ;
  const int n_qt = i_last >= i_first ? i_last / BQ - t_first + 1 : 0;
  const int n_it = G * n_qt;

  const T* kg = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vg = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;
  auto stage_q = [&](int it, int st) {
    const int h = hk * G + it / n_qt;
    const int q0 = (t_first + it % n_qt) * BQ;
    stage(qs + st * BQ * rs,
          static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh +
              static_cast<long long>(q0) * a.sqs,
          a.sqs, BQ, a.Sq - q0, rs, a.D, a.dp);
    stage(ds + st * BQ * rs,
          static_cast<const T*>(a.dout) + b * a.sdb + h * a.sdh +
              static_cast<long long>(q0) * a.sds,
          a.sds, BQ, a.Sq - q0, rs, a.D, a.dp);
    const long long row = (static_cast<long long>(b) * a.Hq + h) * a.sl + q0;
    stage_f32(lses + st * BQ, a.lse + row, BQ, a.Sq - q0);
    stage_f32(dels + st * BQ, a.delta + row, BQ, a.Sq - q0);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16 * RT;  // the warp's first key in the tile

  float dk[RT][DT][4], dv[RT][DT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[r][n][e] = dv[r][n][e] = 0.f;

  if (n_it > 0) {
    stage(ks, kg + kv0 * a.sks, a.sks, a.block_kv, a.Skv - kv0, rs, a.D,
          a.dp);
    stage(vs, vg + kv0 * a.svs, a.svs, a.block_kv, a.Skv - kv0, rs, a.D,
          a.dp);
    stage_q(0, 0);
    cp_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      stage_q(it + 1, (it + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
    const T* qst = qs + st * BQ * rs;
    const T* dst = ds + st * BQ * rs;
    const float* lst = lses + st * BQ;
    const float* dlt = dels + st * BQ;
    const int q0 = (t_first + it % n_qt) * BQ;
    const int qp0 = q0 + a.q_offset;
    const int qp1 = min(q0 + BQ, a.Sq) - 1 + a.q_offset;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int k0 = kv0 + wrow + r * 16;  // first key of these 16
      if (k0 >= a.Skv) continue;
      const int k1 = min(k0 + 15, a.Skv - 1);
      if ((a.causal && qp1 < k0) || (a.window > 0 && qp0 - k1 >= a.window))
        continue;  // no row of this tile sees these keys
      float s[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dpt[j][e] = 0.f;
      qk<NT>(s, ks + (wrow + r * 16) * rs, qst, rs, a.dp, lane);
      qk<NT>(dpt, vs + (wrow + r * 16) * rs, dst, rs, a.dp, lane);
      // p^T in s, ds^T in dpt: key k0 + g (+ 8), q row q0 + 8j + 2t (+ 1)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          const float p =
              visible(q0 + c, k0 + g + (e >> 1) * 8, a)
                  ? exp2f(s[j][e] * a.scale_log2 - lst[c] * kLog2e)
                  : 0.f;
          s[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dlt[c]) * a.scale;
        }
      pv<NT, DT>(dv[r], s, dst, rs, a.dp, lane);
      pv<NT, DT>(dk[r], dpt, qst, rs, a.dp, lane);
    }
    __syncthreads();  // the stage is overwritten by the next copies
  }

  T* dkg = static_cast<T*>(a.dk) + b * a.sgkb + hk * a.sgkh;
  T* dvg = static_cast<T*>(a.dv) + b * a.sgvb + hk * a.sgvh;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int k0 = kv0 + wrow + r * 16;
    write_rows<T, DT>(dkg, a.sgks, dk[r], k0, kv1 + 1, a.D, lane);
    write_rows<T, DT>(dvg, a.sgvs, dv[r], k0, kv1 + 1, a.D, lane);
  }
}

// HD: D's class; BKV: keys a tile; RT: 16-row tiles a warp owns. block_q =
// 16 RT warps.
template <typename T, int HD, int BKV, int RT>
__global__ void __launch_bounds__(256) dq_kernel(const Args a) {
  constexpr int NT = BKV / 8;  // 8-key tiles of s
  constexpr int DT = HD / 8;   // 8-column tiles of dq
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = a.dp + 16 / static_cast<int>(sizeof(T));
  T* qs = reinterpret_cast<T*>(smem);
  T* ds = qs + a.block_q * rs;   // do rows
  T* ks = ds + a.block_q * rs;   // two stages of BKV rows
  T* vs = ks + 2 * BKV * rs;     // two stages of BKV rows
  float* lses = reinterpret_cast<float*>(vs + 2 * BKV * rs);
  float* dels = lses + a.block_q;

  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.x * a.block_q;
  const int rows = min(a.block_q, a.Sq - q0);
  const T* kg = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vg = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;

  // The keys any row of the block sees, as in the forward.
  const int qp0 = q0 + a.q_offset, qp1 = q0 + rows - 1 + a.q_offset;
  const int kv_first = a.window > 0 ? max(0, qp0 - a.window + 1) : 0;
  const int kv_last = a.causal ? min(qp1, a.Skv - 1) : a.Skv - 1;
  const int t_first = kv_first / BKV;
  const int n_tiles = kv_last >= kv_first ? kv_last / BKV - t_first + 1 : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16 * RT;

  float dq[RT][DT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[r][n][e] = 0.f;

  if (n_tiles > 0) {
    const long long row = (static_cast<long long>(b) * a.Hq + h) * a.sl + q0;
    stage(qs,
          static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh +
              static_cast<long long>(q0) * a.sqs,
          a.sqs, a.block_q, rows, rs, a.D, a.dp);
    stage(ds,
          static_cast<const T*>(a.dout) + b * a.sdb + h * a.sdh +
              static_cast<long long>(q0) * a.sds,
          a.sds, a.block_q, rows, rs, a.D, a.dp);
    stage_f32(lses, a.lse + row, a.block_q, rows);
    stage_f32(dels, a.delta + row, a.block_q, rows);
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
      float s[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dpt[j][e] = 0.f;
      const int lr = wrow + r * 16;  // the rows' index in the block
      qk<NT>(s, qs + lr * rs, kst, rs, a.dp, lane);
      qk<NT>(dpt, ds + lr * rs, vst, rs, a.dp, lane);
      // ds in dpt: row row0 + g (+ 8), key kv0 + 8j + 2t (+ 1)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = lr + g + (e >> 1) * 8;
          const float p =
              visible(q0 + c, kv0 + j * 8 + 2 * t + (e & 1), a)
                  ? exp2f(s[j][e] * a.scale_log2 - lses[c] * kLog2e)
                  : 0.f;
          dpt[j][e] = p * (dpt[j][e] - dels[c]) * a.scale;
        }
      pv<NT, DT>(dq[r], dpt, kst, rs, a.dp, lane);
    }
    __syncthreads();  // the stage is overwritten by the next copies
  }

  T* dqg = static_cast<T*>(a.dq) + b * a.sgqb + h * a.sgqh;
#pragma unroll
  for (int r = 0; r < RT; ++r)
    write_rows<T, DT>(dqg, a.sgqs, dq[r], q0 + wrow + r * 16, a.Sq, a.D,
                      lane);
}

template <typename Kern>
cudaError_t launch(Kern kern, dim3 grid, int warps, int smem,
                   cudaStream_t stream, const Args& a) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD, int BQ, int RT>
cudaError_t launch_dkv(const Args& a, int warps, cudaStream_t s) {
  if constexpr (!dkv_regs_fit(HD, BQ, RT)) {
    return cudaErrorInvalidValue;
  } else {
    const dim3 grid((a.Skv + a.block_kv - 1) / a.block_kv, a.B * a.Hkv);
    return launch(dkv_kernel<float, HD, BQ, RT>, grid, warps,
                  dkv_smem(a.D, 4, BQ, a.block_kv), s, a);
  }
}

template <int HD, int BKV, int RT>
cudaError_t launch_dq(const Args& a, int warps, cudaStream_t s) {
  if constexpr (!dq_regs_fit(HD, BKV, RT)) {
    return cudaErrorInvalidValue;
  } else {
    const dim3 grid((a.Sq + a.block_q - 1) / a.block_q, a.B * a.Hq);
    return launch(dq_kernel<float, HD, BKV, RT>, grid, warps,
                  dq_smem(a.D, 4, a.block_q, BKV), s, a);
  }
}

// The dkv kernel's inner tile is block_q, its warps' rows block_kv; the dq
// kernel's the other way round.
template <int HD, int RT>
cudaError_t dkv_by_bq(int bq, const Args& a, int warps, cudaStream_t s) {
  if (bq == 16) return launch_dkv<HD, 16, RT>(a, warps, s);
  if (bq == 32) return launch_dkv<HD, 32, RT>(a, warps, s);
  if (bq == 64) return launch_dkv<HD, 64, RT>(a, warps, s);
  if (bq == 128) return launch_dkv<HD, 128, RT>(a, warps, s);
  return cudaErrorInvalidValue;
}

template <int HD, int RT>
cudaError_t dq_by_bkv(int bkv, const Args& a, int warps, cudaStream_t s) {
  if (bkv == 16) return launch_dq<HD, 16, RT>(a, warps, s);
  if (bkv == 32) return launch_dq<HD, 32, RT>(a, warps, s);
  if (bkv == 64) return launch_dq<HD, 64, RT>(a, warps, s);
  if (bkv == 128) return launch_dq<HD, 128, RT>(a, warps, s);
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t run_f32_hd(const Args& a, int warps, cudaStream_t s) {
  const int rt_kv = a.block_kv / (16 * warps);
  const int rt_q = a.block_q / (16 * warps);
  cudaError_t e = rt_kv == 1   ? dkv_by_bq<HD, 1>(a.block_q, a, warps, s)
                  : rt_kv == 2 ? dkv_by_bq<HD, 2>(a.block_q, a, warps, s)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  return rt_q == 1   ? dq_by_bkv<HD, 1>(a.block_kv, a, warps, s)
         : rt_q == 2 ? dq_by_bkv<HD, 2>(a.block_kv, a, warps, s)
                     : cudaErrorInvalidValue;
}

cudaError_t run_f32(const Args& a, int warps, cudaStream_t s) {
  if (a.D <= 64) return run_f32_hd<64>(a, warps, s);
  if (a.D <= 128) return run_f32_hd<128>(a, warps, s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ bf16 branch

// Shared memory of the bf16 kernels: 1024 bytes of alignment slack and 256
// of mbarriers, then (ceil(D/64) column blocks of 128-byte rows) the dkv
// kernel's K and V tiles of block_kv keys and num_stages stages of q and do
// tiles of block_q rows with their lse and delta, and the dq kernel's q
// and do tiles of block_q rows and num_stages stages of K and V tiles of
// block_kv keys.
int dkv_bf16_smem(int D, int bq, int bkv, int stages) {
  const int nb = (D + 63) / 64;
  return 1280 + nb * 128 * (2 * bkv + 2 * stages * bq) + 8 * stages * bq;
}

int dq_bf16_smem(int D, int bq, int bkv, int stages) {
  const int nb = (D + 63) / 64;
  return 1280 + nb * 128 * (2 * bq + 2 * stages * bkv);
}

// A thread of the dkv kernel holds 64 NB f32 accumulators of dk
// and dv and block_q / 2 of s^T and dp^T each (their bf16 terms take their
// place); one of the dq kernel 32 NB of dq and block_kv / 2 of s and dp
// each.
__host__ __device__ constexpr bool dkv_bf16_fit(int nb, int bq) {
  return 64 * nb + bq <= 192;
}

__host__ __device__ constexpr bool dq_bf16_fit(int nb, int bkv) {
  return 32 * nb + bkv <= 192;
}

// NB: 64-column blocks of D; BQ: q rows a streamed tile; W: warpgroups
// (64 keys each).
template <int NB, int BQ, int W>
__global__ void __launch_bounds__(128 * W, W == 1 ? 2 : 1)
    dkv_wgmma(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tlse,
              const __grid_constant__ CUtensorMap tdel, const Args a) {
  using namespace hopper;
  constexpr int BK = 64 * W;
  constexpr int KVB = NB * BK * 128;  // the K (or V) tile
  constexpr int QB = NB * BQ * 128;   // one stage of q (or of do)
  constexpr int NS = BQ / 2;          // s^T accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + KVB;
  unsigned char* qs = vs + KVB;
  unsigned char* dos = qs + a.stages * QB;
  float* lses = reinterpret_cast<float*>(dos + a.stages * QB);
  float* dels = lses + a.stages * BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dels + a.stages * BQ);
  uint64_t* q_full = kv_full + 1;
  uint64_t* do_full = q_full + a.stages;
  uint64_t* empty = do_full + a.stages;

  // x: batch and KV head; y: kv tiles, the first (the most q rows under a
  // causal mask) launched first
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int kv0 = blockIdx.y * BK;
  const int kv1 = min(kv0 + BK, a.Skv) - 1;
  // The q rows that see any key of the block, for each head of the group;
  // tiles outside are skipped (the TPU kernel's pl.when).
  const int i_first = a.causal ? max(0, kv0 - a.q_offset) : 0;
  const int i_last = a.window > 0
                         ? min(a.Sq - 1, kv1 + a.window - 1 - a.q_offset)
                         : a.Sq - 1;
  const int t_first = i_first / BQ;
  const int n_qt = i_last >= i_first ? i_last / BQ - t_first + 1 : 0;
  const int n_it = G * n_qt;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    tma_prefetch(&tdo);
    tma_prefetch(&tlse);
    tma_prefetch(&tdel);
    mbar_init(kv_full, 1);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(q_full + s, 1);
      mbar_init(do_full + s, 1);
      mbar_init(empty + s, 4 * W);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 issues every load: K and V and the first num_stages q and do
  // tiles here, tile it + num_stages once every warp has released tile it
  // (release below).
  auto load = [&](int it) {
    const int s = it % a.stages, ph = (it / a.stages) & 1;
    const int h = hk * G + it / n_qt;
    const int q0 = (t_first + it % n_qt) * BQ;
    mbar_wait(empty + s, ph ^ 1);
    mbar_expect_tx(q_full + s, QB + BQ * 4);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int r = 0; r < BQ / 64; ++r)
        tma_tile(qs + s * QB + c * BQ * 128 + r * 8192, &tq, c * 64,
                 q0 + 64 * r, h, b, q_full + s);
    tma_row(lses + s * BQ, &tlse, q0, b * a.Hq + h, q_full + s);
    mbar_expect_tx(do_full + s, QB + BQ * 4);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int r = 0; r < BQ / 64; ++r)
        tma_tile(dos + s * QB + c * BQ * 128 + r * 8192, &tdo, c * 64,
                 q0 + 64 * r, h, b, do_full + s);
    tma_row(dels + s * BQ, &tdel, q0, b * a.Hq + h, do_full + s);
  };
  if (threadIdx.x == 0 && n_it > 0) {
    mbar_expect_tx(kv_full, 2 * KVB);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int r = 0; r < W; ++r) {
        tma_tile(ks + c * BK * 128 + r * 8192, &tk, c * 64, kv0 + 64 * r, hk,
                 b, kv_full);
        tma_tile(vs + c * BK * 128 + r * 8192, &tv, c * 64, kv0 + 64 * r, hk,
                 b, kv_full);
      }
    for (int it = 0; it < min(a.stages, n_it); ++it) load(it);
  }
  __syncwarp();

  // warpgroup wg: keys kv0 + 64 wg .. + 63
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk0 = kv0 + 64 * wg, wk1 = min(wk0 + 63, a.Skv - 1);
  const int k0 = wk0 + 16 * warp;  // the warp's first key
  const bool wg_live = wk0 < a.Skv;
  const uint32_t k_base = smem_u32(ks) + wg * 8192;
  const uint32_t v_base = smem_u32(vs) + wg * 8192;

  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;

  if (n_it > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % a.stages, ph = (it / a.stages) & 1;
    const int q0 = (t_first + it % n_qt) * BQ;
    const int qp0 = q0 + a.q_offset;
    const int qp1 = min(q0 + BQ, a.Sq) - 1 + a.q_offset;
    const bool run = wg_live && !(a.causal && qp1 < wk0) &&
                     !(a.window > 0 && qp0 - wk1 >= a.window);
    const uint32_t q_s = smem_u32(qs + s * QB);
    const uint32_t do_s = smem_u32(dos + s * QB);
    mbar_wait(q_full + s, ph);
    mbar_wait(do_full + s, ph);
    if (run) {
      float st[NS], dpt[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk) {
        const int ka = (kk / 4) * BK * 128 + (kk % 4) * 32;
        const int kb = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        wgmma_ss<BQ>(st, desc_kmajor(k_base + ka), desc_kmajor(q_s + kb),
                     kk > 0);
        wgmma_ss<BQ>(dpt, desc_kmajor(v_base + ka), desc_kmajor(do_s + kb),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);

      // p^T in st, ds^T in dpt: key k0 + g (+ 8), q row q0 + c
      const float* ls = lses + s * BQ;
      const float* dl = dels + s * BQ;
      const bool inside = q0 + BQ <= a.Sq && k0 + 15 < a.Skv &&
                          (!a.causal || qp0 >= k0 + 15) &&
                          (a.window <= 0 || qp1 - k0 < a.window);
      // The q rows key row r meets, as offsets from the thread's first
      // column q0 + 2t: element i sits at offset 8 (i / 4) + (i & 1).
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kv = k0 + g + 8 * r, base = q0 + 2 * t;
        const int last =
            a.window > 0 ? kv + a.window - 1 - a.q_offset : INT_MAX;
        lo[r] = a.causal ? kv - a.q_offset - base : INT_MIN;
        hi[r] = kv < a.Skv ? min(a.Sq - 1, last) - base : INT_MIN;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int e = i & 3, off = (i >> 2) * 8 + (e & 1);
        const int c = 2 * t + off;  // the q row in the tile
        const bool vis = inside || (off >= lo[e >> 1] && off <= hi[e >> 1]);
        const float p =
            vis ? fast_exp2(st[i] * a.scale_log2 - ls[c] * kLog2e) : 0.f;
        st[i] = p;
        dpt[i] = vis ? p * (dpt[i] - dl[c]) * a.scale : 0.f;
      }
      // dv += p^T.do, then dk += ds^T.q: one product group each, so the
      // fragments of p^T and of ds^T are never live together
      auto product = [&](const float (&x)[NS], float (&acc)[NB][32],
                         uint32_t b_base) {
        uint32_t fh[BQ / 16][4], fl[BQ / 16][4];
        split_frags<BQ>(x, fh, fl);
#pragma unroll
        for (int c = 0; c < NB; ++c) fence_acc(acc[c]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            const uint64_t db =
                desc_mnmajor(b_base + c * BQ * 128 + kk * 2048);
            wgmma_rs64(acc[c], fh[kk], db);
            wgmma_rs64(acc[c], fl[kk], db);
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NB; ++c) fence_acc(acc[c]);
      };
      product(st, dv, do_s);
      product(dpt, dk, q_s);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (threadIdx.x == 0 && it + a.stages < n_it) load(it + a.stages);
    __syncwarp();
  }

  bf16* dkg = static_cast<bf16*>(a.dk) + b * a.sgkb + hk * a.sgkh;
  bf16* dvg = static_cast<bf16*>(a.dv) + b * a.sgvb + hk * a.sgvh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + g + 8 * r;
    if (key >= a.Skv) continue;
    bf16* krow = dkg + static_cast<long long>(key) * a.sgks;
    bf16* vrow = dvg + static_cast<long long>(key) * a.sgvs;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + j * 8 + 2 * t;
        if (col < a.D) {
          store2(krow + col, dk[c][4 * j + 2 * r], dk[c][4 * j + 2 * r + 1]);
          store2(vrow + col, dv[c][4 * j + 2 * r], dv[c][4 * j + 2 * r + 1]);
        }
      }
  }
}

// NB: 64-column blocks of D; BKV: keys a streamed tile; W: warpgroups
// (64 rows each).
template <int NB, int BKV, int W>
__global__ void __launch_bounds__(128 * W, W == 1 ? 2 : 1)
    dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo, const Args a) {
  using namespace hopper;
  constexpr int BQ = 64 * W;
  constexpr int QB = NB * BQ * 128;   // the q (or do) tile
  constexpr int KB = NB * BKV * 128;  // one stage of K (or of V)
  constexpr int NS = BKV / 2;         // s accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* dos = qs + QB;
  unsigned char* ks = dos + QB;
  unsigned char* vs = ks + a.stages * KB;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + a.stages * KB);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + a.stages;
  uint64_t* empty = v_full + a.stages;

  // x: batch and head; y: q tiles, the last (the most keys under a causal
  // mask) launched first
  const int b = blockIdx.x / a.Hq, h = blockIdx.x % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int rows = min(BQ, a.Sq - q0);
  // The keys any row of the block sees, as in the forward.
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
    tma_prefetch(&tdo);
    mbar_init(q_full, 1);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 4 * W);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 issues every load: q and do and the first num_stages K/V
  // tiles here, tile it + num_stages once every warp has released tile it
  // (release below).
  auto load = [&](int it) {
    const int s = it % a.stages, ph = (it / a.stages) & 1;
    const int kv0 = (t_first + it) * BKV;
    mbar_wait(empty + s, ph ^ 1);
    mbar_expect_tx(k_full + s, KB);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int r = 0; r < BKV / 64; ++r)
        tma_tile(ks + s * KB + c * BKV * 128 + r * 8192, &tk, c * 64,
                 kv0 + 64 * r, hk, b, k_full + s);
    mbar_expect_tx(v_full + s, KB);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int r = 0; r < BKV / 64; ++r)
        tma_tile(vs + s * KB + c * BKV * 128 + r * 8192, &tv, c * 64,
                 kv0 + 64 * r, hk, b, v_full + s);
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(q_full, 2 * QB);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int r = 0; r < W; ++r) {
        tma_tile(qs + c * BQ * 128 + r * 8192, &tq, c * 64, q0 + 64 * r, h,
                 b, q_full);
        tma_tile(dos + c * BQ * 128 + r * 8192, &tdo, c * 64, q0 + 64 * r,
                 h, b, q_full);
      }
    for (int it = 0; it < min(a.stages, n_tiles); ++it) load(it);
  }
  __syncwarp();

  // warpgroup wg: rows q0 + 64 wg .. + 63
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = 64 * wg + 16 * warp;
  const int p0 = q0 + wrow + a.q_offset;
  const int p1 = min(q0 + wrow + 15, a.Sq - 1) + a.q_offset;
  const int wp0 = q0 + 64 * wg + a.q_offset;
  const int wp1 = min(q0 + 64 * wg + 63, a.Sq - 1) + a.q_offset;
  const bool wg_live = q0 + 64 * wg < a.Sq;
  const uint32_t q_base = smem_u32(qs) + wg * 8192;
  const uint32_t do_base = smem_u32(dos) + wg * 8192;
  float lse2[2], del[2];  // the rows' lse (base 2) and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    const long long at = (static_cast<long long>(b) * a.Hq + h) * a.sl + row;
    lse2[r] = row < a.Sq ? a.lse[at] * kLog2e : 0.f;
    del[r] = row < a.Sq ? a.delta[at] : 0.f;
  }

  float dq[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % a.stages, ph = (it / a.stages) & 1;
    const int kv0 = (t_first + it) * BKV;
    const bool run = wg_live && !(a.causal && wp1 < kv0) &&
                     !(a.window > 0 && wp0 - a.window + 1 > kv0 + BKV - 1);
    const uint32_t k_s = smem_u32(ks + s * KB);
    const uint32_t v_s = smem_u32(vs + s * KB);
    mbar_wait(k_full + s, ph);
    mbar_wait(v_full + s, ph);
    if (run) {
      float sacc[NS], dpa[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) sacc[i] = dpa[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk) {
        const int ka = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const int kb = (kk / 4) * BKV * 128 + (kk % 4) * 32;
        wgmma_ss<BKV>(sacc, desc_kmajor(q_base + ka), desc_kmajor(k_s + kb),
                      kk > 0);
        wgmma_ss<BKV>(dpa, desc_kmajor(do_base + ka), desc_kmajor(v_s + kb),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sacc);
      fence_acc(dpa);

      const bool inside = kv0 + BKV <= a.Skv &&
                          (!a.causal || kv0 + BKV - 1 <= p0) &&
                          (a.window <= 0 || p1 - kv0 < a.window);
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
        const int e = i & 3, r = e >> 1, off = (i >> 2) * 8 + (e & 1);
        const bool vis = inside || (off >= lo[r] && off <= hi[r]);
        const float p =
            vis ? fast_exp2(sacc[i] * a.scale_log2 - lse2[r]) : 0.f;
        dpa[i] = vis ? p * (dpa[i] - del[r]) * a.scale : 0.f;
      }
      // dq += ds.k, one product group a bf16 term of ds, so one term's
      // fragments are live at a time
#pragma unroll
      for (int term = 0; term < 2; ++term) {
        uint32_t f[BKV / 16][4];
        term_frags<BKV>(dpa, f, term);
#pragma unroll
        for (int c = 0; c < NB; ++c) fence_acc(dq[c]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int c = 0; c < NB; ++c)
            wgmma_rs64(dq[c], f[kk],
                       desc_mnmajor(k_s + c * BKV * 128 + kk * 2048));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NB; ++c) fence_acc(dq[c]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (threadIdx.x == 0 && it + a.stages < n_tiles) load(it + a.stages);
    __syncwarp();
  }

  bf16* dqg = static_cast<bf16*>(a.dq) + b * a.sgqb + h * a.sgqh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= a.Sq) continue;
    bf16* orow = dqg + static_cast<long long>(row) * a.sgqs;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + j * 8 + 2 * t;
        if (col < a.D)
          store2(orow + col, dq[c][4 * j + 2 * r], dq[c][4 * j + 2 * r + 1]);
      }
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int NB, int BQ, int W>
cudaError_t launch_dkv_bf16(const CUtensorMap* m, const Args& a,
                            cudaStream_t s) {
  if constexpr (!dkv_bf16_fit(NB, BQ)) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = dkv_wgmma<NB, BQ, W>;
    const int smem = dkv_bf16_smem(a.D, BQ, 64 * W, a.stages);
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.B * a.Hkv, (a.Skv + 64 * W - 1) / (64 * W));
    kern<<<grid, 128 * W, smem, s>>>(m[0], m[1], m[2], m[3], m[4],
                                           m[5], a);
    return cudaGetLastError();
  }
}

template <int NB, int BKV, int W>
cudaError_t launch_dq_bf16(const CUtensorMap* m, const Args& a,
                           cudaStream_t s) {
  if constexpr (!dq_bf16_fit(NB, BKV)) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = dq_wgmma<NB, BKV, W>;
    const int smem = dq_bf16_smem(a.D, 64 * W, BKV, a.stages);
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.B * a.Hq, (a.Sq + 64 * W - 1) / (64 * W));
    kern<<<grid, 128 * W, smem, s>>>(m[0], m[1], m[2], m[3], a);
    return cudaGetLastError();
  }
}

// The dkv kernel: block_kv / 64 warpgroups, block_q rows a q tile; the dq
// kernel: block_q / 64 warpgroups, block_kv keys a K/V tile.
template <int NB>
cudaError_t run_bf16_nb(const CUtensorMap* m, const Args& a,
                        cudaStream_t s) {
  cudaError_t e = cudaErrorInvalidValue;
  const int wkv = a.block_kv / 64, wq = a.block_q / 64;
  if (a.block_q == 64)
    e = wkv == 1 ? launch_dkv_bf16<NB, 64, 1>(m, a, s)
                 : launch_dkv_bf16<NB, 64, 2>(m, a, s);
  else if (a.block_q == 128)
    e = wkv == 1 ? launch_dkv_bf16<NB, 128, 1>(m, a, s)
                 : launch_dkv_bf16<NB, 128, 2>(m, a, s);
  if (e != cudaSuccess) return e;
  if (a.block_kv == 64)
    return wq == 1 ? launch_dq_bf16<NB, 64, 1>(m, a, s)
                   : launch_dq_bf16<NB, 64, 2>(m, a, s);
  return wq == 1 ? launch_dq_bf16<NB, 128, 1>(m, a, s)
                 : launch_dq_bf16<NB, 128, 2>(m, a, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the larger of the two launches (itemsize 2: the
// bf16 kernels with num_stages stages; 4: the f32 kernels, two stages).
int flash_attention_bwd_smem_bytes(int D, int itemsize, int block_q,
                                   int block_kv, int num_stages) {
  const int a = itemsize == 2
                    ? dkv_bf16_smem(D, block_q, block_kv, num_stages)
                    : dkv_smem(D, itemsize, block_q, block_kv);
  const int b = itemsize == 2 ? dq_bf16_smem(D, block_q, block_kv, num_stages)
                              : dq_smem(D, itemsize, block_q, block_kv);
  return a > b ? a : b;
}

// dtype 0 = f32, 1 = bf16; D <= 128 with rows of 16-byte multiples; strides
// in elements, 16-byte multiples, bases 16-byte aligned; window <= 0 is
// none.
//   f32:  block_q and block_kv are 16 x rt x num_warps with rt 1 or 2 and
//         num_warps 1-8, each in {16, 32, 64, 128}; num_stages 2.
//   bf16: block_q and block_kv 64 or 128 (64 rows a warpgroup),
//         num_warps 4 (a warpgroup's), num_stages 2-4.
// Launches the dkv kernel, then the dq kernel, on `stream`. Returns a
// cudaError_t (0 = launched); a combination whose accumulators would not
// fit the registers, or a tensor map TMA refuses, returns
// cudaErrorInvalidValue.
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int B, int Hq, int Hkv, int Sq, int Skv, int D, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sdb, long long sdh,
    long long sds, long long sgqb, long long sgqh, long long sgqs,
    long long sgkb, long long sgkh, long long sgks, long long sgvb,
    long long sgvh, long long sgvs, long long sl, float scale, int causal,
    int window,
    int q_offset, int block_q, int block_kv, int num_warps, int num_stages,
    int dtype, void* stream) {
  const int isz = dtype == 1 ? 2 : 4;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || D <= 0 || D > 128 || (D * isz) % 16 != 0 ||
      B * Hq > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (flash_attention_bwd_smem_bytes(D, isz, block_q, block_kv,
                                     num_stages) > kMaxSmem)
    return cudaErrorInvalidValue;
  const Args a{q,    k,    v,    dout, lse,  delta, dq,         dk,
               dv,   B,    Hq,   Hkv,  Sq,   Skv,   D,          round16(D),
               sqb,  sqh,  sqs,  skb,  skh,  sks,   svb,        svh,
               svs,  sdb,  sdh,  sds,  sgqb, sgqh,  sgqs,       sgkb,
               sgkh, sgks, sgvb, sgvh, sgvs, sl,   scale, scale * kLog2e,
               causal, window, q_offset, block_q, block_kv, num_stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (num_warps < 1 || num_warps > 8 || block_q % (16 * num_warps) != 0 ||
        block_kv % (16 * num_warps) != 0 || num_stages != 2)
      return cudaErrorInvalidValue;
    return run_f32(a, num_warps, s);
  }
  if ((block_q != 64 && block_q != 128) ||
      (block_kv != 64 && block_kv != 128) || num_warps != 4 ||
      num_stages < 2 || num_stages > 4)
    return cudaErrorInvalidValue;
  CUtensorMap m[6];
  if (!hopper::tile_map(&m[0], q, B, Hq, Sq, D, sqb, sqh, sqs) ||
      !hopper::tile_map(&m[1], k, B, Hkv, Skv, D, skb, skh, sks) ||
      !hopper::tile_map(&m[2], v, B, Hkv, Skv, D, svb, svh, svs) ||
      !hopper::tile_map(&m[3], dout, B, Hq, Sq, D, sdb, sdh, sds) ||
      !hopper::rows_map(&m[4], lse, (long long)B * Hq, Sq, sl, block_q) ||
      !hopper::rows_map(&m[5], delta, (long long)B * Hq, Sq, sl, block_q))
    return cudaErrorInvalidValue;
  if (D <= 64) return run_bf16_nb<1>(m, a, s);
  return run_bf16_nb<2>(m, a, s);
}

}  // extern "C"
