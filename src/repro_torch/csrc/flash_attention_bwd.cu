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
//   lse, delta (B, Hq, Sq)      f32, contiguous: the forward's lse and
//                               rowsum(do * o), computed by the caller
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
// and dv written once), 0.0158 ms at 3.35 TB/s. The design, simple and
// right first, is the reference's two-kernel recompute split:
//
//   * dkv kernel: one block per (batch, kv head, kv tile of block_kv keys);
//     the TPU grid's sequential axis (G heads x q tiles) becomes a loop
//     inside the block over the G query heads of the group and the q tiles
//     of block_q rows that see any key of the tile. The K and V tiles sit
//     in shared memory for the whole loop; the q and do tiles, with their
//     lse and delta, are double-buffered with cp.async, tile t + 1 in
//     flight while tile t is computed. Each warp owns 16 or 32 keys and
//     computes s^T = k.q^T and dp^T = v.do^T for them, so dk and dv stay
//     in f32 registers across the whole group and are written once: no
//     atomics, and a run is deterministic.
//   * dq kernel: one block per (batch, query head, q tile of block_q rows),
//     the forward's layout: q, do, lse and delta staged once, K and V tiles
//     double-buffered; each warp owns 16 or 32 rows and keeps dq in f32
//     registers, written once.
//   * bf16: the five products on the tensor cores with
//     mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 and f32 sums; p and ds
//     enter their products as two bf16 terms (the rounding and the
//     remainder), as P does in the forward, so they carry 16 bits where a
//     single rounding would carry 8.
//   * f32: the same tiles and fragment layout with IEEE fmaf on the CUDA
//     cores (no TF32), so f32 gradients hold to 1e-4 of the f32 reference.
//   * Rows past Sq or Skv and the columns between D and D rounded up to 16
//     are zero-filled by the copies; D 96 and 120 run unpadded in memory.
//
// s and dp are computed twice (once in each kernel): 7 products where 5
// would do. wgmma, TMA and one kernel that also accumulates dq are left for
// a later change.

#include "flash_attention.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB opt-in per block
constexpr float kLog2e = 1.4426950408889634f;

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
  float scale;
  float scale_log2;  // scale * log2(e): exponents are taken in base 2
  int causal, window, q_offset, block_q, block_kv;
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
    const long long row = (static_cast<long long>(b) * a.Hq + h) * a.Sq + q0;
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
    const long long row = (static_cast<long long>(b) * a.Hq + h) * a.Sq + q0;
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

template <typename T, int HD, int BQ, int RT>
cudaError_t launch_dkv(const Args& a, int warps, cudaStream_t s) {
  if constexpr (!dkv_regs_fit(HD, BQ, RT)) {
    return cudaErrorInvalidValue;
  } else {
    const dim3 grid((a.Skv + a.block_kv - 1) / a.block_kv, a.B * a.Hkv);
    return launch(dkv_kernel<T, HD, BQ, RT>, grid, warps,
                  dkv_smem(a.D, sizeof(T), BQ, a.block_kv), s, a);
  }
}

template <typename T, int HD, int BKV, int RT>
cudaError_t launch_dq(const Args& a, int warps, cudaStream_t s) {
  if constexpr (!dq_regs_fit(HD, BKV, RT)) {
    return cudaErrorInvalidValue;
  } else {
    const dim3 grid((a.Sq + a.block_q - 1) / a.block_q, a.B * a.Hq);
    return launch(dq_kernel<T, HD, BKV, RT>, grid, warps,
                  dq_smem(a.D, sizeof(T), a.block_q, BKV), s, a);
  }
}

// The dkv kernel's inner tile is block_q, its warps' rows block_kv; the dq
// kernel's the other way round.
template <typename T, int HD, int RT>
cudaError_t dkv_by_bq(int bq, const Args& a, int warps, cudaStream_t s) {
  if (bq == 16) return launch_dkv<T, HD, 16, RT>(a, warps, s);
  if (bq == 32) return launch_dkv<T, HD, 32, RT>(a, warps, s);
  if (bq == 64) return launch_dkv<T, HD, 64, RT>(a, warps, s);
  if (bq == 128) return launch_dkv<T, HD, 128, RT>(a, warps, s);
  return cudaErrorInvalidValue;
}

template <typename T, int HD, int RT>
cudaError_t dq_by_bkv(int bkv, const Args& a, int warps, cudaStream_t s) {
  if (bkv == 16) return launch_dq<T, HD, 16, RT>(a, warps, s);
  if (bkv == 32) return launch_dq<T, HD, 32, RT>(a, warps, s);
  if (bkv == 64) return launch_dq<T, HD, 64, RT>(a, warps, s);
  if (bkv == 128) return launch_dq<T, HD, 128, RT>(a, warps, s);
  return cudaErrorInvalidValue;
}

template <typename T, int HD>
cudaError_t run(const Args& a, int warps, cudaStream_t s) {
  const int rt_kv = a.block_kv / (16 * warps);
  const int rt_q = a.block_q / (16 * warps);
  cudaError_t e = rt_kv == 1   ? dkv_by_bq<T, HD, 1>(a.block_q, a, warps, s)
                  : rt_kv == 2 ? dkv_by_bq<T, HD, 2>(a.block_q, a, warps, s)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  return rt_q == 1   ? dq_by_bkv<T, HD, 1>(a.block_kv, a, warps, s)
         : rt_q == 2 ? dq_by_bkv<T, HD, 2>(a.block_kv, a, warps, s)
                     : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_hd(const Args& a, int warps, cudaStream_t s) {
  if (a.D <= 64) return run<T, 64>(a, warps, s);
  if (a.D <= 128) return run<T, 128>(a, warps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of the larger of the two launches.
int flash_attention_bwd_smem_bytes(int D, int itemsize, int block_q,
                                   int block_kv) {
  const int a = dkv_smem(D, itemsize, block_q, block_kv);
  const int b = dq_smem(D, itemsize, block_q, block_kv);
  return a > b ? a : b;
}

// dtype 0 = f32, 1 = bf16. block_q and block_kv are 16 x rt x num_warps
// with rt 1 or 2 and num_warps 1-8, each in {16, 32, 64, 128}; D <= 128
// with rows of 16-byte multiples; strides in elements, 16-byte multiples;
// window <= 0 is none. Launches the dkv kernel, then the dq kernel, on
// `stream`. Returns a cudaError_t (0 = launched); a combination whose
// accumulators would not fit the registers returns cudaErrorInvalidValue.
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int B, int Hq, int Hkv, int Sq, int Skv, int D, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sdb, long long sdh,
    long long sds, long long sgqb, long long sgqh, long long sgqs,
    long long sgkb, long long sgkh, long long sgks, long long sgvb,
    long long sgvh, long long sgvs, float scale, int causal, int window,
    int q_offset, int block_q, int block_kv, int num_warps, int dtype,
    void* stream) {
  const int isz = dtype == 1 ? 2 : 4;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || D <= 0 || D > 128 || (D * isz) % 16 != 0 ||
      num_warps < 1 || num_warps > 8 || block_q % (16 * num_warps) != 0 ||
      block_kv % (16 * num_warps) != 0 || B * Hq > 65535)
    return cudaErrorInvalidValue;
  if (flash_attention_bwd_smem_bytes(D, isz, block_q, block_kv) > kMaxSmem)
    return cudaErrorInvalidValue;
  const Args a{q,    k,    v,    dout, lse,  delta, dq,         dk,
               dv,   B,    Hq,   Hkv,  Sq,   Skv,   D,          round16(D),
               sqb,  sqh,  sqs,  skb,  skh,  sks,   svb,        svh,
               svs,  sdb,  sdh,  sds,  sgqb, sgqh,  sgqs,       sgkb,
               sgkh, sgks, sgvb, sgvh, sgvs, scale, scale * kLog2e,
               causal, window, q_offset, block_q, block_kv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return by_hd<bf16>(a, num_warps, s);
  if (dtype == 0) return by_hd<float>(a, num_warps, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
