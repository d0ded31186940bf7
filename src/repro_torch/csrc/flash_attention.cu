// Flash attention forward for Hopper (sm_90a): causal and sliding-window GQA
// attention over (B, H, S, D) operands, with the log-sum-exp of every row,
// behind a plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (`flash_attention`, one pallas_call):
// the dense prefill of `attn_impl="pallas"`.
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
// the 12.9 GFLOP the causal mask admits at 989 TFLOP/s. The design, simple
// and right first:
//
//   * One block per (batch, query head, q tile of block_q rows); the TPU
//     grid's sequential kv axis becomes a loop inside the block over the kv
//     tiles of block_kv keys from the window's first visible tile to the
//     causal last one. Tiles no row of the block sees are never loaded,
//     and a warp skips the tiles none of its rows sees.
//   * The q tile sits in shared memory for the whole loop; K and V tiles
//     are double-buffered in shared memory with 16-byte cp.async, tile
//     t + 1 in flight while tile t is computed. Rows past Sq or Skv and the
//     columns between D and D rounded up to 16 are zero-filled by the copy
//     itself, so D 96 and 120 run unpadded in memory. Staged rows are 16
//     bytes longer than the data, so fragment reads hit distinct banks.
//   * Each warp owns 16 or 32 query rows and keeps their online softmax
//     state (m, l and the o accumulator) in f32 registers, in the layout of
//     the mma.sync accumulator fragment: a thread holds two rows.
//   * bf16: q.k and p.v on the tensor cores with
//     mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, f32 sums; the fragments
//     are read by ldmatrix (V's transposed). P enters p.v as two bf16
//     terms, its rounding and the remainder (two MMAs), so p.v carries 16
//     bits of P where the TPU kernel's f32 p.v carries 24: at the serving
//     prefill o is then within 0.004 of the f32 plain version, where P
//     rounded once to bf16 gave 0.016.
//   * f32: the same tiles and fragment layout with IEEE fmaf on the CUDA
//     cores (no TF32), so f32 results hold to 1e-4 of the f32 reference.
//   * o (divided by l) and lse are written once at the end.
//
// wgmma, TMA, warp specialisation and packing the GQA group into one block
// (which would read each K/V tile once per group, not once per head) are
// left for a later change.

#include "flash_attention.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB opt-in per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kEmptyLse = -1e30f;  // lse of a row with no visible key

// Bytes of dynamic shared memory: the q tile and two stages of K and V
// tiles, each row D rounded up to 16 elements plus 16 bytes.
int smem_bytes(int D, int isz, int bq, int bkv) {
  return (bq + 4 * bkv) * (round16(D) * isz + 16);
}

// A thread holds rt (16-row tiles a warp owns) x (hd + bkv) / 2 f32
// accumulators of o and s; the kernel is instantiated where they fit 160.
__host__ __device__ constexpr bool regs_fit(int hd, int bkv, int rt) {
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
  int causal, window, q_offset, block_q;
};

// HD: D's class (64, 128 or 256: o's column tiles); BKV: keys a tile; RT:
// 16-row tiles a warp owns. block_q = 16 RT warps.
template <typename T, int HD, int BKV, int RT>
__global__ void __launch_bounds__(256) flash_kernel(const Args a) {
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

template <typename T, int HD, int BKV, int RT>
cudaError_t launch(const Args& a, int warps, int smem, cudaStream_t stream) {
  if constexpr (!regs_fit(HD, BKV, RT)) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = flash_kernel<T, HD, BKV, RT>;
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

template <typename T, int HD, int BKV>
cudaError_t by_rt(int rt, const Args& a, int warps, int smem,
                  cudaStream_t s) {
  if (rt == 1) return launch<T, HD, BKV, 1>(a, warps, smem, s);
  if (rt == 2) return launch<T, HD, BKV, 2>(a, warps, smem, s);
  return cudaErrorInvalidValue;
}

template <typename T, int HD>
cudaError_t by_bkv(int bkv, int rt, const Args& a, int warps, int smem,
                   cudaStream_t s) {
  if (bkv == 32) return by_rt<T, HD, 32>(rt, a, warps, smem, s);
  if (bkv == 64) return by_rt<T, HD, 64>(rt, a, warps, smem, s);
  if (bkv == 128) return by_rt<T, HD, 128>(rt, a, warps, smem, s);
  if (bkv == 256) return by_rt<T, HD, 256>(rt, a, warps, smem, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_hd(int bkv, int rt, const Args& a, int warps, int smem,
                  cudaStream_t s) {
  if (a.D <= 64) return by_bkv<T, 64>(bkv, rt, a, warps, smem, s);
  if (a.D <= 128) return by_bkv<T, 128>(bkv, rt, a, warps, smem, s);
  if (a.D <= 256) return by_bkv<T, 256>(bkv, rt, a, warps, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs.
int flash_attention_smem_bytes(int D, int itemsize, int block_q,
                               int block_kv) {
  return smem_bytes(D, itemsize, block_q, block_kv);
}

// dtype 0 = f32, 1 = bf16. block_q = 16 x rt x num_warps with rt 1 or 2
// and num_warps 1-8; block_kv in {32, 64, 128, 256}; D <= 256 with rows of
// 16-byte multiples; strides in elements, 16-byte multiples; window <= 0
// is none. Returns a cudaError_t (0 = launched); a combination whose
// accumulators would not fit the registers returns cudaErrorInvalidValue.
int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sob,
    long long soh, long long sos, float scale, int causal, int window,
    int q_offset, int block_q, int block_kv, int num_warps, int dtype,
    void* stream) {
  const int isz = dtype == 1 ? 2 : 4;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || D <= 0 || D > 256 || (D * isz) % 16 != 0 ||
      num_warps < 1 || num_warps > 8 || block_q % (16 * num_warps) != 0 ||
      B * Hq > 65535)
    return cudaErrorInvalidValue;
  const int rt = block_q / (16 * num_warps);
  const int smem = smem_bytes(D, isz, block_q, block_kv);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const Args a{q,   k,   v,   o,   lse, B,   Hq,  Hkv, Sq,  Skv,
               D,   round16(D),   sqb, sqh, sqs, skb, skh, sks, svb,
               svh, svs, sob, soh, sos, scale * kLog2e,   causal,
               window,   q_offset,  block_q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return by_hd<bf16>(block_kv, rt, a, num_warps, smem, s);
  if (dtype == 0) return by_hd<float>(block_kv, rt, a, num_warps, smem, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
