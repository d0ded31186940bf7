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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB opt-in per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kEmptyLse = -1e30f;  // lse of a row with no visible key

using bf16 = __nv_bfloat16;

int round16(int d) { return (d + 15) / 16 * 16; }

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 16 or 0 (0 zero-fills, reads nothing).
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage `rows` rows of dp elements (src rows `stride` elements apart; rows
// from `valid` on and columns from D on zero-filled) at row stride rs.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long stride,
                                      int rows, int valid, int rs,
                                      const Args& a) {
  constexpr int E = 16 / sizeof(T);  // elements a chunk
  const int cpr = a.dp / E;          // chunks a staged row
  const int data = a.D / E;          // chunks that hold data
  for (int c = threadIdx.x; c < rows * cpr; c += blockDim.x) {
    const int r = c / cpr, ch = c - r * cpr;
    const bool ok = r < valid && ch < data;
    cp16(dst + r * rs + ch * E, ok ? src + r * stride + ch * E : src,
         ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 and receives, of each matrix, row l / 4 at
// columns 2 (l % 4) and + 1 (with .trans: column l / 4 at rows 2 (l % 4)
// and + 1), the mma.sync fragment layouts.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// s (16 rows x NT 8-key tiles, accumulator layout) = q rows . k rows, over
// the dp staged columns. Lane (g, t) = (lane / 4, lane % 4) holds rows g
// and g + 8 at keys j * 8 + 2t and + 1 of tile j.
template <int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4], const bf16* qs,
                                   const bf16* ks, int rs, int dp, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  // q: matrices rows 0-7 and 8-15 at columns k0 and k0 + 8 (a0..a3); k:
  // keys j*8 and (j+1)*8 + 0..7 at columns k0 and k0 + 8 (b of tiles j and
  // j + 1)
  const bf16* qrow = qs + ((mi & 1) * 8 + ri) * rs + (mi >> 1) * 8;
  const bf16* krow = ks + ((mi >> 1) * 8 + ri) * rs + (mi & 1) * 8;
  for (int k0 = 0; k0 < dp; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, qrow + k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, krow + j * 8 * rs + k0);
      mma_bf16(s[j], a, b);
      mma_bf16(s[j + 1], a, b + 2);
    }
  }
}

template <int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4], const float* qs,
                                   const float* ks, int rs, int dp,
                                   int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int d = 0; d < dp; d += 4) {
    const float4 qa = *reinterpret_cast<const float4*>(qs + g * rs + d);
    const float4 qb = *reinterpret_cast<const float4*>(qs + (g + 8) * rs + d);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* kp = ks + (j * 8 + 2 * t) * rs + d;
      const float4 ka = *reinterpret_cast<const float4*>(kp);
      const float4 kb = *reinterpret_cast<const float4*>(kp + rs);
      s[j][0] = fmaf(qa.w, ka.w, fmaf(qa.z, ka.z,
                fmaf(qa.y, ka.y, fmaf(qa.x, ka.x, s[j][0]))));
      s[j][1] = fmaf(qa.w, kb.w, fmaf(qa.z, kb.z,
                fmaf(qa.y, kb.y, fmaf(qa.x, kb.x, s[j][1]))));
      s[j][2] = fmaf(qb.w, ka.w, fmaf(qb.z, ka.z,
                fmaf(qb.y, ka.y, fmaf(qb.x, ka.x, s[j][2]))));
      s[j][3] = fmaf(qb.w, kb.w, fmaf(qb.z, kb.z,
                fmaf(qb.y, kb.y, fmaf(qb.x, kb.x, s[j][3]))));
    }
  }
}

// o (16 rows x DT 8-column tiles of D, accumulator layout) += p . v, p the
// probabilities in s's layout.
// x and y rounded to bf16 (hi) and what the rounding left (lo), packed.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const float xh = __bfloat162float(__float2bfloat16_rn(x));
  const float yh = __bfloat162float(__float2bfloat16_rn(y));
  hi = pack_bf16(xh, yh);
  lo = pack_bf16(x - xh, y - yh);
}

template <int NT, int DT>
__device__ __forceinline__ void pv(float (&o)[DT][4], const float (&s)[NT][4],
                                   const bf16* vs, int rs, int dp, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {  // 16 keys a step
    uint32_t hi[4], lo[4];
    split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
    // matrices: keys kk*16 + 0..7 and + 8..15, columns n0 + 0..7 and + 8..15
    const bf16* vrow = vs + (kk * 16 + (mi & 1) * 8 + ri) * rs + (mi >> 1) * 8;
#pragma unroll
    for (int np = 0; np < DT / 2; ++np) {
      if (np * 16 < dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vrow + np * 16);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(o[2 * np], hi, b0);
        mma_bf16(o[2 * np], lo, b0);
        mma_bf16(o[2 * np + 1], hi, b1);
        mma_bf16(o[2 * np + 1], lo, b1);
      }
    }
  }
}

template <int NT, int DT>
__device__ __forceinline__ void pv(float (&o)[DT][4], const float (&s)[NT][4],
                                   const float* vs, int rs, int dp, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll 1
      for (int tt = 0; tt < 4; ++tt) {  // the quad lane holding key 2tt + e
        const int src = (lane & ~3) | tt;
        const float pg = __shfl_sync(0xffffffffu, s[j][e], src);
        const float pg8 = __shfl_sync(0xffffffffu, s[j][2 + e], src);
        const float* vr = vs + (j * 8 + 2 * tt + e) * rs + 2 * t;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          if (n * 8 < dp) {
            const float2 w = *reinterpret_cast<const float2*>(vr + n * 8);
            o[n][0] = fmaf(pg, w.x, o[n][0]);
            o[n][1] = fmaf(pg, w.y, o[n][1]);
            o[n][2] = fmaf(pg8, w.x, o[n][2]);
            o[n][3] = fmaf(pg8, w.y, o[n][3]);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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
    stage(qs, qg, a.sqs, a.block_q, rows, rs, a);
    const int kv0 = t_first * BKV;
    stage(ks, kg + kv0 * a.sks, a.sks, BKV, a.Skv - kv0, rs, a);
    stage(vs, vg + kv0 * a.svs, a.svs, BKV, a.Skv - kv0, rs, a);
    cp_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = (t_first + it) * BKV;
    if (it + 1 < n_tiles) {
      const int nx = kv0 + BKV, st = (it + 1) & 1;
      stage(ks + st * BKV * rs, kg + nx * a.sks, a.sks, BKV, a.Skv - nx, rs,
            a);
      stage(vs + st * BKV * rs, vg + nx * a.svs, a.svs, BKV, a.Skv - nx, rs,
            a);
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
