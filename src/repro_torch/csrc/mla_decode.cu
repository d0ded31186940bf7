// Absorbed-MLA decode for Hopper (sm_90a): one query token a request
// against the compressed latent cache, behind a plain C interface.
//
// Replaces the TPU kernel `_mla_decode_kernel` of
// src/repro/kernels/mla_decode.py (`mla_decode`, one pallas_call): the
// decode attention of an MLA model (deepseek-v2) under
// `decode_impl="pallas"`.
//
//   q_abs  (B, H, C)      bf16 or f32, contiguous: queries with W_uk folded in
//   q_rope (B, H, R)      q_abs's type, contiguous
//   ckv    (B, T, C)      q_abs's type, any batch and row strides, C
//                         contiguous: the latent cache, shared by every head
//   krope  (B, T, R)      q_abs's type, likewise: the decoupled RoPE keys
//   kv_len (B,)           int32; a request sees keys [0, min(kv_len, T))
//   o      (B, S, H, C)   f32, contiguous: each split's normalised context
//   lse    (B, S, H)      f32, contiguous: each split's log-sum-exp
//
// Scores s = (q_abs . ckv + q_rope . krope) * scale in f32; split k of S
// covers keys [k span, (k + 1) span), span = T rounded up to a whole
// number of block_kv x S, over S (the reference's grid); o = softmax(s) ckv
// over those keys and lse = log(sum exp(s)). A split that sees no key
// gives o = 0 and lse = -1e30. The wrapper combines the S partials with
// max-lse weights, as the reference's wrapper does outside pallas_call.
//
// Bound: at the serving decode (B 8, H 16, C 512, R 64, T 544, bf16, every
// request at 528 keys) bytes: the ckv and krope rows (8 x 528 x 576 x 2),
// q_abs and q_rope, and the f32 context, 5.3 MB, take 1.6 us at 3.35 TB/s,
// against 0.15 us for the 147 MFLOP at 989 TFLOP/s. The design, simple and
// right first:
//
//   * Decode-MLA is MQA with one wide shared head: one block per (split,
//     request, 16 heads) stages a tile of block_kv cache rows, each row
//     [ckv | krope] zero-padded to a multiple of 16, once for all its
//     heads. H = 16 is exactly one mma.sync m16 tile; fewer heads are
//     padded with zero rows, which are never written out.
//   * Tiles are double-buffered in shared memory with 16-byte cp.async,
//     tile t + 1 in flight while tile t is computed; rows at or past the
//     request's length are zero-filled by the copy, never read. Staged rows
//     are 16 bytes longer than the data, so fragment reads hit distinct
//     banks. At C + R = 576 in bf16 a tile of 64 rows takes 75 KB, so two
//     stages fit the 227 KB a block may use and 128 rows do not: the
//     counterpart of the TPU space's vmem_fits.
//   * Scores: the warps split the C + R contraction in 16-column chunks;
//     each computes the partial scores of all 16 rows and block_kv keys
//     and leaves them in shared memory, where each row's owner warp sums
//     them, masks, and updates the row's online softmax (m, l) in base 2.
//   * p . ckv: the warps split the C columns of the 16 x C f32 accumulator
//     in 16-column chunks; each keeps its chunks in registers in the
//     mma.sync accumulator layout. bf16: both products on the tensor cores
//     with mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, fragments read by
//     ldmatrix (ckv's transposed for p . ckv), and P entering p . ckv as
//     two bf16 terms, its rounding and the remainder, as in
//     flash_attention.cu. f32: the same tiles and layouts with IEEE fmaf on
//     the CUDA cores (no TF32).
//
// wgmma, TMA, warp specialisation and a combine inside the kernel are left
// for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB opt-in per block
constexpr int kRows = 16;         // heads a block: one m16 tile
constexpr int kMaxChunks = 8;     // 16-column chunks of C a warp owns: C <= 512
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kEmptyLse = -1e30f;  // lse of a split that sees no key

using bf16 = __nv_bfloat16;

int round16(int d) { return (d + 15) / 16 * 16; }

// f32 row stride of the partial scores and of P: 8 floats of padding keep
// the float2 accesses of a half-warp on distinct banks.
__host__ __device__ constexpr int score_stride(int bkv) { return bkv + 8; }

// Bytes of dynamic shared memory: the 16 query rows and two stages of
// block_kv cache rows, each dp elements plus 16 bytes; the warps' partial
// scores and P, f32; m, l and the rescale factor of the 16 rows.
int smem_bytes(int dp, int isz, int bkv, int warps) {
  return (kRows + 2 * bkv) * (dp * isz + 16) +
         (warps + 1) * kRows * score_stride(bkv) * 4 + 3 * kRows * 4;
}

struct Args {
  const void* qa;
  const void* qr;
  const void* ckv;
  const void* kr;
  const int* kv_len;
  float* o;
  float* lse;
  int B, H, C, R, T, dp, splits, span;  // dp: C + R rounded up to 16
  long long scb, sct, srb, srt;         // ckv and krope batch, row strides
  float scale_log2;                     // scale * log2(e): base-2 scores
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

// Stage `rows` rows [a | b | zeros] of dp elements at row stride rs: a's
// `ca` elements (src rows `sa` apart), then b's `cb` (rows `sb` apart).
// Rows from `valid` on are zero-filled.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* a, long long sa,
                                      int ca, const T* b, long long sb,
                                      int cb, int rows, int valid, int rs,
                                      int dp) {
  constexpr int E = 16 / sizeof(T);  // elements a chunk
  const int cpr = dp / E, na = ca / E, nb = cb / E;
  for (int c = threadIdx.x; c < rows * cpr; c += blockDim.x) {
    const int r = c / cpr, ch = c - r * cpr;
    const T* src = a;
    int bytes = 0;
    if (r < valid) {
      if (ch < na) {
        src = a + r * sa + ch * E;
        bytes = 16;
      } else if (ch < na + nb) {
        src = b + r * sb + (ch - na) * E;
        bytes = 16;
      }
    }
    cp16(dst + r * rs + ch * E, src, bytes);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x and y rounded to bf16 (hi) and what the rounding left (lo), packed.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const float xh = __bfloat162float(__float2bfloat16_rn(x));
  const float yh = __bfloat162float(__float2bfloat16_rn(y));
  hi = pack_bf16(xh, yh);
  lo = pack_bf16(x - xh, y - yh);
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

// Partial scores of the 16 query rows against NT 8-key tiles, over the
// warp's 16-column chunks of the contraction (chunk warp, warp + warps,
// ...). Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 at keys
// j * 8 + 2t and + 1 of tile j.
template <int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4], const bf16* qs,
                                   const bf16* ks, int rs, int dp, int warp,
                                   int warps, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  // q: matrices rows 0-7 and 8-15 at columns k0 and k0 + 8 (a0..a3); k:
  // keys j*8 and (j+1)*8 + 0..7 at columns k0 and k0 + 8 (b of tiles j and
  // j + 1)
  const bf16* qrow = qs + ((mi & 1) * 8 + ri) * rs + (mi >> 1) * 8;
  const bf16* krow = ks + ((mi >> 1) * 8 + ri) * rs + (mi & 1) * 8;
  for (int k0 = warp * 16; k0 < dp; k0 += warps * 16) {
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
                                   const float* ks, int rs, int dp, int warp,
                                   int warps, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = warp * 16; k0 < dp; k0 += warps * 16) {
    for (int d = k0; d < k0 + 16; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + g * rs + d);
      const float4 qb =
          *reinterpret_cast<const float4*>(qs + (g + 8) * rs + d);
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
}

// o (the warp's 16-column chunks of the 16 x C accumulator, chunk k at
// columns (warp + k warps) * 16, two 8-column tiles each, accumulator
// layout) += P (16 x BKV f32 in shared memory) . the staged ckv columns.
template <int BKV>
__device__ __forceinline__ void pv(float (&o)[kMaxChunks][2][4],
                                   const float* ps, const bf16* vs, int rs,
                                   int chunks, int warp, int warps,
                                   int lane) {
  constexpr int PS = score_stride(BKV);
  const int mi = lane >> 3, ri = lane & 7, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {  // 16 keys a step
    // a: rows g and g + 8 at keys kk*16 + 2t, + 1 and + 8, + 9
    const float* p0 = ps + g * PS + kk * 16 + 2 * t;
    const float* p1 = p0 + 8 * PS;
    uint32_t hi[4], lo[4];
    split_bf16(p0[0], p0[1], hi[0], lo[0]);
    split_bf16(p1[0], p1[1], hi[1], lo[1]);
    split_bf16(p0[8], p0[9], hi[2], lo[2]);
    split_bf16(p1[8], p1[9], hi[3], lo[3]);
    // matrices: keys kk*16 + 0..7 and + 8..15, columns c0 + 0..7 and + 8..15
    const bf16* vrow = vs + (kk * 16 + (mi & 1) * 8 + ri) * rs + (mi >> 1) * 8;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int cc = warp + k * warps;
      if (cc < chunks) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vrow + cc * 16);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(o[k][0], hi, b0);
        mma_bf16(o[k][0], lo, b0);
        mma_bf16(o[k][1], hi, b1);
        mma_bf16(o[k][1], lo, b1);
      }
    }
  }
}

template <int BKV>
__device__ __forceinline__ void pv(float (&o)[kMaxChunks][2][4],
                                   const float* ps, const float* vs, int rs,
                                   int chunks, int warp, int warps,
                                   int lane) {
  constexpr int PS = score_stride(BKV);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int j = 0; j < BKV; ++j) {
    const float pg = ps[g * PS + j], pg8 = ps[(g + 8) * PS + j];
    const float* vr = vs + j * rs + 2 * t;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int cc = warp + k * warps;
      if (cc < chunks) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float2 w =
              *reinterpret_cast<const float2*>(vr + cc * 16 + n * 8);
          o[k][n][0] = fmaf(pg, w.x, o[k][n][0]);
          o[k][n][1] = fmaf(pg, w.y, o[k][n][1]);
          o[k][n][2] = fmaf(pg8, w.x, o[k][n][2]);
          o[k][n][3] = fmaf(pg8, w.y, o[k][n][3]);
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, d));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

// One tile's online softmax, a row per warp at a time: the row's score is
// the sum of the warps' partials (in warp order), scaled to base 2, keys
// at or past `len` masked; then P = exp2(s - m) into shared memory and the
// row's m, l and rescale factor updated. Rows of padding heads get P = 0.
template <int BKV>
__device__ __forceinline__ void softmax_rows(const float* red, float* ps,
                                             float* m_s, float* l_s,
                                             float* al_s, int kv0, int len,
                                             int h_valid,
                                             float scale_log2, int warp,
                                             int warps, int lane) {
  constexpr int PS = score_stride(BKV);
  constexpr int KPL = (BKV + 31) / 32;  // keys a lane
  for (int r = warp; r < kRows; r += warps) {
    float* prow = ps + r * PS;
    if (r >= h_valid) {
      for (int i = lane; i < BKV; i += 32) prow[i] = 0.f;
      if (lane == 0) al_s[r] = 1.f;
      continue;
    }
    float v[KPL];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int idx = lane + 32 * i;
      float x = -INFINITY;
      if (idx < BKV && kv0 + idx < len) {
        float sum = 0.f;
        for (int w = 0; w < warps; ++w) sum += red[(w * kRows + r) * PS + idx];
        x = sum * scale_log2;
      }
      v[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = warp_max(mx);
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    const float mu = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int idx = lane + 32 * i;
      const float p = exp2f(v[i] - mu);  // masked: exp2(-inf) = 0
      if (idx < BKV) prow[idx] = p;
      ls += p;
    }
    ls = warp_sum(ls);
    __syncwarp();
    if (lane == 0) {
      const float alpha = exp2f(m_old - mu);
      al_s[r] = alpha;
      l_s[r] = l_s[r] * alpha + ls;
      m_s[r] = m_new;
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// BKV: cache rows a tile. A block is `warps` warps; grid (S, B, H / 16).
template <typename T, int BKV>
__global__ void __launch_bounds__(256) mla_kernel(const Args a) {
  constexpr int NT = BKV / 8;  // 8-key tiles of s
  constexpr int PS = score_stride(BKV);
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = a.dp + 16 / static_cast<int>(sizeof(T));  // staged row
  const int warps = blockDim.x >> 5;
  T* qs = reinterpret_cast<T*>(smem);
  T* kvs = qs + kRows * rs;  // two stages of BKV rows
  float* red = reinterpret_cast<float*>(kvs + 2 * BKV * rs);
  float* ps = red + warps * kRows * PS;
  float* m_s = ps + kRows * PS;
  float* l_s = m_s + kRows;
  float* al_s = l_s + kRows;

  const int split = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * kRows;
  const int h_valid = min(kRows, a.H - h0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = a.C / 16;

  // Clamp to the cache: kv_len > T means the whole cache. The split's keys
  // [first, end); tiles past the length are never loaded (the TPU kernel's
  // pl.when).
  const int len = min(max(a.kv_len[b], 0), a.T);
  const int first = split * a.span;
  const int end = min(first + a.span, len);
  const int n_tiles = end > first ? (end - first + BKV - 1) / BKV : 0;
  const T* ckv = static_cast<const T*>(a.ckv) + b * a.scb;
  const T* kr = static_cast<const T*>(a.kr) + b * a.srb;

  if (threadIdx.x < kRows) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  float o[kMaxChunks][2][4];
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[k][n][e] = 0.f;

  if (n_tiles > 0) {
    const long long q0 = static_cast<long long>(b) * a.H + h0;
    stage(qs, static_cast<const T*>(a.qa) + q0 * a.C, a.C, a.C,
          static_cast<const T*>(a.qr) + q0 * a.R, a.R, a.R, kRows, h_valid,
          rs, a.dp);
    stage(kvs, ckv + first * a.sct, a.sct, a.C, kr + first * a.srt, a.srt,
          a.R, BKV, end - first, rs, a.dp);
    cp_commit();
  }
  __syncthreads();  // m_s, l_s initialised
  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = first + it * BKV;
    if (it + 1 < n_tiles) {
      const int nx = kv0 + BKV;
      stage(kvs + ((it + 1) & 1) * BKV * rs, ckv + nx * a.sct, a.sct, a.C,
            kr + nx * a.srt, a.srt, a.R, BKV, end - nx, rs, a.dp);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* kst = kvs + (it & 1) * BKV * rs;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    qk<NT>(s, qs, kst, rs, a.dp, warp, warps, lane);
    float* rw = red + warp * kRows * PS;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      store2(rw + g * PS + j * 8 + 2 * t, s[j][0], s[j][1]);
      store2(rw + (g + 8) * PS + j * 8 + 2 * t, s[j][2], s[j][3]);
    }
    __syncthreads();

    softmax_rows<BKV>(red, ps, m_s, l_s, al_s, kv0, end, h_valid,
                      a.scale_log2, warp, warps, lane);
    __syncthreads();

    const float al0 = al_s[g], al8 = al_s[g + 8];
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        o[k][n][0] *= al0;
        o[k][n][1] *= al0;
        o[k][n][2] *= al8;
        o[k][n][3] *= al8;
      }
    pv<BKV>(o, ps, kst, rs, chunks, warp, warps, lane);
    __syncthreads();  // the stage, the partials and P are overwritten next
  }

  const long long part = static_cast<long long>(b) * a.splits + split;
  float* ob = a.o + (part * a.H + h0) * a.C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = g + 8 * i;
    if (row >= h_valid) continue;
    const float l = l_s[row];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = ob + static_cast<long long>(row) * a.C;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int cc = warp + k * warps;
      if (cc < chunks) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
          store2(orow + cc * 16 + n * 8 + 2 * t, o[k][n][2 * i] * inv,
                 o[k][n][2 * i + 1] * inv);
      }
    }
  }
  if (threadIdx.x < h_valid) {
    const float l = l_s[threadIdx.x];
    a.lse[part * a.H + h0 + threadIdx.x] =
        l > 0.f ? m_s[threadIdx.x] * kLn2 + logf(l) : kEmptyLse;
  }
}

template <typename T, int BKV>
cudaError_t launch(const Args& a, int warps, int smem, cudaStream_t stream) {
  auto kern = mla_kernel<T, BKV>;
  static int configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const dim3 grid(a.splits, a.B, (a.H + kRows - 1) / kRows);
  kern<<<grid, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_bkv(int bkv, const Args& a, int warps, int smem,
                   cudaStream_t s) {
  if (bkv == 16) return launch<T, 16>(a, warps, smem, s);
  if (bkv == 32) return launch<T, 32>(a, warps, smem, s);
  if (bkv == 64) return launch<T, 64>(a, warps, smem, s);
  if (bkv == 128) return launch<T, 128>(a, warps, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (C + R, the element size, keys a
// tile, warps a block).
int mla_decode_smem_bytes(int width, int itemsize, int block_kv,
                          int num_warps) {
  return smem_bytes(round16(width), itemsize, block_kv, num_warps);
}

// dtype 0 = f32, 1 = bf16. C a multiple of 16, at most 512; R rows of
// 16-byte multiples; block_kv in {16, 32, 64, 128}; num_warps 4 or 8;
// span a positive multiple of block_kv; strides in elements, 16-byte
// multiples. Returns a cudaError_t (0 = launched).
int mla_decode_launch(const void* q_abs, const void* q_rope, const void* ckv,
                      const void* krope, const int* kv_len, float* o,
                      float* lse, int B, int H, int C, int R, int T,
                      long long scb, long long sct, long long srb,
                      long long srt, float scale, int block_kv,
                      int k_splits, int span, int num_warps, int dtype,
                      void* stream) {
  const int isz = dtype == 1 ? 2 : 4;
  if (B <= 0 || B > 65535 || H <= 0 || C <= 0 || C % 16 != 0 ||
      C > 16 * kMaxChunks * 4 || R < 0 || (R * isz) % 16 != 0 || T <= 0 ||
      (num_warps != 4 && num_warps != 8) || k_splits < 1 ||
      span <= 0 || span % block_kv != 0)
    return cudaErrorInvalidValue;
  const int dp = round16(C + R);
  const int smem = smem_bytes(dp, isz, block_kv, num_warps);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const Args a{q_abs, q_rope, ckv, krope, kv_len, o,   lse,
               B,     H,      C,   R,     T,      dp,  k_splits,
               span,  scb,    sct, srb,   srt,    scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return by_bkv<bf16>(block_kv, a, num_warps, smem, s);
  if (dtype == 0) return by_bkv<float>(block_kv, a, num_warps, smem, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
