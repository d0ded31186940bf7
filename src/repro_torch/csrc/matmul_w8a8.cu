// w8a8 GEMM for Hopper (sm_90a): int8 x int8 -> int32 on the tensor cores,
// dequantized by per-channel or per-tensor f32 scales, with a plain C
// interface.
//
// Replaces the TPU kernels `_epilogue_kernel` and `_inline_kernel` of
// src/repro/kernels/matmul_int8.py (one pallas_call): the MLP projections of
// the w8a8 policy, activations quantized per token, weights per output
// channel.
//
//   x        (M, K)   int8, row-major (K contiguous)
//   w        (K, N)   int8, stored (N, K) row-major: each output column's
//                     K values contiguous, the `.col` B operand of the MMA
//   x_scale  (M,) f32 per row, or one value (per_tensor)
//   w_scale  (N,) f32 per column, or one value (per_tensor)
//   out      (M, N)   f32, row-major
//
//   dequant epilogue: out = float(sum_k x w) * x_scale * w_scale, the int32
//                     sum exact across the whole K loop, scaled once at the
//                     store (per tensor: * (x_scale * w_scale));
//   dequant inline:   each block_k slice's int32 partial is converted,
//                     scaled the same way and summed into an f32
//                     accumulator.
//
// Bound: at prefill (M = 4096 rows) operations, 2 M K N int8 ops at 1,979
// TOP/s; at decode (M = 8) bytes, the K N weight bytes streamed once over
// 3.35 TB/s. The design, simple and right first:
//
//   * One block per block_m x block_n output tile; the TPU grid's
//     sequential K axis becomes a loop inside the block over slices of
//     block_k, double-buffered: slice kt + 1 is copied into shared memory
//     with cp.async while slice kt is multiplied.
//   * Copies of 16 bytes (8 or 4 where K or a base pointer is not a
//     multiple of 16), one row chunk each. Rows past M and columns past N
//     (decode's 8 rows inside a 16-row tile) and chunks past K are
//     zero-filled by the copy itself (src-size 0), so the edges need no
//     padded copy of x or w and contribute zeros to the sums.
//   * Staged rows are block_k + 16 bytes apart, so the 32 lanes' 4-byte
//     fragment reads (8 rows x 4 words) fall on 32 distinct banks.
//   * mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 by inline PTX: each
//     warp owns a (block_m / warps_m) x (block_n / warps_n) sub-tile of
//     16 x 8 MMA tiles with int32 accumulators in registers (the inline
//     dequant adds an f32 set of the same size). Fragments are loaded with
//     32-bit shared-memory reads, no ldmatrix.
//   * Scales are read from global memory in the epilogue (for inline, once
//     a K slice), after the tile's integer sums.
//
// wgmma, TMA, a deeper pipeline and split-K (decode's wo gives 48 blocks of
// 64 columns for 132 SMs) are left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 16;          // bytes of padding after each staged row
constexpr int kMaxSmem = 232448;  // 227 KB opt-in per block

// Bytes of dynamic shared memory: two stages of (block_m + block_n) rows of
// block_k + kPad bytes.
int smem_bytes(int bm, int bn, int bk) { return 2 * (bm + bn) * (bk + kPad); }

// Warps along M: as many as keep a warp's rows a multiple of 16, at most
// half the warps (the rest split N).
__host__ __device__ constexpr int warps_m(int bm, int warps) {
  return bm / 16 < warps / 2 ? bm / 16 : warps / 2;
}

// Accumulator registers a thread holds; the space keeps them within 128.
__host__ __device__ constexpr bool regs_fit(int bm, int bn, int warps,
                                            bool inl) {
  return bm * bn * (inl ? 2 : 1) <= 4096 * warps;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One chunk of `vec` bytes global -> shared; `bytes` = vec or 0 (0 fills the
// chunk with zeros and reads nothing).
__device__ __forceinline__ void cp_chunk(int8_t* dst, const int8_t* src,
                                         int vec, int bytes) {
  const uint32_t d = smem_addr(dst);
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* xs;
  const float* ws;
  float* out;
  int M, N, K, bk, vec, per_tensor;
};

// Stage slice kt (K columns kt*bk ...) of the tile's x rows and w columns.
template <int BM, int BN, int THREADS>
__device__ __forceinline__ void load_slice(const Args& a, int8_t* stage,
                                           int m0, int n0, int kt) {
  const int rb = a.bk + kPad;
  const int per_row = a.bk / a.vec;
  const int k0 = kt * a.bk;
  for (int c = threadIdx.x; c < (BM + BN) * per_row; c += THREADS) {
    const int r = c / per_row;
    const int kc = (c - r * per_row) * a.vec;
    const bool in_k = k0 + kc < a.K;
    const int8_t* src;
    bool ok;
    if (r < BM) {
      ok = in_k && m0 + r < a.M;
      src = a.x + (ok ? static_cast<long long>(m0 + r) * a.K + k0 + kc : 0);
    } else {
      ok = in_k && n0 + r - BM < a.N;
      src = a.w +
            (ok ? static_cast<long long>(n0 + r - BM) * a.K + k0 + kc : 0);
    }
    cp_chunk(stage + r * rb + kc, src, a.vec, ok ? a.vec : 0);
  }
}

template <int BM, int BN, int WARPS, bool INLINE>
__global__ void __launch_bounds__(WARPS * 32)
    matmul_w8a8_kernel(const Args a) {
  constexpr int WMW = warps_m(BM, WARPS);  // warps along M
  constexpr int WNW = WARPS / WMW;         // warps along N
  constexpr int WM = BM / WMW;             // rows a warp owns
  constexpr int WN = BN / WNW;             // columns a warp owns
  constexpr int MT = WM / 16;              // 16-row MMA tiles a warp owns
  constexpr int NT = WN / 8;               // 8-column MMA tiles a warp owns
  static_assert(WMW * WNW == WARPS && WM % 16 == 0 && WN % 8 == 0,
                "warp layout");
  extern __shared__ __align__(16) int8_t smem[];

  const int rb = a.bk + kPad;
  const int stage_bytes = (BM + BN) * rb;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WNW) * WM, wn0 = (warp % WNW) * WN;

  int acc[MT][NT][4];
  float facc[INLINE ? MT : 1][INLINE ? NT : 1][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        if (INLINE) facc[INLINE ? i : 0][INLINE ? j : 0][e] = 0.f;
      }

  // Scales of a row and a column (zero past the edge, whose sums are 0).
  const float s_t = a.per_tensor ? a.xs[0] * a.ws[0] : 0.f;
  auto row_scale = [&](int row) {
    return row < a.M ? a.xs[row] : 0.f;
  };
  auto col_scale = [&](int col) {
    return col < a.N ? a.ws[col] : 0.f;
  };
  // float(acc) * x_scale * w_scale, the reference's order of the products.
  auto dequant = [&](int v, int row, int col) {
    return a.per_tensor ? static_cast<float>(v) * s_t
                        : static_cast<float>(v) * row_scale(row) *
                              col_scale(col);
  };

  const int n_k = (a.K + a.bk - 1) / a.bk;
  load_slice<BM, BN, WARPS * 32>(a, smem, m0, n0, 0);
  cp_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      load_slice<BM, BN, WARPS * 32>(a, smem + ((kt + 1) & 1) * stage_bytes,
                                     m0, n0, kt + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int8_t* As = smem + (kt & 1) * stage_bytes;
    const int8_t* Bs = As + BM * rb;
    for (int kk = 0; kk < a.bk; kk += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = As + (wm0 + i * 16 + g) * rb + kk + t * 4;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * rb);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * rb + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = Bs + (wn0 + j * 8 + g) * rb + kk + t * 4;
        const uint32_t bf[2] = {ld32(p), ld32(p + 16)};
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], af[i], bf);
      }
    }
    if (INLINE) {
      // this slice's partial: converted, scaled, summed in f32
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + wm0 + i * 16 + g + (e >> 1) * 8;
            const int col = n0 + wn0 + j * 8 + t * 2 + (e & 1);
            facc[INLINE ? i : 0][INLINE ? j : 0][e] +=
                dequant(acc[i][j][e], row, col);
            acc[i][j][e] = 0;
          }
    }
    __syncthreads();  // the stage is overwritten by the next copies
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm0 + i * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn0 + j * 8 + t * 2 + (e & 1);
        if (row < a.M && col < a.N)
          a.out[static_cast<long long>(row) * a.N + col] =
              INLINE ? facc[INLINE ? i : 0][INLINE ? j : 0][e]
                     : dequant(acc[i][j][e], row, col);
      }
}

template <int BM, int BN, int WARPS, bool INLINE>
cudaError_t launch(const Args& a, int smem, cudaStream_t stream) {
  if constexpr (!regs_fit(BM, BN, WARPS, INLINE)) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = matmul_w8a8_kernel<BM, BN, WARPS, INLINE>;
    static int configured = 48 * 1024;
    if (smem > configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      configured = smem;
    }
    const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
    kern<<<grid, WARPS * 32, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

template <int BM, int BN, int WARPS>
cudaError_t by_dequant(bool inl, const Args& a, int smem, cudaStream_t s) {
  return inl ? launch<BM, BN, WARPS, true>(a, smem, s)
             : launch<BM, BN, WARPS, false>(a, smem, s);
}

template <int BM, int BN>
cudaError_t by_warps(int warps, bool inl, const Args& a, int smem,
                     cudaStream_t s) {
  if (warps == 4) return by_dequant<BM, BN, 4>(inl, a, smem, s);
  if (warps == 8) return by_dequant<BM, BN, 8>(inl, a, smem, s);
  return cudaErrorInvalidValue;
}

template <int BM>
cudaError_t by_bn(int bn, int warps, bool inl, const Args& a, int smem,
                  cudaStream_t s) {
  if (bn == 64) return by_warps<BM, 64>(warps, inl, a, smem, s);
  if (bn == 128) return by_warps<BM, 128>(warps, inl, a, smem, s);
  if (bn == 256) return by_warps<BM, 256>(warps, inl, a, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs.
int matmul_w8a8_smem_bytes(int block_m, int block_n, int block_k) {
  return smem_bytes(block_m, block_n, block_k);
}

// block_m in {16, 32, 64, 128}, block_n in {64, 128, 256}, block_k a
// multiple of 32, num_warps 4 or 8, inline 0 (epilogue) or 1; vec the copy
// width in bytes (16, 8 or 4: it divides K and both base pointers'
// alignment); per_tensor 1 takes x_scale[0] and w_scale[0]. Returns a
// cudaError_t (0 = launched); a combination whose accumulators would not
// fit the registers returns cudaErrorInvalidValue.
int matmul_w8a8_launch(const void* x, const void* w, const float* x_scale,
                       const float* w_scale, float* out, int M, int N, int K,
                       int block_m, int block_n, int block_k, int num_warps,
                       int inl, int vec, int per_tensor, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block_k <= 0 || block_k % 32 != 0 ||
      (vec != 16 && vec != 8 && vec != 4) || K % vec != 0)
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(block_m, block_n, block_k);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               x_scale, w_scale, out, M, N, K, block_k, vec, per_tensor};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool il = inl != 0;
  switch (block_m) {
    case 16: return by_bn<16>(block_n, num_warps, il, a, smem, s);
    case 32: return by_bn<32>(block_n, num_warps, il, a, smem, s);
    case 64: return by_bn<64>(block_n, num_warps, il, a, smem, s);
    case 128: return by_bn<128>(block_n, num_warps, il, a, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
