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
//                     K values contiguous (K-major, as wgmma and mma.sync
//                     take int8 B operands)
//   x_scale  (M,) f32 per row, or one value (per_tensor)
//   w_scale  (N,) f32 per column, or one value (per_tensor)
//   out      (M, N)   f32, row-major
//
//   dequant epilogue: out = float(sum_k x w) * x_scale * w_scale, the int32
//                     sum exact across the whole K loop, scaled once at the
//                     store (per tensor: * (x_scale * w_scale));
//   dequant inline:   each K slice's int32 partial (block_k bytes; 128 on
//                     the wgmma path) is converted, scaled the same way
//                     and summed into an f32 accumulator.
//
// Bound: at decode (M = 8 rows) bytes, the K N weight bytes streamed once
// over 3.35 TB/s (decode wo, 8 x 8192 x 3072: 25.3 MB, 0.00756 ms); at
// prefill (M = 4096) operations, 2 M K N int8 ops at 1,979 TOP/s (prefill
// wo: 0.1042 ms). Two kernels, chosen by the wrapper from the layout:
//
// Where TMA can read x and w (K a multiple of 16 bytes, 16-byte aligned
// bases): w8a8_wgmma, the tools of gemm.cuh and hopper.cuh.
//
//   * A persistent grid (one block per SM, more where the shared memory
//     allows) walks the work units: the output tiles in groups of 8 row
//     panels, column-major inside a group, times the K splits below.
//   * One producer warp keeps a ring of num_stages K slices of 128 bytes
//     (one 128-byte-swizzled TMA row per operand row) in flight, running
//     ahead across units; each slice's arrival completes a full mbarrier,
//     every consumer warp's release an empty one. Rows past M or N and K
//     past its end are zero-filled by TMA.
//   * One or two consumer warpgroups issue wgmma m64nNk32 .s32.s8.s8 with
//     both operands K-major in shared memory, so neither x nor w is copied.
//     Slice t is issued, then wgmma.wait_group 1 lets slice t - 1 finish
//     and its stage is released while t runs (epilogue dequant; inline
//     dequant reads each slice's sums, so it waits for them). The K loop's
//     four products a slice are unrolled: a runtime loop around them made
//     ptxas inject warpgroup.arrive (C7519) and slowed the prefill.
//   * Prefill (block_m 64 or 128): x's rows are wgmma's M, 64 a warpgroup,
//     w's block_n rows its N; the int32 accumulators (block_n / 2 a thread)
//     stay in registers across K.
//   * Decode (block_m 8, 16 or 32): the operands swap roles. w's block_n
//     rows (64 a warpgroup) are wgmma's M and x's rows its N, so the tensor
//     cores multiply no zero rows and the x slice is block_m x 128 bytes;
//     the output tile is stored transposed. Decode streams w, and its 24-48
//     column tiles would leave most of the 132 SMs idle, so K splits
//     split_k ways: each unit streams K / split_k of its w rows and writes
//     its partial sums (int32, or f32 under inline dequant) to a workspace;
//     the last unit of a tile to finish (a per-tile counter, zeroed by the
//     wrapper) sums the partials in split order and dequantizes once. Integer
//     partials sum exactly, so split_k > 1 is bit-equal to split_k 1 under
//     epilogue dequant; f32 partials sum in a fixed order, so two launches
//     give the same bits.
//   * The scales are read in the epilogue (inline: each slice), after the
//     tile's integer sums; the output is written from registers, a 32-byte
//     sector per row and instruction.
//
// Where TMA cannot (K not a multiple of 16, such as 200; a base off 16
// bytes): matmul_w8a8_kernel, mma.sync m16n8k32 fed by a two-stage
// cp.async ring:
//
//   * one block per block_m x block_n output tile; the TPU grid's
//     sequential K axis becomes a loop inside the block over slices of
//     block_k, double-buffered: slice kt + 1 is copied into shared memory
//     with cp.async while slice kt is multiplied;
//   * copies of 16 bytes (8 or 4 where K or a base pointer is not a
//     multiple of 16), one row chunk each; rows past M, columns past N and
//     chunks past K are zero-filled by the copy itself (src-size 0);
//   * staged rows are block_k + 16 bytes apart, so the 32 lanes' 4-byte
//     fragment reads (8 rows x 4 words) fall on 32 distinct banks;
//   * each warp owns a (block_m / warps_m) x (block_n / warps_n) sub-tile
//     of 16 x 8 MMA tiles with int32 accumulators in registers (the inline
//     dequant adds an f32 set of the same size), fragments loaded with
//     32-bit shared-memory reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

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

// ------------------------------------------------------------ wgmma branch

constexpr int kGroupM = 8;  // row panels a group of tiles walks

// Shared memory of w8a8_wgmma: 1024 bytes of alignment slack, 256 of
// mbarriers and a flag, and `stages` K slices of 128 bytes of the tile's bm
// x rows and bn w rows.
int wgmma_smem(int bm, int bn, int stages) {
  return 1024 + 256 + stages * 128 * (bm + bn);
}

// A thread's accumulators: n / 2 int32 of wgmma's N columns n, and as many
// f32 under inline dequant, within 128 registers.
__host__ __device__ constexpr bool wgmma_regs_fit(int n, bool inl) {
  return n / 2 * (1 + inl) <= 128;
}

// The splits a launch runs: each takes ceil(slices / split_k) slices of
// 128 bytes of K, the last what is left, and none is empty.
int effective_splits(int K, int split_k) {
  const int slices = (K + 127) / 128;
  const int per = (slices + split_k - 1) / split_k;
  return (slices + per - 1) / per;
}

struct WArgs {
  const float* xs;
  const float* ws;
  float* out;
  int* part;      // splits > 1: (splits, M, N) partial sums, int32 or f32
  int* counters;  // splits > 1: one per tile, zeroed before the launch
  int M, N, K, stages, splits, per, per_tensor;
};

// W: consumer warpgroups, 64 rows of the A operand each (x's rows, or with
// SWAP w's); BN: wgmma's N, the B operand's rows (w's, or with SWAP x's).
// Warpgroup W (threads 128 W ...) is the producer warp. A persistent grid
// walks the work units, (split, tile) pairs, the tiles in grouped order.
template <int W, int BN, bool SWAP, bool INLINE>
__global__ void __launch_bounds__(128 * W + 32)
    w8a8_wgmma(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, const WArgs a) {
  using namespace hopper;
  using namespace gemm;
  constexpr int AR = 64 * W;               // A rows a tile
  constexpr int NR = BN / 2;               // accumulators a thread
  constexpr int MB = SWAP ? BN : AR;       // x rows a tile
  constexpr int NB = SWAP ? AR : BN;       // w rows a tile
  constexpr int STAGE = (AR + BN) * 128;   // a slice of both tiles
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.stages * STAGE);
  uint64_t* empty = full + a.stages;
  int* last_block = reinterpret_cast<int*>(empty + a.stages);

  const int tiles_m = (a.M + MB - 1) / MB, tiles_n = (a.N + NB - 1) / NB;
  const int tiles = tiles_m * tiles_n;
  const int slices = (a.K + 127) / 128;
  const int wg = warpgroup();
  // Unit u: split u / tiles of tile u % tiles, x rows from m0, w rows from
  // n0, its slices s0 ... s0 + n_it - 1.
  auto unit = [&](int u, int& tile, int& m0, int& n0, int& s0, int& n_it) {
    int pm, pn;
    tile = u % tiles;
    tile_coords(tile, tiles_m, tiles_n, kGroupM, pm, pn);
    m0 = pm * MB;
    n0 = pn * NB;
    s0 = (u / tiles) * a.per;
    n_it = min(a.per, slices - s0);
  };

  if (threadIdx.x == 0) {
    tma_prefetch(&ta);
    tma_prefetch(&tb);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * W);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int units = tiles * a.splits;
  if (wg == W) {  // the producer warp: one thread issues every load
    if (threadIdx.x == 128 * W) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int tile, m0, n0, s0, n_it;
        unit(u, tile, m0, n0, s0, n_it);
        for (int j = 0; j < n_it; ++j, ++it) {
          const int s = it % a.stages;
          mbar_wait(empty + s, ((it / a.stages) & 1) ^ 1);
          mbar_expect_tx(full + s, STAGE);
          unsigned char* st = ring + s * STAGE;
          tma_row(st, &ta, (s0 + j) * 128, SWAP ? n0 : m0, full + s);
          tma_row(st + AR * 128, &tb, (s0 + j) * 128, SWAP ? m0 : n0,
                  full + s);
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // The accumulator layout: register 4 j + 2 h + e at A row ra0 + 8 h and
  // B column cb0 + 8 j + e. A rows run over N when swapped (w's rows), B
  // columns over M.
  const int a_lim = SWAP ? a.N : a.M, b_lim = SWAP ? a.M : a.N;
  const float s_t = a.per_tensor ? a.xs[0] * a.ws[0] : 0.f;
  int acc[NR];
  float facc[INLINE ? NR : 1];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int tile, m0, n0, s0, n_it;
    unit(u, tile, m0, n0, s0, n_it);
    const int ra0 = (SWAP ? n0 : m0) + 64 * wg + 16 * warp + g;
    const int cb0 = (SWAP ? m0 : n0) + 2 * t;
    // The scales of the thread's two A rows, read once a unit (0 past the
    // edge, whose sums are 0).
    const float* a_sc = SWAP ? a.ws : a.xs;
    const float* b_sc = SWAP ? a.xs : a.ws;
    const float rs[2] = {ra0 < a_lim ? a_sc[ra0] : 0.f,
                         ra0 + 8 < a_lim ? a_sc[ra0 + 8] : 0.f};
    // float(v) * x_scale * w_scale, the reference's order of the products
    auto dequant = [&](int v, float r, float c) {
      return a.per_tensor ? static_cast<float>(v) * s_t
             : SWAP       ? static_cast<float>(v) * c * r
                          : static_cast<float>(v) * r * c;
    };
    // The scales of B columns cb0 + 8 j and + 1. The empty asm keeps the
    // compiler from hoisting every column's loads ahead of the loop, which
    // spilled the 128-column tiles.
    auto col_scales = [&](int j, float (&c)[2]) {
      asm volatile("" ::: "memory");
      const int cb = cb0 + 8 * j;
      c[0] = cb < b_lim ? b_sc[cb] : 0.f;
      c[1] = cb + 1 < b_lim ? b_sc[cb + 1] : 0.f;
    };
    // Stores v at A row ra and B column cb, inside the matrix.
    auto store = [&](float* base, int ra, int cb, float v) {
      if (ra < a_lim && cb < b_lim)
        base[SWAP ? static_cast<long long>(cb) * a.N + ra
                  : static_cast<long long>(ra) * a.N + cb] = v;
    };
#pragma unroll
    for (int i = 0; i < (INLINE ? NR : 1); ++i) facc[i] = 0.f;
    for (int j = 0; j < n_it; ++j, ++it) {
      const int s = it % a.stages;
      mbar_wait(full + s, (it / a.stages) & 1);
      const uint32_t sa = smem_u32(ring + s * STAGE) + wg * 8192;
      const uint32_t sb = smem_u32(ring + s * STAGE + AR * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_s8<BN>(acc, desc_kmajor(sa + kk * 32),
                     desc_kmajor(sb + kk * 32),
                     ((INLINE ? 0 : j) | kk) != 0);
      wgmma_commit();
      if constexpr (INLINE) {  // this slice's partial, scaled into facc
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          float c[2];
          col_scales(jj, c);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            facc[4 * jj + e] += dequant(acc[4 * jj + e], rs[e >> 1],
                                        c[e & 1]);
        }
      } else {
        wgmma_wait<1>();  // slice j - 1's products are done: free its stage
        if (j > 0 && lane == 0) mbar_arrive(empty + (it - 1) % a.stages);
      }
    }
    if constexpr (!INLINE) {
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + (it - 1) % a.stages);
    }

    if (!SWAP || a.splits == 1) {
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        float c[2] = {0.f, 0.f};
        if constexpr (!INLINE) col_scales(jj, c);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = INLINE ? facc[INLINE ? 4 * jj + e : 0]
                        : dequant(acc[4 * jj + e], rs[e >> 1], c[e & 1]);
        const int cb = cb0 + 8 * jj;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ra = ra0 + 8 * h;
          if (!SWAP && (a.N & 1) == 0 && ra < a_lim && cb + 1 < b_lim) {
            // two adjacent columns of one row: one 8-byte store
            *reinterpret_cast<float2*>(
                a.out + static_cast<long long>(ra) * a.N + cb) =
                make_float2(v[2 * h], v[2 * h + 1]);
          } else {
            store(a.out, ra, cb, v[2 * h]);
            store(a.out, ra, cb + 1, v[2 * h + 1]);
          }
        }
      }
      continue;
    }
    // Decode only (the host refuses splits at prefill): this split's
    // partial sums; the tile's last unit sums them all.
    const long long MN = static_cast<long long>(a.M) * a.N;
    float* part = reinterpret_cast<float*>(a.part);
#pragma unroll
    for (int i = 0; i < NR; ++i)
      store(part + (u / tiles) * MN, ra0 + 8 * ((i & 3) >> 1),
            cb0 + 8 * (i >> 2) + (i & 1),
            INLINE ? facc[INLINE ? i : 0] : __int_as_float(acc[i]));
    __threadfence();
    named_sync(1, 128 * W);
    if (threadIdx.x == 0)
      *last_block = atomicAdd(a.counters + tile, 1) == a.splits - 1;
    named_sync(1, 128 * W);
    if (!*last_block) continue;
    __threadfence();
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      float c[2];
      col_scales(jj, c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ra = ra0 + 8 * (e >> 1), cb = cb0 + 8 * jj + (e & 1);
        if (ra >= a_lim || cb >= b_lim) continue;
        const long long o = SWAP ? static_cast<long long>(cb) * a.N + ra
                                 : static_cast<long long>(ra) * a.N + cb;
        float v;
        if constexpr (INLINE) {
          v = 0.f;
          for (int z = 0; z < a.splits; ++z)
            v += __int_as_float(__ldcg(a.part + z * MN + o));
        } else {
          int sum = 0;
          for (int z = 0; z < a.splits; ++z) sum += __ldcg(a.part + z * MN + o);
          v = dequant(sum, rs[e >> 1], c[e & 1]);
        }
        a.out[o] = v;
      }
    }
  }
}

template <int W, int BN, bool SWAP, bool INLINE>
cudaError_t launch_wgmma(const CUtensorMap* maps, const WArgs& a, int smem,
                         cudaStream_t stream) {
  if constexpr (!wgmma_regs_fit(BN, INLINE)) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = w8a8_wgmma<W, BN, SWAP, INLINE>;
    static int configured = 48 * 1024;
    if (smem > configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      configured = smem;
    }
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, 128 * W + 32, smem);
    if (e != cudaSuccess) return e;
    constexpr int NB = SWAP ? 64 * W : BN, MB = SWAP ? BN : 64 * W;
    const long long units = static_cast<long long>((a.M + MB - 1) / MB) *
                            ((a.N + NB - 1) / NB) * a.splits;
    const long long slots =
        static_cast<long long>(gemm::sm_count()) * (per_sm > 0 ? per_sm : 1);
    const int grid = static_cast<int>(units < slots ? units : slots);
    if (grid <= 0) return cudaErrorInvalidValue;
    kern<<<grid, 128 * W + 32, smem, stream>>>(maps[0], maps[1], a);
    return cudaGetLastError();
  }
}

template <int W, int BN, bool SWAP>
cudaError_t wgmma_by_dequant(bool inl, const CUtensorMap* maps,
                             const WArgs& a, int smem, cudaStream_t s) {
  return inl ? launch_wgmma<W, BN, SWAP, true>(maps, a, smem, s)
             : launch_wgmma<W, BN, SWAP, false>(maps, a, smem, s);
}

// Decode: x's block_m rows are wgmma's N, w's block_n rows its M.
template <int W>
cudaError_t wgmma_swapped(int bm, bool inl, const CUtensorMap* maps,
                          const WArgs& a, int smem, cudaStream_t s) {
  if (bm == 8) return wgmma_by_dequant<W, 8, true>(inl, maps, a, smem, s);
  if (bm == 16) return wgmma_by_dequant<W, 16, true>(inl, maps, a, smem, s);
  if (bm == 32) return wgmma_by_dequant<W, 32, true>(inl, maps, a, smem, s);
  return cudaErrorInvalidValue;
}

// Prefill: x's block_m rows are wgmma's M, w's block_n rows its N.
template <int W>
cudaError_t wgmma_plain(int bn, bool inl, const CUtensorMap* maps,
                        const WArgs& a, int smem, cudaStream_t s) {
  if (bn == 64) return wgmma_by_dequant<W, 64, false>(inl, maps, a, smem, s);
  if (bn == 128)
    return wgmma_by_dequant<W, 128, false>(inl, maps, a, smem, s);
  if (bn == 256)
    return wgmma_by_dequant<W, 256, false>(inl, maps, a, smem, s);
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

// Dynamic shared memory of one w8a8_wgmma launch.
int matmul_w8a8_wgmma_smem_bytes(int block_m, int block_n, int num_stages) {
  return wgmma_smem(block_m, block_n, num_stages);
}

// The splits a launch with split_k runs (the workspace holds that many).
int matmul_w8a8_splits(int K, int split_k) {
  return effective_splits(K, split_k);
}

// int8 through wgmma and TMA, K a multiple of 16, x, w 16-byte aligned,
// K slices of 128. block_m 8, 16 or 32 (decode: the operands swap roles;
// block_n 64 or 128) or 64 or 128 (prefill; block_n 64, 128 or 256);
// num_stages 2 to 8; split_k >= 1 (above 1 at decode only), run as
// matmul_w8a8_splits(...) splits, which need `part` ((splits, M, N) 32-bit
// values) and `counters` (one int per output tile, all 0). Returns a
// cudaError_t (0 = launched); a combination the kernel does not
// instantiate or a tensor map TMA refuses returns cudaErrorInvalidValue.
int matmul_w8a8_wgmma_launch(const void* x, const void* w,
                             const float* x_scale, const float* w_scale,
                             float* out, int* part, int* counters, int M,
                             int N, int K, int block_m, int block_n,
                             int num_stages, int split_k, int inl,
                             int per_tensor, void* stream) {
  const bool swap = block_m <= 32;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || num_stages < 2 ||
      num_stages > 8 || split_k < 1 ||
      (swap && block_n != 64 && block_n != 128))
    return cudaErrorInvalidValue;
  const int smem = wgmma_smem(block_m, block_n, num_stages);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int splits = effective_splits(K, split_k);
  if (splits > 1 && (!swap || part == nullptr || counters == nullptr))
    return cudaErrorInvalidValue;
  const int per = ((K + 127) / 128 + split_k - 1) / split_k;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap xm, wm;
  if (!gemm::map2d(&xm, u8, 1, x, M, K, block_m, 128) ||
      !gemm::map2d(&wm, u8, 1, w, N, K, block_n, 128))
    return cudaErrorInvalidValue;
  const CUtensorMap maps[2] = {swap ? wm : xm, swap ? xm : wm};
  const WArgs a{x_scale,    w_scale, out, part,      counters, M, N, K,
                num_stages, splits,  per, per_tensor};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool il = inl != 0;
  if (swap)
    return block_n == 64 ? wgmma_swapped<1>(block_m, il, maps, a, smem, s)
                         : wgmma_swapped<2>(block_m, il, maps, a, smem, s);
  if (block_m == 64) return wgmma_plain<1>(block_n, il, maps, a, smem, s);
  if (block_m == 128) return wgmma_plain<2>(block_n, il, maps, a, smem, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
