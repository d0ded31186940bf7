// Blocked matmul for Hopper (sm_90a): x (M, K) @ y (K, N) with an f32
// accumulator, written in x's dtype, with a plain C interface.
//
// Replaces the TPU kernel `_matmul_kernel` of src/repro/kernels/matmul.py
// (one pallas_call): the registry's blocked GEMM, which the shipped tuning
// DB tunes at 8192^3 in bf16 and the reference's tuning benchmarks drive.
//
//   x    (M, K)  bf16 or f32, row-major (K contiguous)
//   y    (K, N)  the same dtype, row-major (N contiguous)
//   out  (M, N)  x's dtype, row-major
//
// Bound: at 8192^3 bf16 (`mm8k`) operations, 2 M K N = 1.10 TFLOP at
// 989 TFLOP/s (1.1117 ms) against 403 MB at 3.35 TB/s (0.12 ms); in f32
// (`m256`) operations too, at the CUDA cores' 67 TFLOP/s. So the design
// keeps the tensor cores fed from shared memory and reads each operand
// from HBM as few times as the tiles allow. Three kernels, chosen by the
// wrapper from the dtype and the layout:
//
// bf16 where TMA can read x and y (rows of 16-byte multiples, 16-byte
// aligned bases): matmul_wgmma, the tools of gemm.cuh and hopper.cuh.
//
//   * A persistent grid, one block per SM (more where the shared memory
//     allows), walks the block_m x block_n output tiles in groups of 8 row
//     panels, column-major inside a group, so the y panels a wave reads
//     stay in L2 across the group's rows.
//   * One producer warp keeps a ring of num_stages K slices in flight by
//     TMA (128-byte swizzle): a slice is x's block_m rows and y's 64 rows
//     of block_n, 64 values of K each; each slice's arrival completes a
//     full mbarrier, every consumer warp's release an empty one. It runs
//     ahead across tiles, so the next tile's first slices load while the
//     consumers store the last one. Rows, columns and K past the matrices
//     are zero-filled by TMA: ragged M, N and K need no padded copy.
//   * One or two consumer warpgroups of 64 rows each issue wgmma
//     m64n{block_n}k16 from shared memory: x K-major, y MN-major (the
//     transpose bit of 16-bit types), so y needs no transposed copy. Slice
//     t is issued, then wgmma.wait_group 1 lets slice t - 1's products
//     finish and its stage is released while slice t runs: the tensor cores
//     never wait on a release. The f32 accumulators (64 x block_n a
//     warpgroup: 128 registers a thread at block_n 256) stay in registers
//     across K.
//   * The epilogue rounds them to bf16 into a 128-byte-swizzled staging
//     tile (conflict-free 4-byte writes) and stores it by TMA, which drops
//     what falls past M and N; the staging tile is reused once the previous
//     tile's store has read it.
//
// bf16 that TMA cannot read (K or N rows not 16-byte multiples, as K 300,
// 45 and 1030 or N 29; a base off 16 bytes): tile_bf16, one block per
// tile, mma.sync m16n8k16 fed by a cp.async ring:
//
//   * the TPU grid's sequential K axis is a loop over slices of block_k,
//     a ring of num_stages cp.async stages (slice kt + stages - 1 is copied
//     while slice kt is multiplied); blocks in the grouped order above;
//   * copies of 16 bytes (8, 4, or 2 by plain loads, where K or N or a base
//     pointer allows no wider copy), one row chunk each; rows past M,
//     columns past N and slices past K are zero-filled by the copy itself
//     (src-size 0);
//   * each warp owns a (block_m / warps_m) x (block_n / warps_n) sub-tile;
//     A comes from the row-major x tile through ldmatrix, B from the
//     row-major (K, N) y tile through ldmatrix.trans; staged rows carry 16
//     bytes of padding, so the eight 16-byte rows of each ldmatrix fall on
//     distinct banks.
//
// f32: tile_f32, IEEE FMAs on the CUDA cores (wgmma has no IEEE f32, and
// TF32 would miss the reference's 1e-4), each thread a register tile of
// rows and columns strided across the block, so a warp's shared-memory
// reads broadcast or fall on consecutive banks and its stores are
// coalesced; the same cp.async ring as tile_bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;  // 227 KB opt-in per block
constexpr int kGroupM = 8;        // row panels a group of blocks walks

// Elements of padding after each staged row: 16 bytes.
template <typename T>
__host__ __device__ constexpr int pad_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// Bytes of dynamic shared memory: `stages` copies of a block_m x block_k x
// tile and a block_k x block_n y tile, each row padded by 16 bytes.
int smem_bytes(int itemsize, int bm, int bn, int bk, int stages) {
  const int pad = 16 / itemsize;
  return stages * (bm * (bk + pad) + bk * (bn + pad)) * itemsize;
}

// A thread's f32 accumulators stay within 128 registers.
__host__ __device__ constexpr bool regs_fit(int bm, int bn, int warps) {
  return bm * bn <= 4096 * warps;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One chunk of `vec` bytes global -> shared; `ok` false fills the chunk
// with zeros and reads nothing. Two-byte chunks (a bf16 row that is not
// 4-byte aligned) go by a plain load and store.
__device__ __forceinline__ void cp_chunk(void* dst, const void* src, int vec,
                                         bool ok) {
  const uint32_t d = smem_addr(dst);
  const int bytes = ok ? vec : 0;
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else if (vec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else {
    *static_cast<uint16_t*>(dst) =
        ok ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until at most stages - 2 groups are in flight: the oldest slice of
// the ring has landed.
__device__ __forceinline__ void cp_wait_ring(int stages) {
  if (stages <= 2) {
    cp_wait<0>();
  } else if (stages == 3) {
    cp_wait<1>();
  } else {
    cp_wait<2>();
  }
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

// Four 8 x 8 bf16 matrices: lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each, row l / 4 at columns 2 (l % 4) and + 1 (with
// .trans: column l / 4 at rows 2 (l % 4) and + 1): the mma.sync fragments.
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

__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

struct Args {
  const void* x;
  const void* y;
  void* out;
  int M, N, K, stages, vx, vy;  // vx, vy: copy bytes for x rows and y rows
};

// Stage a ROWS x COLS tile whose first element is global (r0, c0) of a
// row-major matrix with `ld` elements a row (rows from `rows` on and
// columns from `cols` on zero-filled) at row stride COLS + pad, in chunks
// of `vec` bytes. Rows of 16-byte chunks (the aligned case) take an
// unrolled loop with compile-time offsets; other widths a plain loop.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int ld,
                                           int r0, int rows, int c0,
                                           int cols, int vec) {
  constexpr int RS = COLS + pad_elems<T>();
  const T* base = src + static_cast<long long>(r0) * ld + c0;
  if (vec == 16) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    constexpr int PR = COLS / E, TOTAL = ROWS * PR;
#pragma unroll
    for (int i = 0; i < (TOTAL + THREADS - 1) / THREADS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      if (TOTAL % THREADS != 0 && c >= TOTAL) break;
      const int r = c / PR, cc = (c % PR) * E;
      const bool ok = r0 + r < rows && c0 + cc < cols;
      cp_chunk(dst + r * RS + cc,
               ok ? base + static_cast<long long>(r) * ld + cc : src, 16, ok);
    }
  } else {
    const int e = vec / static_cast<int>(sizeof(T));
    const int pr = COLS / e;
    for (int c = threadIdx.x; c < ROWS * pr; c += THREADS) {
      const int r = c / pr, cc = (c - r * pr) * e;
      const bool ok = r0 + r < rows && c0 + cc < cols;
      cp_chunk(dst + r * RS + cc,
               ok ? base + static_cast<long long>(r) * ld + cc : src, vec,
               ok);
    }
  }
}

// Stage slice kt of the tile's x rows (BM x BK) and y rows (BK x BN).
template <typename T, int BM, int BN, int BK, int THREADS>
__device__ __forceinline__ void load_slice(const Args& a, T* As, T* Bs,
                                           int m0, int n0, int kt) {
  const int k0 = kt * BK;
  stage_tile<T, BM, BK, THREADS>(As, static_cast<const T*>(a.x), a.K, m0,
                                 a.M, k0, a.K, a.vx);
  stage_tile<T, BK, BN, THREADS>(Bs, static_cast<const T*>(a.y), a.N, k0,
                                 a.K, n0, a.N, a.vy);
}

// Warps along M for the tensor-core layout: 2 of 4; of 8, 4 when the tile
// is at least as tall as it is wide, else 2.
__host__ __device__ constexpr int warps_m(int bm, int bn, int warps) {
  return warps == 4 ? 2 : (bm >= bn ? 4 : 2);
}

// The bf16 tile: each warp's 16 x 8 MMA tiles, accumulated over the staged
// slices, then rounded to bf16 and stored.
template <int BM, int BN, int BK, int WARPS>
__device__ __forceinline__ void tile_bf16(const Args& a, bf16* smem, int m0,
                                          int n0) {
  constexpr int RA = BK + 8, RB = BN + 8;
  constexpr int WMW = warps_m(BM, BN, WARPS), WNW = WARPS / WMW;
  constexpr int WM = BM / WMW, WN = BN / WNW;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp layout");
  const int stage_elems = BM * RA + BK * RB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / WNW) * WM, wn0 = (warp % WNW) * WN;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_k = (a.K + BK - 1) / BK;
  for (int s = 0; s < a.stages - 1; ++s) {
    if (s < n_k) {
      bf16* st = smem + s * stage_elems;
      load_slice<bf16, BM, BN, BK, WARPS * 32>(a, st, st + BM * RA, m0, n0,
                                              s);
    }
    cp_commit();
  }
  // lane l addresses row l % 16 at column 8 (l / 16) of a 16 x 16 block:
  // matrices (rows 0-7, 8-15) x (columns 0-7, 8-15) in fragment order
  const int lr = lane % 16, lc = (lane / 16) * 8;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_wait_ring(a.stages);
    __syncthreads();  // slice kt landed; slice kt - 1's stage is free
    const int pf = kt + a.stages - 1;
    if (pf < n_k) {
      bf16* st = smem + (pf % a.stages) * stage_elems;
      load_slice<bf16, BM, BN, BK, WARPS * 32>(a, st, st + BM * RA, m0, n0,
                                              pf);
    }
    cp_commit();
    const bf16* As = smem + (kt % a.stages) * stage_elems;
    const bf16* Bs = As + BM * RA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], As + (wm0 + i * 16 + lr) * RA + kk + lc);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bfr[4];  // B of n-tiles j (0, 1) and j + 1 (2, 3)
        ldmatrix_x4_trans(bfr, Bs + (kk + lr) * RB + wn0 + j * 8 + lc);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], af[i], bfr);
          mma_bf16(acc[i][j + 1], af[i], bfr + 2);
        }
      }
    }
  }

  bf16* out = static_cast<bf16*>(a.out);
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (a.N & 1) == 0;  // (row, even col) is 4-byte aligned
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int row = m0 + wm0 + i * 16 + g + h * 8;
        const int col = n0 + wn0 + j * 8 + 2 * t;
        if (row >= a.M || col >= a.N) continue;
        bf16* p = out + static_cast<long long>(row) * a.N + col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pairs && col + 1 < a.N) {
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          store1(p, v0);
          if (col + 1 < a.N) store1(p + 1, v1);
        }
      }
}

// The f32 tile: each thread TM x TN outputs at rows ty + i * THR_M and
// columns tx + j * THR_N, summed by IEEE FMAs in k order.
template <int BM, int BN, int BK, int WARPS>
__device__ __forceinline__ void tile_f32(const Args& a, float* smem, int m0,
                                         int n0) {
  constexpr int RA = BK + 4, RB = BN + 4;
  constexpr int P = BM * BN / (32 * WARPS);  // outputs a thread
  constexpr int TM = P >= 128 ? 16 : P >= 64 ? 8 : 4;
  constexpr int TN = P / TM;
  constexpr int THR_N = BN / TN, THR_M = BM / TM;
  static_assert(THR_M * THR_N == 32 * WARPS && BM % TM == 0 && BN % TN == 0,
                "thread layout");
  const int stage_elems = BM * RA + BK * RB;
  const int tx = threadIdx.x % THR_N, ty = threadIdx.x / THR_N;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_k = (a.K + BK - 1) / BK;
  for (int s = 0; s < a.stages - 1; ++s) {
    if (s < n_k) {
      float* st = smem + s * stage_elems;
      load_slice<float, BM, BN, BK, WARPS * 32>(a, st, st + BM * RA, m0, n0,
                                              s);
    }
    cp_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_wait_ring(a.stages);
    __syncthreads();
    const int pf = kt + a.stages - 1;
    if (pf < n_k) {
      float* st = smem + (pf % a.stages) * stage_elems;
      load_slice<float, BM, BN, BK, WARPS * 32>(a, st, st + BM * RA, m0, n0,
                                              pf);
    }
    cp_commit();
    const float* As = smem + (kt % a.stages) * stage_elems;
    const float* Bs = As + BM * RA;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[(ty + i * THR_M) * RA + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k * RB + tx + j * THR_N];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + i * THR_M;
    if (row >= a.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * THR_N;
      if (col < a.N) out[static_cast<long long>(row) * a.N + col] = acc[i][j];
    }
  }
}

template <typename T, int BM, int BN, int BK, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) matmul_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  int pid_m, pid_n;
  gemm::tile_coords(blockIdx.x, (a.M + BM - 1) / BM, (a.N + BN - 1) / BN,
                    kGroupM, pid_m, pid_n);
  if constexpr (sizeof(T) == 2) {
    tile_bf16<BM, BN, BK, WARPS>(a, smem, pid_m * BM, pid_n * BN);
  } else {
    tile_f32<BM, BN, BK, WARPS>(a, smem, pid_m * BM, pid_n * BN);
  }
}

template <typename T, int BM, int BN, int BK, int WARPS>
cudaError_t launch(const Args& a, int smem, cudaStream_t stream) {
  if constexpr (!regs_fit(BM, BN, WARPS)) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = matmul_kernel<T, BM, BN, BK, WARPS>;
    static int configured = 48 * 1024;
    if (smem > configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      configured = smem;
    }
    const long long blocks =
        static_cast<long long>((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kern<<<static_cast<unsigned>(blocks), WARPS * 32, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

template <typename T, int BM, int BN, int BK>
cudaError_t by_warps(int warps, const Args& a, int smem, cudaStream_t s) {
  if (warps == 4) return launch<T, BM, BN, BK, 4>(a, smem, s);
  if (warps == 8) return launch<T, BM, BN, BK, 8>(a, smem, s);
  return cudaErrorInvalidValue;
}

template <typename T, int BM, int BN>
cudaError_t by_bk(int bk, int warps, const Args& a, int smem,
                  cudaStream_t s) {
  if (bk == 32) return by_warps<T, BM, BN, 32>(warps, a, smem, s);
  if (bk == 64) return by_warps<T, BM, BN, 64>(warps, a, smem, s);
  return cudaErrorInvalidValue;
}

template <typename T, int BM>
cudaError_t by_bn(int bn, int bk, int warps, const Args& a, int smem,
                  cudaStream_t s) {
  if (bn == 64) return by_bk<T, BM, 64>(bk, warps, a, smem, s);
  if (bn == 128) return by_bk<T, BM, 128>(bk, warps, a, smem, s);
  if (bn == 256) return by_bk<T, BM, 256>(bk, warps, a, smem, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_bm(int bm, int bn, int bk, int warps, const Args& a, int smem,
                  cudaStream_t s) {
  if (bm == 64) return by_bn<T, 64>(bn, bk, warps, a, smem, s);
  if (bm == 128) return by_bn<T, 128>(bn, bk, warps, a, smem, s);
  if (bm == 256) return by_bn<T, 256>(bn, bk, warps, a, smem, s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ wgmma branch

// Shared memory of matmul_wgmma: 1024 bytes of alignment slack, 256 of
// mbarriers, `stages` K slices of an x tile (bm rows) and a y tile (64 rows
// of bn), 128 bytes a row, and the bf16 staging tile of the epilogue.
int wgmma_smem(int bm, int bn, int stages) {
  return 1024 + 256 + stages * (bm + bn) * 128 + bm * bn * 2;
}

struct WArgs {
  int M, N, K, stages;
};

// W: consumer warpgroups (64 rows each); BN: columns a tile. Warpgroup W
// (threads 128 W ...) is the producer warp.
template <int W, int BN>
__global__ void __launch_bounds__(128 * W + 32, 1)
    matmul_wgmma(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap ty,
                 const __grid_constant__ CUtensorMap to, const WArgs a) {
  using namespace hopper;
  using namespace gemm;
  constexpr int BM = 64 * W;
  constexpr int XBYTES = BM * 128;             // a slice of the x tile
  constexpr int STAGE = XBYTES + BN * 128;     // and of the y tile
  constexpr int NC = BN / 64;                  // 64-column blocks
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* ring = align1024(smem_wg);
  unsigned char* stage_out = ring + a.stages * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + BM * BN * 2);
  uint64_t* empty = full + a.stages;

  const int tiles_m = (a.M + BM - 1) / BM, tiles_n = (a.N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int n_k = (a.K + 63) / 64;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    tma_prefetch(&tx);
    tma_prefetch(&ty);
    tma_prefetch(&to);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * W);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == W) {  // the producer warp: one thread issues every load
    if (threadIdx.x == 128 * W) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int pm, pn;
        tile_coords(tile, tiles_m, tiles_n, kGroupM, pm, pn);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % a.stages;
          mbar_wait(empty + s, ((it / a.stages) & 1) ^ 1);
          mbar_expect_tx(full + s, STAGE);
          unsigned char* st = ring + s * STAGE;
          tma_row(st, &tx, kt * 64, pm * BM, full + s);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_row(st + XBYTES + c * 8192, &ty, pn * BN + c * 64, kt * 64,
                    full + s);
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* my_out = stage_out + wg * NC * 8192;
  float acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int pm, pn;
    tile_coords(tile, tiles_m, tiles_n, kGroupM, pm, pn);
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int s = it % a.stages;
      mbar_wait(full + s, (it / a.stages) & 1);
      const uint32_t xa = smem_u32(ring + s * STAGE) + wg * 8192;
      const uint32_t ya = smem_u32(ring + s * STAGE + XBYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16<BN>(acc, desc_kmajor(xa + kk * 32),
                       desc_mn(ya + kk * 2048, 8192), (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // slice kt - 1's products are done: free its stage
      if (kt > 0 && lane == 0) mbar_arrive(empty + (it - 1) % a.stages);
    }
    wgmma_wait<0>();
    hopper::fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + (it - 1) % a.stages);

    // The warpgroup's 64 rows, rounded to bf16 into its staging tile (NC
    // blocks of 64 x 64, swizzled as the map stores them), then stored by
    // its first thread, one TMA box a block.
    if (leader) bulk_wait_read();  // the last tile's store has read it
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const int c = (8 * j) % 64 + 2 * t;  // column in block j / 8
        *reinterpret_cast<uint32_t*>(
            my_out + (j / 8) * 8192 + r * 128 +
            ((((c * 2) >> 4) ^ (r & 7)) << 4) + ((c * 2) & 15)) =
            pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    fence_async_smem();
    named_sync(1 + wg, 128);
    if (leader) {
      const int r0 = pm * BM + 64 * wg;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (r0 < a.M && pn * BN + c * 64 < a.N)
          tma_store(&to, my_out + c * 8192, pn * BN + c * 64, r0);
      bulk_commit();
    }
  }
  if (leader) bulk_wait();
}

template <int W, int BN>
cudaError_t launch_wgmma(const CUtensorMap* maps, const WArgs& a, int smem,
                         cudaStream_t stream) {
  auto kern = matmul_wgmma<W, BN>;
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
  const long long tiles = static_cast<long long>((a.M + 64 * W - 1) /
                                                 (64 * W)) *
                          ((a.N + BN - 1) / BN);
  const long long slots =
      static_cast<long long>(gemm::sm_count()) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  if (grid <= 0) return cudaErrorInvalidValue;
  kern<<<grid, 128 * W + 32, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

template <int W>
cudaError_t wgmma_by_bn(int bn, const CUtensorMap* maps, const WArgs& a,
                        int smem, cudaStream_t s) {
  if (bn == 64) return launch_wgmma<W, 64>(maps, a, smem, s);
  if (bn == 128) return launch_wgmma<W, 128>(maps, a, smem, s);
  if (bn == 256) return launch_wgmma<W, 256>(maps, a, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (itemsize 2 for bf16, 4 for f32).
int matmul_smem_bytes(int itemsize, int block_m, int block_n, int block_k,
                      int num_stages) {
  return smem_bytes(itemsize, block_m, block_n, block_k, num_stages);
}

// dtype 0 = float32, 1 = bfloat16; block_m and block_n in {64, 128, 256},
// block_k 32 or 64, num_warps 4 or 8, num_stages 2 to 4; vx and vy the copy
// widths in bytes of x's and y's rows (16, 8, 4, or 2 for bf16: each
// divides its row's bytes and its base pointer's alignment). Returns a
// cudaError_t (0 = launched); a tile whose accumulators would not fit the
// registers returns cudaErrorInvalidValue.
int matmul_launch(const void* x, const void* y, void* out, int M, int N,
                  int K, int dtype, int block_m, int block_n, int block_k,
                  int num_warps, int num_stages, int vx, int vy,
                  void* stream) {
  const int itemsize = dtype == 1 ? 2 : 4;
  auto vec_ok = [&](int v, int row_elems) {
    return (v == 16 || v == 8 || v == 4 || (v == 2 && itemsize == 2)) &&
           (row_elems * itemsize) % v == 0;
  };
  if (M <= 0 || N <= 0 || K <= 0 || (dtype != 0 && dtype != 1) ||
      num_stages < 2 || num_stages > 4 || !vec_ok(vx, K) || !vec_ok(vy, N))
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(itemsize, block_m, block_n, block_k,
                              num_stages);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const Args a{x, y, out, M, N, K, num_stages, vx, vy};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return by_bm<bf16>(block_m, block_n, block_k, num_warps, a, smem, s);
  return by_bm<float>(block_m, block_n, block_k, num_warps, a, smem, s);
}

// Dynamic shared memory of one matmul_wgmma launch.
int matmul_wgmma_smem_bytes(int block_m, int block_n, int num_stages) {
  return wgmma_smem(block_m, block_n, num_stages);
}

// bf16 through wgmma and TMA: block_m 64 or 128 (one or two consumer
// warpgroups), block_n 64, 128 or 256, K slices of 64, num_stages 2 to 4;
// K and N multiples of 8 (16-byte rows), x, y and out 16-byte aligned.
// Returns a cudaError_t (0 = launched); a tile the kernel does not
// instantiate or a tensor map TMA refuses returns cudaErrorInvalidValue.
int matmul_wgmma_launch(const void* x, const void* y, void* out, int M,
                        int N, int K, int block_m, int block_n,
                        int num_stages, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 ||
      (block_m != 64 && block_m != 128) || num_stages < 2 || num_stages > 4)
    return cudaErrorInvalidValue;
  const int smem = wgmma_smem(block_m, block_n, num_stages);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[3];
  if (!gemm::map2d(&maps[0], bf, 2, x, M, K, block_m, 64) ||
      !gemm::map2d(&maps[1], bf, 2, y, K, N, 64, 64) ||
      !gemm::map2d(&maps[2], bf, 2, out, M, N, 64, 64))
    return cudaErrorInvalidValue;
  const WArgs a{M, N, K, num_stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_m == 64) return wgmma_by_bn<1>(block_n, maps, a, smem, s);
  return wgmma_by_bn<2>(block_n, maps, a, smem, s);
}

}  // extern "C"
