"""Blocked matmul: the wrapper around ``csrc/matmul.cu``.

The CUDA C++ kernels replace the TPU kernel ``_matmul_kernel`` of
``src/repro/kernels/matmul.py``: x (M, K) @ y (K, N) with an f32
accumulator, written in x's dtype. The source's header note says what
bounds it on Hopper and how its design answers that. It is built and
loaded like the other kernels (``kernels.build``).

Layout: x and y row-major and contiguous, of one dtype (bfloat16 or
float32; any other is refused by name). Ragged M, N and K are masked
inside the kernels, so no padded copy is made.

Three kernels, the path chosen by ``path`` from the dtype and the layout
alone (never after a failure: a failed build or launch raises):

* ``"wgmma"``: bf16 whose rows TMA can read (``tma_layout_error`` is
  None: K and N multiples of 8, 16-byte aligned bases). A persistent
  grid, a producer warp feeding a TMA ``mbarrier`` ring, one or two
  consumer warpgroups of 64 rows issuing ``wgmma``, a TMA store.
* ``"mma_sync"``: the other bf16 layouts (K 300, N 29, ...): ``mma.sync``
  fed by a ``cp.async`` ring.
* ``"fma"``: float32, IEEE FMAs (the reference's 1e-4 rules out TF32).

Tunables (``kernels.ops.MATMUL``): ``block_m``, ``block_n``, ``block_k``
(the reference's names), ``num_warps`` and ``num_stages`` (the depth of
the ring). On the wgmma path ``block_m`` is 64 or 128 (one or two
consumer warpgroups, so ``num_warps`` is block_m / 16 and is not read)
and ``block_k`` is 64 (one 128-byte row of K a slice). Blocks are clamped
to the shape before the launch (the kernels never stage a tile wider than
the matrix rounded up to its tile grid), as ``ops`` canonicalises them.
Tensors on the CPU take the plain version ``kernels.ref.matmul``; a CUDA
tensor launches a kernel or raises. ``matmul.launches`` counts launches,
``matmul.path_launches`` them by path.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KernelLibrary

BLOCK_M = (64, 128, 256)
WGMMA_BLOCK_M = (64, 128)        # one or two consumer warpgroups
WGMMA_BLOCK_K = 64               # one 128-byte row of bf16 K a slice
BLOCK_N = (64, 128, 256)
BLOCK_K = (32, 64)
NUM_WARPS = (4, 8)
NUM_STAGES = (2, 3, 4)
MAX_SMEM_BYTES = 232448          # 227 KB: the opt-in per-block limit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.matmul_launch.argtypes = [vp] * 3 + [i32] * 11 + [vp]
    lib.matmul_launch.restype = i32
    lib.matmul_smem_bytes.argtypes = [i32] * 5
    lib.matmul_smem_bytes.restype = i32
    lib.matmul_wgmma_launch.argtypes = [vp] * 3 + [i32] * 6 + [vp]
    lib.matmul_wgmma_launch.restype = i32
    lib.matmul_wgmma_smem_bytes.argtypes = [i32] * 3
    lib.matmul_wgmma_smem_bytes.restype = i32


LIB = KernelLibrary("matmul", _declare)


def smem_bytes(itemsize: int, block_m: int, block_n: int, block_k: int,
               num_stages: int) -> int:
    """Dynamic shared memory of one launch — the same formula as
    ``matmul_smem_bytes`` in the CUDA source: ``num_stages`` copies of a
    block_m x block_k x tile and a block_k x block_n y tile, each row
    padded by 16 bytes."""
    pad = 16 // itemsize
    tiles = block_m * (block_k + pad) + block_k * (block_n + pad)
    return num_stages * tiles * itemsize


def regs_fit(block_m: int, block_n: int, num_warps: int) -> bool:
    """A thread's f32 accumulators stay within 128 registers — the tiles
    the source instantiates (``mma.sync`` and FMA kernels)."""
    return block_m * block_n <= 4096 * num_warps


def wgmma_smem_bytes(block_m: int, block_n: int, num_stages: int) -> int:
    """Dynamic shared memory of one wgmma launch — the same formula as
    ``wgmma_smem`` in the CUDA source: 1024 bytes of alignment slack, 256
    of mbarriers, ``num_stages`` slices of block_m x rows and 64 y rows of
    block_n (128 bytes a row), and the bf16 block_m x block_n staging tile
    of the TMA store."""
    return (1024 + 256 + num_stages * (block_m + block_n) * 128
            + block_m * block_n * 2)


def wgmma_tile_ok(block_m: int, block_k: int, num_warps: int) -> bool:
    """The tiles the wgmma kernel instantiates: one or two consumer
    warpgroups of 64 rows (``num_warps`` 4 per warpgroup), K slices of 64.
    A thread's f32 accumulators are block_n / 2 <= 128."""
    return (block_m in WGMMA_BLOCK_M and block_k == WGMMA_BLOCK_K
            and num_warps == block_m // 16)


def tma_layout_error(K: int, N: int, itemsize: int, x_ptr: int = 0,
                     y_ptr: int = 0) -> Optional[str]:
    """Why TMA cannot read x (M, K) and y (K, N), both row-major and
    contiguous, or None: rows of 16-byte multiples and 16-byte aligned
    bases (the output is a fresh, aligned tensor of N columns)."""
    if K * itemsize % 16:
        return f"x rows of K {K} are not 16-byte multiples"
    if N * itemsize % 16:
        return f"y rows of N {N} are not 16-byte multiples"
    if x_ptr % 16 or y_ptr % 16:
        return "the bases must be 16-byte aligned"
    return None


def path(dtype: torch.dtype, K: int, N: int, x_ptr: int = 0,
         y_ptr: int = 0) -> str:
    """The kernel a launch takes, from the dtype and the layout alone:
    ``"fma"`` (float32), ``"wgmma"`` (bf16 that TMA can read) or
    ``"mma_sync"`` (any other bf16)."""
    if dtype != torch.bfloat16:
        return "fma"
    return ("wgmma" if tma_layout_error(K, N, 2, x_ptr, y_ptr) is None
            else "mma_sync")


def clamp_blocks(block_m: int, block_n: int, block_k: int, M: int, N: int,
                 K: int, route: str = "mma_sync") -> Tuple[int, int, int]:
    """The tile the kernel launches: each block clamped to the smallest
    value of its domain that covers its dimension (a 200-row x takes
    block_m 256, a K of 16 block_k 32); on the wgmma path block_m to the
    warpgroups (64 or 128) and block_k stays 64, the width of a TMA box."""
    def cover(block, n, domain):
        return min([block] + [v for v in domain if v >= n])
    if route == "wgmma":
        return (cover(block_m, M, WGMMA_BLOCK_M), cover(block_n, N, BLOCK_N),
                block_k)
    return (cover(block_m, M, BLOCK_M), cover(block_n, N, BLOCK_N),
            cover(block_k, K, BLOCK_K))


def _copy_bytes(row_elems: int, itemsize: int, ptr: int) -> int:
    """The widest copy (16, 8, 4 or 2 bytes) that divides a row's bytes and
    the base pointer's alignment."""
    return next(v for v in (16, 8, 4, 2, 1)
                if (row_elems * itemsize) % v == 0 and ptr % v == 0)


def matmul(x: torch.Tensor, y: torch.Tensor, *, block_m: int = 128,
           block_n: int = 128, block_k: int = 64, num_warps: int = 8,
           num_stages: int = 3) -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N) in x's dtype, f32 accumulation."""
    errors = [
        (x.dim() == 2 and y.dim() == 2, "x and y must be matrices"),
        (x.dtype == y.dtype, f"x {x.dtype} and y {y.dtype} differ"),
    ]
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("matmul: " + "; ".join(bad))
    M, K = x.shape
    K2, N = y.shape
    if K != K2:
        raise ValueError(f"matmul: x (M, {K}) and y ({K2}, N) disagree on K")
    if not x.is_cuda:
        return ref.matmul(x, y)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"matmul: dtype {x.dtype} is not supported on the "
                         "card (bfloat16 or float32)")
    route = path(x.dtype, K, N, x.data_ptr(), y.data_ptr())
    bm, bn, bk = clamp_blocks(block_m, block_n, block_k, M, N, K, route)
    itemsize = x.element_size()
    vx = _copy_bytes(K, itemsize, x.data_ptr())
    vy = _copy_bytes(N, itemsize, y.data_ptr())
    errors = [
        (M > 0 and N > 0 and K > 0, "an empty matrix"),
        (x.is_contiguous() and y.is_contiguous(),
         "x and y must be contiguous"),
        (y.is_cuda and y.device == x.device, "y on x's device"),
        (block_m in BLOCK_M, f"block_m {block_m} (of {BLOCK_M})"),
        (block_n in BLOCK_N, f"block_n {block_n} (of {BLOCK_N})"),
        (block_k in BLOCK_K, f"block_k {block_k} (of {BLOCK_K})"),
        (num_warps in NUM_WARPS, f"num_warps {num_warps} (of {NUM_WARPS})"),
        (num_stages in NUM_STAGES,
         f"num_stages {num_stages} (of {NUM_STAGES})"),
        (vx >= 2 and vy >= 2, "base pointers must be 2-byte aligned"),
    ]
    if route == "wgmma":
        errors.append((bm in WGMMA_BLOCK_M and bk == WGMMA_BLOCK_K,
                       f"the wgmma kernel takes block_m {WGMMA_BLOCK_M} "
                       f"(after clamping: {bm}) and block_k "
                       f"{WGMMA_BLOCK_K} (after clamping: {bk})"))
        smem = wgmma_smem_bytes(bm, bn, num_stages)
    else:
        errors.append((regs_fit(bm, bn, num_warps),
                       f"block_m {bm} x block_n {bn} accumulators over "
                       f"{num_warps} warps do not fit the registers"))
        smem = smem_bytes(itemsize, bm, bn, bk, num_stages)
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("matmul: " + "; ".join(bad))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"matmul: {smem} bytes of shared memory > "
                         f"{MAX_SMEM_BYTES} ({route})")
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = LIB.load()
    if route == "wgmma":
        err = lib.matmul_wgmma_launch(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K, bm, bn,
            num_stages, stream)
    else:
        err = lib.matmul_launch(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K,
            _DTYPE_CODE[x.dtype], bm, bn, bk, num_warps, num_stages, vx, vy,
            stream)
    if err != 0:
        raise RuntimeError(f"matmul launch failed ({route}): cudaError "
                           f"{err}")
    matmul.launches += 1
    matmul.path_launches[route] += 1
    return out


matmul.launches = 0
matmul.path_launches = {"wgmma": 0, "mma_sync": 0, "fma": 0}
