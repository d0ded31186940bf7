"""The w8a8 GEMM: the wrapper around ``csrc/matmul_w8a8.cu``.

The CUDA C++ kernels replace the TPU kernels ``_epilogue_kernel`` and
``_inline_kernel`` of ``src/repro/kernels/matmul_int8.py``: x (M, K) int8
times w (K, N) int8 on the int8 tensor cores, dequantized by per-channel
or per-tensor f32 scales, either once at the store from the exact int32
sum (``dequant="epilogue"``) or a K slice at a time into an f32 sum
(``"inline"``). The source's header note says what bounds it on Hopper
and how its design answers that. It is built and loaded like the other
kernels (``kernels.build``).

Layout: w is the (K, N) view, strides (1, K), of an (N, K) contiguous
tensor (``quant.qtensor.k_major``, how ``QTensor`` stores a weight): each
output column's K values are contiguous, as the tensor cores' int8 B
operand wants them. A CUDA ``w`` in any other layout is refused, not
copied.

Two kernels, the path chosen by ``path`` from the layout alone (never
after a failure: a failed build or launch raises):

* ``"wgmma"``: K a multiple of 16 and 16-byte aligned bases
  (``tma_layout_error`` is None). A producer warp feeds a TMA
  ``mbarrier`` ring; consumer warpgroups issue ``wgmma`` with both
  operands K-major. At block_m 8, 16 or 32 (decode) the operands swap
  roles (w's block_n rows are wgmma's M, 64 a warpgroup) and K splits
  ``split_k`` ways into a workspace that the tile's last block sums.
* ``"mma_sync"``: any other K (such as 200): ``mma.sync`` fed by a
  two-stage ``cp.async`` ring; ``num_stages`` and ``split_k`` are not
  read there.

Tunables (``kernels.ops.MATMUL_W8A8``): ``block_m``, ``block_n``,
``block_k``, ``num_warps`` (the mma.sync kernel's; on the wgmma path the
tile fixes the warpgroups and it is not read), ``num_stages``,
``split_k``, ``dequant``, and ``scale_gran``, which the operands pin.
Blocks are clamped to the shape before the launch, as ``ops``
canonicalises them. Tensors on the CPU take the plain version
``kernels.ref.matmul_w8a8``; a CUDA tensor launches a kernel or raises.
``matmul_w8a8.launches`` counts launches, ``matmul_w8a8.path_launches``
them by path.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KernelLibrary

BLOCK_M = (8, 16, 32, 64, 128)
BLOCK_N = (64, 128, 256)
BLOCK_K = (64, 128)
NUM_WARPS = (4, 8)
NUM_STAGES = (2, 3, 4, 6, 8)
SPLIT_K = (1, 2, 4, 8, 16)
MMA_K = 32                       # the K depth of one int8 MMA
MAX_SMEM_BYTES = 232448          # 227 KB: the opt-in per-block limit
PAD = 16                         # bytes after each staged row (mma.sync)
MMA_BLOCK_M = (16, 32, 64, 128)  # the mma.sync kernel's row tiles
SWAP_BLOCK_M = (8, 16, 32)       # wgmma, decode: x's rows are wgmma's N
SWAP_BLOCK_N = (64, 128)         # ... and w's rows its M, 64 a warpgroup
WGMMA_BLOCK_K = 128              # one 128-byte TMA row of K a slice


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.matmul_w8a8_launch.argtypes = [vp] * 5 + [i32] * 10 + [vp]
    lib.matmul_w8a8_launch.restype = i32
    lib.matmul_w8a8_smem_bytes.argtypes = [i32] * 3
    lib.matmul_w8a8_smem_bytes.restype = i32
    lib.matmul_w8a8_wgmma_launch.argtypes = [vp] * 7 + [i32] * 9 + [vp]
    lib.matmul_w8a8_wgmma_launch.restype = i32
    lib.matmul_w8a8_wgmma_smem_bytes.argtypes = [i32] * 3
    lib.matmul_w8a8_wgmma_smem_bytes.restype = i32
    lib.matmul_w8a8_splits.argtypes = [i32] * 2
    lib.matmul_w8a8_splits.restype = i32


LIB = KernelLibrary("matmul_w8a8", _declare)


def smem_bytes(block_m: int, block_n: int, block_k: int) -> int:
    """Dynamic shared memory of one mma.sync launch — the same formula as
    ``matmul_w8a8_smem_bytes`` in the CUDA source: two stages of
    block_m x rows and block_n w rows of block_k bytes, each padded by 16
    bytes."""
    return 2 * (block_m + block_n) * (block_k + PAD)


def regs_fit(block_m: int, block_n: int, num_warps: int,
             dequant: str) -> bool:
    """A thread's mma.sync accumulators (int32, plus f32 under inline
    dequant) stay within 128 registers — the combinations the source
    instantiates."""
    return (block_m * block_n * (2 if dequant == "inline" else 1)
            <= 4096 * num_warps)


def swapped(block_m: int) -> bool:
    """The wgmma kernel swaps the operands' roles at block_m 8, 16 or 32
    (decode): w's rows become wgmma's M and x's rows its N."""
    return block_m in SWAP_BLOCK_M


def wgmma_smem_bytes(block_m: int, block_n: int, num_stages: int) -> int:
    """Dynamic shared memory of one wgmma launch — the same formula as
    ``wgmma_smem`` in the CUDA source: 1024 bytes of alignment slack, 256
    of mbarriers and a flag, and ``num_stages`` slices of 128 bytes of K of
    block_m x rows and block_n w rows."""
    return 1024 + 256 + num_stages * 128 * (block_m + block_n)


def wgmma_regs_fit(block_m: int, block_n: int, dequant: str) -> bool:
    """A thread's wgmma accumulators (N / 2 int32 for wgmma's N, block_m
    when swapped and block_n otherwise, and as many f32 under inline
    dequant) within 128 registers — ``wgmma_regs_fit`` in the source."""
    n = block_m if swapped(block_m) else block_n
    return n // 2 * (2 if dequant == "inline" else 1) <= 128


def wgmma_tile_ok(block_m: int, block_n: int, block_k: int,
                  num_warps: int) -> bool:
    """The tiles the wgmma kernel instantiates: decode (block_m 8, 16, 32)
    block_n 64 or 128, prefill (block_m 64 or 128) block_n 64, 128 or 256;
    block_k 128 (a slice is one TMA row); ``num_warps`` the consumer
    warpgroups' (4 per 64 A rows: block_n / 16 when swapped, block_m / 16
    otherwise)."""
    rows = block_n if swapped(block_m) else block_m
    return (block_k == WGMMA_BLOCK_K and rows in (64, 128)
            and num_warps == rows // 16)


def effective_splits(K: int, split_k: int) -> int:
    """The splits a wgmma launch runs — ``effective_splits`` in the
    source: each takes ceil(slices / split_k) slices of 128 bytes of K and
    none is empty."""
    slices = -(-K // WGMMA_BLOCK_K)
    per = -(-slices // split_k)
    return -(-slices // per)


def tma_layout_error(K: int, x_ptr: int = 0,
                     w_ptr: int = 0) -> Optional[str]:
    """Why TMA cannot read x (M, K) and the (N, K) storage of w, both with
    K contiguous, or None: rows of 16-byte multiples, 16-byte aligned
    bases."""
    if K % 16:
        return f"rows of K {K} are not 16-byte multiples"
    if x_ptr % 16 or w_ptr % 16:
        return "the bases must be 16-byte aligned"
    return None


def path(K: int, x_ptr: int = 0, w_ptr: int = 0) -> str:
    """The kernel a launch takes, from the layout alone: ``"wgmma"`` where
    TMA can read both operands, else ``"mma_sync"``."""
    return ("wgmma" if tma_layout_error(K, x_ptr, w_ptr) is None
            else "mma_sync")


def clamp_blocks(block_m: int, block_n: int, block_k: int, M: int, N: int,
                 K: int, route: str = "mma_sync") -> Tuple[int, int, int]:
    """The tile the kernel launches. mma.sync: block_m (at least 16) and
    block_n clamped to the smallest tile of their domains that covers M
    and N (decode's 8 rows take 16), block_k to K rounded up to the MMA
    depth of 32. wgmma: block_m to the smallest of (8, 16, 32, 64, 128)
    that covers M (decode's 8 rows take 8), block_n to the smallest of its
    tiles that covers N (when swapped at most 128: two warpgroups of w
    rows); block_k stays, the slice is one TMA row of 128 bytes."""
    def cover(block, n, domain):
        return min([block] + [v for v in domain if v >= n])
    if route == "wgmma":
        bm = cover(block_m, M, BLOCK_M)
        bn = (cover(min(block_n, SWAP_BLOCK_N[-1]), N, SWAP_BLOCK_N)
              if swapped(bm) else cover(block_n, N, BLOCK_N))
        return bm, bn, block_k
    return (cover(max(block_m, MMA_BLOCK_M[0]), M, MMA_BLOCK_M),
            cover(block_n, N, BLOCK_N), min(block_k, -(-K // MMA_K) * MMA_K))


def matmul_w8a8(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *, block_m: int = 64,
                block_n: int = 128, block_k: int = 128, num_warps: int = 4,
                num_stages: int = 4, split_k: int = 1,
                dequant: str = "epilogue",
                scale_gran: str = "per_channel") -> torch.Tensor:
    """x (M, K) int8 @ w (K, N) int8 -> (M, N) float32, scales fused.
    ``x_scale`` is (M, 1) / (M,) per row or one value, ``w_scale`` (1, N)
    / (N,) per column or one value, as ``scale_gran`` says."""
    M, K = x.shape
    K2, N = w.shape
    per_tensor = scale_gran == "per_tensor"
    n_xs, n_ws = (1, 1) if per_tensor else (M, N)
    errors = [
        (x.dtype == w.dtype == torch.int8, "x and w must be int8"),
        (K == K2, f"x (M, {K}) and w ({K2}, N) disagree on K"),
        (scale_gran in ("per_channel", "per_tensor"),
         f"scale_gran {scale_gran!r}"),
        (dequant in ("epilogue", "inline"), f"dequant {dequant!r}"),
        (x_scale.numel() == n_xs and w_scale.numel() == n_ws,
         f"{scale_gran} scales take {n_xs} and {n_ws} values"),
    ]
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("matmul_w8a8: " + "; ".join(bad))
    if not x.is_cuda:
        return ref.matmul_w8a8(x, w, x_scale, w_scale)
    xs = x_scale.reshape(-1)
    ws = w_scale.reshape(-1)
    route = path(K, x.data_ptr(), w.data_ptr())
    bm, bn, bk = clamp_blocks(block_m, block_n, block_k, M, N, K, route)
    vec = next((v for v in (16, 8, 4) if K % v == 0
                and x.data_ptr() % v == 0 and w.data_ptr() % v == 0), 0)
    errors = [
        (M > 0 and N > 0 and K > 0, "an empty matrix"),
        (x.is_contiguous(), "x (M, K) must be contiguous"),
        (w.stride() == (1, K),
         "w (K, N) must be the K-major view of an (N, K) contiguous "
         "tensor (strides (1, K))"),
        (vec > 0, f"K {K} and the base pointers must be multiples of 4 "
                  "bytes"),
        (xs.dtype == ws.dtype == torch.float32, "scales must be float32"),
        (xs.is_contiguous() and ws.is_contiguous(),
         "scales must be contiguous"),
        (all(t.is_cuda and t.device == x.device for t in (w, xs, ws)),
         "every operand on x's device"),
        (block_m in BLOCK_M, f"block_m {block_m} (of {BLOCK_M})"),
        (block_n in BLOCK_N, f"block_n {block_n} (of {BLOCK_N})"),
        (block_k > 0 and block_k % MMA_K == 0,
         f"block_k {block_k} (a multiple of {MMA_K})"),
        (num_warps in NUM_WARPS, f"num_warps {num_warps} (of {NUM_WARPS})"),
        (num_stages in NUM_STAGES,
         f"num_stages {num_stages} (of {NUM_STAGES})"),
        (split_k in SPLIT_K, f"split_k {split_k} (of {SPLIT_K})"),
    ]
    if route == "wgmma":
        rows = bn if swapped(bm) else bm
        errors += [
            (bk == WGMMA_BLOCK_K and rows in (64, 128)
             and bn in (SWAP_BLOCK_N if swapped(bm) else BLOCK_N),
             f"the wgmma kernel takes block_k {WGMMA_BLOCK_K} and, at "
             f"block_m {bm} (after clamping), block_n "
             f"{SWAP_BLOCK_N if swapped(bm) else BLOCK_N} (block_m 64 or "
             f"128 above 32 rows); got block_n {bn}, block_k {bk}"),
            (wgmma_regs_fit(bm, bn, dequant),
             f"block_m {bm} x block_n {bn} accumulators ({dequant}) do not "
             f"fit the registers"),
            (swapped(bm) or effective_splits(K, split_k) == 1,
             f"split_k {split_k} splits K at decode only (block_m "
             f"{SWAP_BLOCK_M}; got {bm})"),
        ]
        smem = wgmma_smem_bytes(bm, bn, num_stages)
    else:
        errors.append((regs_fit(bm, bn, num_warps, dequant),
                       f"block_m {bm} x block_n {bn} accumulators over "
                       f"{num_warps} warps ({dequant}) do not fit the "
                       f"registers"))
        smem = smem_bytes(bm, bn, bk)
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("matmul_w8a8: " + "; ".join(bad))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"matmul_w8a8: {smem} bytes of shared memory > "
                         f"{MAX_SMEM_BYTES} ({route}, block_k {bk})")
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = LIB.load()
    if route == "wgmma":
        splits = effective_splits(K, split_k)
        part = counters = None
        if splits > 1:
            # partial sums, and the per-tile counters that find each
            # tile's last split, zeroed here: part of the call
            part = torch.empty(splits, M, N, dtype=torch.int32,
                               device=x.device)
            counters = torch.zeros(-(-M // bm) * -(-N // bn),
                                   dtype=torch.int32, device=x.device)
        err = lib.matmul_w8a8_wgmma_launch(
            x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(), M, N, K, bm,
            bn, num_stages, split_k, int(dequant == "inline"),
            int(per_tensor), stream)
    else:
        err = lib.matmul_w8a8_launch(
            x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            out.data_ptr(), M, N, K, bm, bn, bk, num_warps,
            int(dequant == "inline"), vec, int(per_tensor), stream)
    if err != 0:
        raise RuntimeError(f"matmul_w8a8 launch failed ({route}): "
                           f"cudaError {err}")
    matmul_w8a8.launches += 1
    matmul_w8a8.path_launches[route] += 1
    return out


matmul_w8a8.launches = 0
matmul_w8a8.path_launches = {"wgmma": 0, "mma_sync": 0}
