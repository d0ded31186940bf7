"""The w8a8 GEMM: the wrapper around ``csrc/matmul_w8a8.cu``.

The CUDA C++ kernel replaces the TPU kernels ``_epilogue_kernel`` and
``_inline_kernel`` of ``src/repro/kernels/matmul_int8.py``: x (M, K) int8
times w (K, N) int8 on the int8 tensor cores, dequantized by per-channel
or per-tensor f32 scales, either once at the store from the exact int32
sum (``dequant="epilogue"``) or a K slice at a time into an f32 sum
(``"inline"``). The source's header note says what bounds it on Hopper
and how its design answers that. It is built and loaded like the other
kernels (``kernels.build``).

Layout: w is the (K, N) view, strides (1, K), of an (N, K) contiguous
tensor (``quant.qtensor.k_major``, how ``QTensor`` stores a weight): each
output column's K values are contiguous, as the MMA's B operand wants
them. A CUDA ``w`` in any other layout is refused, not copied.

Tunables (``kernels.ops.MATMUL_W8A8``): ``block_m``, ``block_n``,
``block_k``, ``num_warps``, ``dequant``, and ``scale_gran``, which the
operands pin. Blocks are clamped to the shape before the launch (the
kernel never stages a tile wider than the matrix rounded up to its MMA
grid), as ``ops`` canonicalises them. Tensors on the CPU take the plain
version ``kernels.ref.matmul_w8a8``; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KernelLibrary

BLOCK_M = (16, 32, 64, 128)
BLOCK_N = (64, 128, 256)
NUM_WARPS = (4, 8)
MMA_K = 32                       # the K depth of one int8 MMA
MAX_SMEM_BYTES = 232448          # 227 KB: the opt-in per-block limit
PAD = 16                         # bytes after each staged row


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.matmul_w8a8_launch.argtypes = [vp] * 5 + [i32] * 10 + [vp]
    lib.matmul_w8a8_launch.restype = i32
    lib.matmul_w8a8_smem_bytes.argtypes = [i32] * 3
    lib.matmul_w8a8_smem_bytes.restype = i32


LIB = KernelLibrary("matmul_w8a8", _declare)


def smem_bytes(block_m: int, block_n: int, block_k: int) -> int:
    """Dynamic shared memory of one launch — the same formula as
    ``matmul_w8a8_smem_bytes`` in the CUDA source: two stages of
    block_m x rows and block_n w rows of block_k bytes, each padded by 16
    bytes."""
    return 2 * (block_m + block_n) * (block_k + PAD)


def regs_fit(block_m: int, block_n: int, num_warps: int,
             dequant: str) -> bool:
    """A thread's accumulators (int32, plus f32 under inline dequant)
    stay within 128 registers — the combinations the source
    instantiates."""
    return (block_m * block_n * (2 if dequant == "inline" else 1)
            <= 4096 * num_warps)


def clamp_blocks(block_m: int, block_n: int, block_k: int, M: int, N: int,
                 K: int) -> Tuple[int, int, int]:
    """The tile the kernel launches: block_m and block_n clamped to the
    smallest tile of their domains that covers M and N (decode's 8 rows
    take 16), block_k to K rounded up to the MMA depth of 32."""
    def cover(block, n, domain):
        return min([block] + [v for v in domain if v >= n])
    return (cover(block_m, M, BLOCK_M), cover(block_n, N, BLOCK_N),
            min(block_k, -(-K // MMA_K) * MMA_K))


def matmul_w8a8(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *, block_m: int = 64,
                block_n: int = 128, block_k: int = 64, num_warps: int = 4,
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
    bm, bn, bk = clamp_blocks(block_m, block_n, block_k, M, N, K)
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
        (regs_fit(bm, bn, num_warps, dequant),
         f"block_m {bm} x block_n {bn} accumulators over {num_warps} warps "
         f"({dequant}) do not fit the registers"),
    ]
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("matmul_w8a8: " + "; ".join(bad))
    smem = smem_bytes(bm, bn, bk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"matmul_w8a8: {smem} bytes of shared memory > "
                         f"{MAX_SMEM_BYTES} (block_k {bk})")
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = LIB.load().matmul_w8a8_launch(
        x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        out.data_ptr(), M, N, K, bm, bn, bk, num_warps,
        int(dequant == "inline"), vec, int(per_tensor), stream)
    if err != 0:
        raise RuntimeError(f"matmul_w8a8 launch failed: cudaError {err}")
    matmul_w8a8.launches += 1
    return out


matmul_w8a8.launches = 0
