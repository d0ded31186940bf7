"""Flash attention forward: the wrapper around ``csrc/flash_attention.cu``.

The CUDA C++ kernel replaces the TPU kernel ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py``: causal and sliding-window GQA
attention with a query offset, f32 scores and sums, returning o and the
log-sum-exp of every row. The source's header note says what bounds it on
Hopper (HBM bytes at the serving prefill) and how its design answers that.
It is built and loaded like the other kernels (``kernels.build``).

Layout: q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) are read through their
strides with D contiguous, so ``models.attention`` hands over the
``transpose(1, 2)`` views of its (B, S, H, D) activations, no copy; o takes
q's strides (``torch.empty_like``), so its transpose back is contiguous.

Tunables (``kernels.ops.FLASH_ATTENTION``): ``block_q`` query rows a block,
``block_kv`` keys a tile, ``num_warps`` (each warp owns 16 or 32 of the
block's rows). The kernel masks D itself: D 96 and 120 run unpadded. A row
with no visible key gives zeros and lse -1e30. Tensors on the CPU take the
plain version ``kernels.ref.flash_attention``; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KernelLibrary

BLOCK_Q = (16, 32, 64, 128)
BLOCK_KV = (32, 64, 128, 256)
NUM_WARPS = (1, 2, 4, 8)
MAX_HEAD_DIM = 256
MAX_SMEM_BYTES = 232448          # 227 KB: the opt-in per-block limit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [vp] * 5 + [i32] * 6 + [i64] * 12 + [ctypes.c_float] + [i32] * 7
        + [vp])
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_smem_bytes.argtypes = [i32] * 4
    lib.flash_attention_smem_bytes.restype = i32


LIB = KernelLibrary("flash_attention", _declare)


def head_dim_class(D: int) -> int:
    """The o accumulator's width the kernel is instantiated for."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def regs_fit(D: int, block_q: int, block_kv: int, num_warps: int) -> bool:
    """A warp owns 16 or 32 of the block's rows, and a thread's f32
    accumulators of o and s stay within 160 — the combinations the source
    instantiates (``regs_fit`` there)."""
    rt, rem = divmod(block_q, 16 * num_warps)
    return (rem == 0 and rt in (1, 2)
            and rt * (head_dim_class(D) + block_kv) <= 320)


def smem_bytes(D: int, itemsize: int, block_q: int, block_kv: int) -> int:
    """Dynamic shared memory of one launch — the same formula as
    ``flash_attention_smem_bytes`` in the CUDA source: the q tile and two
    stages of K and V tiles, rows of D rounded up to 16 elements plus 16
    bytes."""
    return (block_q + 4 * block_kv) * (-(-D // 16) * 16 * itemsize + 16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    block_q: int = 64, block_kv: int = 64,
                    num_warps: int = 4, return_lse: bool = False):
    """Flash attention. q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D), Hq a
    multiple of Hkv, float32 or bfloat16 (q's dtype), any strides with D
    contiguous. Query row i sits at position i + ``q_offset``; ``window``
    (None: none) keeps the keys less than ``window`` positions back.
    Returns o in q's dtype and q's layout, and (o, lse (B, Hq, Sq) f32)
    with ``return_lse``."""
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} (None or >= 1)")
    if not q.is_cuda:
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset,
                                   return_lse=return_lse)
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, Dk = k.shape
    item = q.element_size()
    errors = [
        (q.dtype in _DTYPE_CODE, f"dtype {q.dtype} (float32 or bfloat16)"),
        (k.dtype == v.dtype == q.dtype, "q, k and v must share a dtype"),
        (k.shape == v.shape and k.shape[0] == B and Dk == D,
         "k, v (B, Hkv, Skv, D) with q's B and D"),
        (Sq > 0 and Skv > 0, "an empty sequence"),
        (Hkv > 0 and Hq % Hkv == 0, f"Hq {Hq} not a multiple of Hkv {Hkv}"),
        (B * Hq <= 65535, f"B x Hq {B * Hq} > 65535"),
        (D <= MAX_HEAD_DIM, f"head_dim {D} > {MAX_HEAD_DIM}"),
        (D * item % 16 == 0, f"head_dim {D} rows are not 16-byte multiples"),
        (all(t.stride(-1) == 1 for t in (q, k, v)), "D must be contiguous"),
        (all(s * item % 16 == 0 for t in (q, k, v) for s in t.stride()[:3]),
         "strides must be 16-byte multiples"),
        (all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
         "q, k and v must be 16-byte aligned"),
        (all(t.is_cuda and t.device == q.device for t in (k, v)),
         "every operand on q's device"),
        (block_q in BLOCK_Q, f"block_q {block_q} (of {BLOCK_Q})"),
        (block_kv in BLOCK_KV, f"block_kv {block_kv} (of {BLOCK_KV})"),
        (num_warps in NUM_WARPS, f"num_warps {num_warps} (of {NUM_WARPS})"),
        (regs_fit(D, block_q, block_kv, num_warps),
         f"block_q {block_q} over {num_warps} warps with block_kv "
         f"{block_kv} at head_dim {D}: a warp owns 16 or 32 rows and the "
         f"accumulators must fit the registers"),
    ]
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("flash_attention: " + "; ".join(bad))
    smem = smem_bytes(D, item, block_q, block_kv)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention: {smem} bytes of shared memory > "
                         f"{MAX_SMEM_BYTES} (block_q {block_q}, block_kv "
                         f"{block_kv})")
    if scale is None:
        scale = D ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = LIB.load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Hq, Hkv, Sq, Skv, D, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], float(scale),
        int(bool(causal)), int(window or 0), int(q_offset), block_q,
        block_kv, num_warps, _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0
