"""Absorbed-MLA decode over the compressed latent cache: the wrapper around
``csrc/mla_decode.cu``.

The CUDA C++ kernel replaces the TPU kernel ``_mla_decode_kernel`` of
``src/repro/kernels/mla_decode.py``: one query token a request, its H heads
with W_uk folded in (q_abs) and their RoPE parts (q_rope), against the
latent cache ckv (B, T, C) and the RoPE keys krope (B, T, R) that every
head shares; it returns the attended latent context (B, H, C) in f32, and
W_uv applies downstream. The source's header note says what bounds it on
Hopper (HBM bytes at the serving decode) and how its design answers that.
It is built and loaded like the other kernels (``kernels.build``).

Tunables (``kernels.ops.MLA_DECODE``): ``block_kv`` cache rows staged a
step, ``k_splits`` independent spans of the cache (T rounded up to a whole
number of ``block_kv`` x ``k_splits``, as the reference pads it), whose
(context, lse) partials the wrapper combines with max-lse weights in torch
ops, as the reference's wrapper does outside its ``pallas_call``, and
``num_warps``. ``block_kv`` is clamped to the smallest block that holds the
cache, as the reference clamps it to its 128-row tile. ``kv_len`` past T
means the whole cache; a request with kv_len 0 gets zeros. Tensors on the
CPU take the plain version ``kernels.ref.mla_decode_ragged``; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KernelLibrary

BLOCK_KV = (16, 32, 64, 128)
K_SPLITS = (1, 2, 4, 8, 16, 32)
NUM_WARPS = (4, 8)
HEAD_ROWS = 16                   # heads a block: one mma.sync m16 tile
MAX_RANK = 512                   # C: 16-column chunks a warp can hold
MAX_SMEM_BYTES = 232448          # 227 KB: the opt-in per-block limit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mla_decode_launch.argtypes = (
        [vp] * 7 + [i32] * 5 + [i64] * 4 + [ctypes.c_float] + [i32] * 5
        + [vp])
    lib.mla_decode_launch.restype = i32
    lib.mla_decode_smem_bytes.argtypes = [i32] * 4
    lib.mla_decode_smem_bytes.restype = i32


LIB = KernelLibrary("mla_decode", _declare)


def smem_bytes(width: int, itemsize: int, block_kv: int,
               num_warps: int) -> int:
    """Dynamic shared memory of one launch — the same formula as
    ``mla_decode_smem_bytes`` in the CUDA source, ``width`` = C + R: 16
    query rows and two stages of ``block_kv`` cache rows, each ``width``
    rounded up to 16 elements plus 16 bytes; the warps' partial scores and
    P in f32 (rows of block_kv + 8); m, l and the rescale of 16 rows."""
    row = -(-width // 16) * 16 * itemsize + 16
    return ((HEAD_ROWS + 2 * block_kv) * row
            + (num_warps + 1) * HEAD_ROWS * (block_kv + 8) * 4
            + 3 * HEAD_ROWS * 4)


def clamp_block_kv(block_kv: int, T: int) -> int:
    """The block the kernel stages: ``block_kv``, or the smallest block
    that holds the whole cache where that is smaller."""
    holds = [b for b in BLOCK_KV if b >= T]
    return min(block_kv, holds[0]) if holds else block_kv


def split_span(T: int, block_kv: int, k_splits: int) -> int:
    """Cache rows a split covers: T rounded up to a whole number of
    ``block_kv`` x ``k_splits``, over ``k_splits``."""
    step = block_kv * k_splits
    return -(-T // step) * step // k_splits


def combine(o_parts: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The splits' contexts (B, S, H, C) f32 weighted by exp(lse - max)
    (lse (B, S, H)), the reference's combine: a request no split saw
    comes out zero."""
    m = torch.amax(lse, dim=1, keepdim=True)
    w = torch.exp(lse - m)
    return torch.sum(o_parts * w[..., None], dim=1) / torch.clamp(
        torch.sum(w, dim=1), min=1e-30)[..., None]


def mla_decode(q_abs: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor,
               krope: torch.Tensor, *, kv_len: Optional[torch.Tensor] = None,
               scale: Optional[float] = None, block_kv: int = 64,
               k_splits: int = 1, num_warps: int = 4) -> torch.Tensor:
    """Absorbed-MLA decode. q_abs (B, H, C), q_rope (B, H, R); ckv
    (B, T, C), krope (B, T, R) with rows contiguous, any batch and row
    strides; float32 or bfloat16, one dtype; kv_len (B,) int (None: every
    request attends all T; past T: all T; 0: zeros). ``scale`` defaults to
    1.0, as the reference's wrapper. Returns (B, H, C) f32."""
    if scale is None:
        scale = 1.0
    if not q_abs.is_cuda:
        return ref.mla_decode_ragged(q_abs, q_rope, ckv, krope,
                                     kv_len=kv_len, scale=scale)
    q_abs, q_rope = q_abs.contiguous(), q_rope.contiguous()
    B, H, C = q_abs.shape
    T, R = ckv.shape[1], krope.shape[2]
    if kv_len is None:
        kv_len = torch.full((B,), T, dtype=torch.int32, device=q_abs.device)
    item = q_abs.element_size()
    tensors = (q_abs, q_rope, ckv, krope)
    errors = [
        (q_abs.dtype in _DTYPE_CODE,
         f"dtype {q_abs.dtype} (float32 or bfloat16)"),
        (all(t.dtype == q_abs.dtype for t in tensors),
         "q_abs, q_rope, ckv and krope must share a dtype"),
        (q_rope.shape[:2] == (B, H) and ckv.shape == (B, T, C)
         and krope.shape == (B, T, R),
         "q_abs (B, H, C), q_rope (B, H, R), ckv (B, T, C), krope (B, T, R)"),
        (C % 16 == 0 and C <= MAX_RANK,
         f"latent rank {C} (a multiple of 16, at most {MAX_RANK})"),
        (R * item % 16 == 0, f"rope dim {R} rows are not 16-byte multiples"),
        (T > 0 and H > 0, "an empty cache or no heads"),
        (B <= 65535, f"batch {B} > 65535"),
        (ckv.stride(-1) == 1 and krope.stride(-1) == 1,
         "ckv and krope rows must be contiguous"),
        (all(s * item % 16 == 0 for t in (ckv, krope) for s in t.stride()[:2]),
         "cache strides must be 16-byte multiples"),
        (all(t.data_ptr() % 16 == 0 for t in tensors),
         "every operand must be 16-byte aligned"),
        (kv_len.shape == (B,), "kv_len (B,)"),
        (all(t.is_cuda and t.device == q_abs.device
             for t in tensors + (kv_len,)),
         "every operand on q_abs's device"),
        (block_kv in BLOCK_KV, f"block_kv {block_kv} (of {BLOCK_KV})"),
        (k_splits in K_SPLITS, f"k_splits {k_splits} (of {K_SPLITS})"),
        (num_warps in NUM_WARPS, f"num_warps {num_warps} (of {NUM_WARPS})"),
    ]
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("mla_decode: " + "; ".join(bad))
    block_kv = clamp_block_kv(block_kv, T)
    smem = smem_bytes(C + R, item, block_kv, num_warps)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"mla_decode: {smem} bytes of shared memory > "
                         f"{MAX_SMEM_BYTES} (block_kv {block_kv}, "
                         f"{num_warps} warps)")
    lens = kv_len.to(torch.int32).contiguous()
    o_parts = torch.empty(B, k_splits, H, C, dtype=torch.float32,
                          device=q_abs.device)
    lse = torch.empty(B, k_splits, H, dtype=torch.float32,
                      device=q_abs.device)
    stream = torch.cuda.current_stream(q_abs.device).cuda_stream
    err = LIB.load().mla_decode_launch(
        q_abs.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
        krope.data_ptr(), lens.data_ptr(), o_parts.data_ptr(),
        lse.data_ptr(), B, H, C, R, T, *ckv.stride()[:2],
        *krope.stride()[:2], float(scale), block_kv, k_splits,
        split_span(T, block_kv, k_splits), num_warps,
        _DTYPE_CODE[q_abs.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mla_decode launch failed: cudaError {err}")
    mla_decode.launches += 1
    if k_splits == 1:
        return o_parts.view(B, H, C)
    return combine(o_parts, lse)


mla_decode.launches = 0
