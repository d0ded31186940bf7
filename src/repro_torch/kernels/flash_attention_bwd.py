"""Flash attention backward: the wrapper around ``csrc/flash_attention_bwd.cu``.

The CUDA C++ kernels replace the TPU kernels ``_dkv_kernel`` and
``_dq_kernel`` of ``src/repro/kernels/flash_attention_bwd.py``: the
gradients dq, dk and dv of causal and sliding-window GQA attention with a
query offset, recomputed from the forward's log-sum-exp, dk and dv summed
over the query heads of each KV head's group. The source's header note says
what bounds it on Hopper and how its design answers that. It is built and
loaded like the other kernels (``kernels.build``).

``delta = rowsum(do * o)`` is computed here in f32 with torch ops, outside
the kernels, as the reference computes it in jnp.

Layout: q, o, do (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) are read through
their strides with D contiguous, as the forward reads them; dq takes q's
strides and dk, dv k's and v's (``torch.empty_like``), so the autograd
function's transposes back are contiguous.

Tunables (``kernels.ops.FLASH_ATTENTION_BWD``, kept apart from the
forward's): ``block_q`` query rows a tile, ``block_kv`` keys a tile,
``num_warps``. The dkv kernel's warps own the block's keys (16 or 32
each), the dq kernel's its query rows, so both tiles are 16 or 32 rows a
warp. Tensors on the CPU take the plain version
``kernels.ref.flash_attention_bwd``; a CUDA tensor launches the kernels or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KernelLibrary

BLOCK_Q = (16, 32, 64, 128)
BLOCK_KV = (16, 32, 64, 128)
NUM_WARPS = (1, 2, 4, 8)
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 232448          # 227 KB: the opt-in per-block limit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_bwd_launch.argtypes = (
        [vp] * 9 + [i32] * 6 + [i64] * 21 + [ctypes.c_float] + [i32] * 7
        + [vp])
    lib.flash_attention_bwd_launch.restype = i32
    lib.flash_attention_bwd_smem_bytes.argtypes = [i32] * 4
    lib.flash_attention_bwd_smem_bytes.restype = i32


LIB = KernelLibrary("flash_attention_bwd", _declare)


def head_dim_class(D: int) -> int:
    """The accumulators' width the kernels are instantiated for."""
    return 64 if D <= 64 else 128


def regs_fit(D: int, block_q: int, block_kv: int, num_warps: int) -> bool:
    """Each warp owns 16 or 32 keys in the dkv kernel and 16 or 32 query
    rows in the dq kernel, and a thread's f32 accumulators stay within 192
    (dk and dv, then one tile's s and dp) and 160 (dq, s and dp) — the
    combinations the source instantiates (``dkv_regs_fit`` and
    ``dq_regs_fit`` there)."""
    if D > MAX_HEAD_DIM:
        return False
    hd = head_dim_class(D)
    rt_kv, rem_kv = divmod(block_kv, 16 * num_warps)
    rt_q, rem_q = divmod(block_q, 16 * num_warps)
    return (rem_kv == 0 and rem_q == 0 and rt_kv in (1, 2)
            and rt_q in (1, 2) and rt_kv * hd + block_q <= 192
            and rt_q * hd // 2 + block_kv <= 160)


def smem_bytes(D: int, itemsize: int, block_q: int, block_kv: int) -> int:
    """Dynamic shared memory of the larger launch — the same formula as
    ``flash_attention_bwd_smem_bytes`` in the CUDA source: the dkv kernel
    stages K and V and two stages of q and do with their lse and delta,
    the dq kernel q and do with theirs and two stages of K and V; rows of
    D rounded up to 16 elements plus 16 bytes."""
    row = -(-D // 16) * 16 * itemsize + 16
    return max((2 * block_kv + 4 * block_q) * row + 16 * block_q,
               (2 * block_q + 4 * block_kv) * row + 8 * block_q)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset: int = 0,
                        block_q: int = 64, block_kv: int = 64,
                        num_warps: int = 4):
    """Gradients (dq, dk, dv) of ``flash_attention``. q, o, do (B, Hq, Sq,
    D); k, v (B, Hkv, Skv, D), Hq a multiple of Hkv, float32 or bfloat16
    (q's dtype), any strides with D contiguous; lse (B, Hq, Sq) f32, the
    forward's. The mask is the forward's (``causal``, ``window``,
    ``q_offset``). dq comes in q's dtype and layout, dk and dv in k's and
    v's."""
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bwd: window {window} (None or "
                         f">= 1)")
    if not q.is_cuda:
        return ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       window=window, scale=scale,
                                       q_offset=q_offset)
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, Dk = k.shape
    item = q.element_size()
    ops = (q, k, v, do)
    errors = [
        (q.dtype in _DTYPE_CODE, f"dtype {q.dtype} (float32 or bfloat16)"),
        (all(t.dtype == q.dtype for t in (k, v, o, do)),
         "q, k, v, o and do must share a dtype"),
        (k.shape == v.shape and k.shape[0] == B and Dk == D,
         "k, v (B, Hkv, Skv, D) with q's B and D"),
        (o.shape == do.shape == q.shape, "o and do must have q's shape"),
        (tuple(lse.shape) == (B, Hq, Sq) and lse.dtype == torch.float32,
         "lse (B, Hq, Sq) float32"),
        (Sq > 0 and Skv > 0, "an empty sequence"),
        (Hkv > 0 and Hq % Hkv == 0, f"Hq {Hq} not a multiple of Hkv {Hkv}"),
        (B * Hq <= 65535, f"B x Hq {B * Hq} > 65535"),
        (D <= MAX_HEAD_DIM, f"head_dim {D} > {MAX_HEAD_DIM}"),
        (D * item % 16 == 0, f"head_dim {D} rows are not 16-byte multiples"),
        (all(t.stride(-1) == 1 for t in ops), "D must be contiguous"),
        (all(s * item % 16 == 0 for t in ops for s in t.stride()[:3]),
         "strides must be 16-byte multiples"),
        (all(t.data_ptr() % 16 == 0 for t in ops),
         "q, k, v and do must be 16-byte aligned"),
        (all(t.is_cuda and t.device == q.device for t in (k, v, o, lse, do)),
         "every operand on q's device"),
        (block_q in BLOCK_Q, f"block_q {block_q} (of {BLOCK_Q})"),
        (block_kv in BLOCK_KV, f"block_kv {block_kv} (of {BLOCK_KV})"),
        (num_warps in NUM_WARPS, f"num_warps {num_warps} (of {NUM_WARPS})"),
        (regs_fit(D, block_q, block_kv, num_warps),
         f"block_q {block_q} and block_kv {block_kv} over {num_warps} warps "
         f"at head_dim {D}: a warp owns 16 or 32 rows of each and the "
         f"accumulators must fit the registers"),
    ]
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("flash_attention_bwd: " + "; ".join(bad))
    smem = smem_bytes(D, item, block_q, block_kv)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention_bwd: {smem} bytes of shared "
                         f"memory > {MAX_SMEM_BYTES} (block_q {block_q}, "
                         f"block_kv {block_kv})")
    if scale is None:
        scale = D ** -0.5
    delta = torch.sum(do.float() * o.float(), dim=-1)        # (B, Hq, Sq)
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = LIB.load().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Hq, Hkv, Sq, Skv, D, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3], float(scale),
        int(bool(causal)), int(window or 0), int(q_offset), block_q,
        block_kv, num_warps, _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError "
                           f"{err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
