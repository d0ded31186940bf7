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
``num_warps`` and ``num_stages``. The wrapper chooses the kernels by dtype,
in the open. bf16 runs the Hopper kernels (wgmma, TMA, an mbarrier ring of
``num_stages`` tiles): the dkv kernel gives each 64 keys of ``block_kv``
a warpgroup and streams q tiles of ``block_q`` rows, the dq kernel
the other way round; ``block_q`` and ``block_kv`` 64 or 128, ``num_warps``
4 (a warpgroup's). f32 runs the IEEE-FMA kernels: each warp owns 16 or 32
keys (dkv) or rows (dq), ``num_stages`` 2. TMA reads q, k, v and do
through tensor maps (``flash_attention.tma_layout_error`` says what a map
cannot take; the wrapper raises on it). Tensors on the CPU take the plain
version ``kernels.ref.flash_attention_bwd``; a CUDA tensor launches the
kernels or raises: a failed build or launch raises, nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.flash_attention import col_blocks, tma_layout_error

BLOCK_Q = (16, 32, 64, 128)
BLOCK_KV = (16, 32, 64, 128)
NUM_WARPS = (1, 2, 4, 8)
NUM_STAGES = (2, 3, 4)
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 232448          # 227 KB: the opt-in per-block limit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_bwd_launch.argtypes = (
        [vp] * 9 + [i32] * 6 + [i64] * 22 + [ctypes.c_float] + [i32] * 8
        + [vp])
    lib.flash_attention_bwd_launch.restype = i32
    lib.flash_attention_bwd_smem_bytes.argtypes = [i32] * 5
    lib.flash_attention_bwd_smem_bytes.restype = i32


LIB = KernelLibrary("flash_attention_bwd", _declare)


def head_dim_class(D: int) -> int:
    """The f32 kernels' accumulator width."""
    return 64 if D <= 64 else 128


def regs_fit(D: int, block_q: int, block_kv: int, num_warps: int,
             itemsize: int) -> bool:
    """The combinations the source instantiates. bf16 (``dkv_bf16_fit`` and
    ``dq_bf16_fit`` there): ``block_q`` and ``block_kv`` 64 or 128,
    ``num_warps`` 4, a dkv thread's dk and dv accumulators (64 per column
    block of D) with s^T and dp^T (``block_q``) within 192, a dq thread's dq
    (32 per column block) with s and dp (``block_kv``) within 192. f32
    (``dkv_regs_fit`` and ``dq_regs_fit``): each warp owns 16 or 32 keys in
    the dkv kernel and 16 or 32 query rows in the dq kernel, and a thread's
    f32 accumulators stay within 192 (dk and dv, then one tile's s and dp)
    and 160 (dq, s and dp)."""
    if D > MAX_HEAD_DIM:
        return False
    if itemsize == 2:
        nb = col_blocks(D)
        return (block_q in (64, 128) and block_kv in (64, 128)
                and num_warps == 4 and 64 * nb + block_q <= 192
                and 32 * nb + block_kv <= 192)
    hd = head_dim_class(D)
    rt_kv, rem_kv = divmod(block_kv, 16 * num_warps)
    rt_q, rem_q = divmod(block_q, 16 * num_warps)
    return (rem_kv == 0 and rem_q == 0 and rt_kv in (1, 2)
            and rt_q in (1, 2) and rt_kv * hd + block_q <= 192
            and rt_q * hd // 2 + block_kv <= 160)


def smem_bytes(D: int, itemsize: int, block_q: int, block_kv: int,
               num_stages: int = 2) -> int:
    """Dynamic shared memory of the larger launch — the same formula as
    ``flash_attention_bwd_smem_bytes`` in the CUDA source. bf16: 1024 bytes
    of alignment slack and 256 of mbarriers; the dkv kernel holds K and V
    tiles of ``block_kv`` keys and ``num_stages`` stages of q and do tiles
    of ``block_q`` rows with their f32 lse and delta, the dq kernel q and
    do tiles of ``block_q`` rows and ``num_stages`` stages of K and V tiles
    of ``block_kv`` keys, all as 64-column blocks of 128-byte rows. f32:
    the dkv kernel stages K and V and two stages of q and do with their lse
    and delta, the dq kernel q and do with theirs and two stages of K and
    V; rows of D rounded up to 16 elements plus 16 bytes."""
    if itemsize == 2:
        blocks = col_blocks(D) * 128
        return 1280 + max(
            blocks * (2 * block_kv + 2 * num_stages * block_q)
            + 8 * num_stages * block_q,
            blocks * (2 * block_q + 2 * num_stages * block_kv))
    row = -(-D // 16) * 16 * itemsize + 16
    return max((2 * block_kv + 4 * block_q) * row + 16 * block_q,
               (2 * block_q + 4 * block_kv) * row + 8 * block_q)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset: int = 0,
                        block_q: int = 64, block_kv: int = 64,
                        num_warps: int = 4, num_stages: int = 2):
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
        *[(err is None, f"{name}: {err}") for name, err in
          ((name, tma_layout_error(t.shape, t.stride(), item, t.data_ptr()))
           for name, t in (("q", q), ("k", k), ("v", v), ("do", do)))],
        (all(t.is_cuda and t.device == q.device for t in (k, v, o, lse, do)),
         "every operand on q's device"),
        (block_q in BLOCK_Q, f"block_q {block_q} (of {BLOCK_Q})"),
        (block_kv in BLOCK_KV, f"block_kv {block_kv} (of {BLOCK_KV})"),
        (num_warps in NUM_WARPS, f"num_warps {num_warps} (of {NUM_WARPS})"),
        (num_stages in (NUM_STAGES if item == 2 else (2,)),
         f"num_stages {num_stages} (bf16 {NUM_STAGES}, f32 2)"),
        (regs_fit(D, block_q, block_kv, num_warps, item),
         f"block_q {block_q} and block_kv {block_kv} over {num_warps} warps "
         f"at head_dim {D} in {q.dtype}: bf16 takes 64 or 128 of each over "
         f"a warpgroup of 4 warps, f32 16 or 32 rows of each a warp, and "
         f"the accumulators must fit the registers"),
    ]
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("flash_attention_bwd: " + "; ".join(bad))
    smem = smem_bytes(D, item, block_q, block_kv, num_stages)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention_bwd: {smem} bytes of shared "
                         f"memory > {MAX_SMEM_BYTES} (block_q {block_q}, "
                         f"block_kv {block_kv}, num_stages {num_stages})")
    if scale is None:
        scale = D ** -0.5
    delta = torch.sum(do.float() * o.float(), dim=-1)        # (B, Hq, Sq)
    # lse's and delta's rows are read by TMA (bf16) or 4-byte copies (f32)
    # from a 16-byte-aligned base, sl >= Sq apart with sl x 4 bytes a
    # multiple of 16: rows of a Sq that is not a multiple of 4 are padded
    sl = -(-Sq // 4) * 4
    if sl != Sq:
        lse, delta = (torch.nn.functional.pad(t, (0, sl - Sq))
                      for t in (lse, delta))
    elif not lse.is_contiguous() or lse.data_ptr() % 16:
        lse = lse.clone(memory_format=torch.contiguous_format)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = LIB.load().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Hq, Hkv, Sq, Skv, D, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3], sl,
        float(scale),
        int(bool(causal)), int(window or 0), int(q_offset), block_q,
        block_kv, num_warps, num_stages, _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError "
                           f"{err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
