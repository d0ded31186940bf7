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
``block_kv`` keys a tile, ``num_warps`` and ``num_stages``. The wrapper
chooses the kernel by dtype, in the open: bf16 runs the Hopper kernel
(wgmma, TMA and an mbarrier ring of ``num_stages`` K/V tiles; a
warpgroup of 4 warps per 64 rows, so ``block_q`` 64 or 128 with
``num_warps = block_q / 16``), f32 the IEEE-FMA kernel (each warp owns 16
or 32 rows; ``num_stages`` 2, its double buffer). TMA reads q, k and v
through tensor maps encoded over their strides: ``tma_layout_error`` says
what a map cannot take, and the wrapper raises on it. The kernels mask D
themselves: D 96, 120 and 160 run unpadded. A row with no visible key gives
zeros and lse -1e30. Tensors on the CPU take the plain version
``kernels.ref.flash_attention``; a CUDA tensor launches the kernel or
raises: a failed build or launch raises, nothing falls back.
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
NUM_STAGES = (2, 3, 4)
MAX_HEAD_DIM = 256
MAX_SMEM_BYTES = 232448          # 227 KB: the opt-in per-block limit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [vp] * 5 + [i32] * 6 + [i64] * 12 + [ctypes.c_float] + [i32] * 8
        + [vp])
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_smem_bytes.argtypes = [i32] * 5
    lib.flash_attention_smem_bytes.restype = i32


LIB = KernelLibrary("flash_attention", _declare)


def head_dim_class(D: int) -> int:
    """The f32 kernel's o accumulator width."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def col_blocks(D: int) -> int:
    """The bf16 kernels' 64-column blocks of D (TMA boxes and wgmma
    products of 64 columns)."""
    return -(-D // 64)


def regs_fit(D: int, block_q: int, block_kv: int, num_warps: int,
             itemsize: int) -> bool:
    """The combinations the source instantiates. bf16 (``bf16_regs_fit``
    there): a consumer warpgroup of 4 warps per 64 rows (``block_q`` 64 or
    128, ``num_warps = block_q / 16``), ``block_kv`` 64 or 128, and a
    thread's o accumulators (32 per column block) with s and P's two bf16
    terms (``block_kv``) within 192. f32 (``f32_regs_fit``): a warp owns
    16 or 32 of the block's rows and a thread's f32 accumulators of o and
    s stay within 160."""
    if itemsize == 2:
        return (block_q in (64, 128) and num_warps == block_q // 16
                and block_kv in (64, 128)
                and 32 * col_blocks(D) + block_kv <= 192)
    rt, rem = divmod(block_q, 16 * num_warps)
    return (rem == 0 and rt in (1, 2)
            and rt * (head_dim_class(D) + block_kv) <= 320)


def smem_bytes(D: int, itemsize: int, block_q: int, block_kv: int,
               num_stages: int = 2) -> int:
    """Dynamic shared memory of one launch — the same formula as
    ``flash_attention_smem_bytes`` in the CUDA source. bf16: 1024 bytes of
    alignment slack and 256 of mbarriers, the q tile and ``num_stages`` K
    and V tiles, as 64-column blocks of 128-byte rows. f32: the q tile and
    two stages of K and V tiles, rows of D rounded up to 16 elements plus
    16 bytes."""
    if itemsize == 2:
        return 1280 + col_blocks(D) * 128 * (block_q
                                             + 2 * num_stages * block_kv)
    return (block_q + 4 * block_kv) * (-(-D // 16) * 16 * itemsize + 16)


def tma_layout_error(shape, stride, itemsize: int,
                     data_ptr: int) -> Optional[str]:
    """Why a (B, H, S, D) operand cannot be read through a tensor map (TMA:
    ``cuTensorMapEncodeTiled``) or 16-byte copies, or None: D contiguous,
    rows of 16-byte multiples, the other strides positive multiples of 16
    bytes below 2**40, the base 16-byte aligned. A ``transpose(1, 2)`` view
    of a contiguous (B, S, H, D) tensor passes wherever D is a multiple of
    8 (bf16) or 4 (f32)."""
    if stride[-1] != 1:
        return "D must be contiguous"
    if shape[-1] * itemsize % 16:
        return f"head_dim {shape[-1]} rows are not 16-byte multiples"
    if any(s <= 0 or s * itemsize % 16 or s * itemsize >= 1 << 40
           for s in stride[:-1]):
        return (f"strides {tuple(stride)} must be positive 16-byte "
                f"multiples below 2**40")
    if data_ptr % 16:
        return "the base must be 16-byte aligned"
    return None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    block_q: int = 64, block_kv: int = 64,
                    num_warps: int = 4, num_stages: int = 2,
                    return_lse: bool = False):
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
        *[(err is None, f"{name}: {err}") for name, err in
          ((name, tma_layout_error(t.shape, t.stride(), item, t.data_ptr()))
           for name, t in (("q", q), ("k", k), ("v", v)))],
        (all(t.is_cuda and t.device == q.device for t in (k, v)),
         "every operand on q's device"),
        (block_q in BLOCK_Q, f"block_q {block_q} (of {BLOCK_Q})"),
        (block_kv in BLOCK_KV, f"block_kv {block_kv} (of {BLOCK_KV})"),
        (num_warps in NUM_WARPS, f"num_warps {num_warps} (of {NUM_WARPS})"),
        (num_stages in (NUM_STAGES if item == 2 else (2,)),
         f"num_stages {num_stages} (bf16 {NUM_STAGES}, f32 2)"),
        (regs_fit(D, block_q, block_kv, num_warps, item),
         f"block_q {block_q} over {num_warps} warps with block_kv "
         f"{block_kv} at head_dim {D} in {q.dtype}: bf16 takes 64 rows a "
         f"warpgroup of 4 warps, f32 16 or 32 rows a warp, and the "
         f"accumulators must fit the registers"),
    ]
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("flash_attention: " + "; ".join(bad))
    smem = smem_bytes(D, item, block_q, block_kv, num_stages)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention: {smem} bytes of shared memory > "
                         f"{MAX_SMEM_BYTES} (block_q {block_q}, block_kv "
                         f"{block_kv}, num_stages {num_stages})")
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
        block_kv, num_warps, num_stages, _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0
