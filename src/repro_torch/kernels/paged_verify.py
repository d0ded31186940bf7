"""Paged-KV speculative-verify attention: the wrapper around
``csrc/paged_verify.cu``.

The CUDA C++ kernel replaces the TPU kernel ``paged_verify`` of
``src/repro/kernels/paged_verify.py``; the source's header note says what
bounds it on Hopper (HBM bytes, as ``paged_decode``) and how its design
answers that. It is built and loaded like ``paged_decode``
(``kernels.build``).

Tunables (``kernels.ops.PAGED_VERIFY``): ``draft_k`` (pinned by the
engine's speculation depth), ``block_kv`` rows staged in shared memory
per step, ``pack_gqa`` (one block per KV head scoring K rows of each of
its query heads, or one block per query head) and ``num_warps``. The tuned
space takes the depths ``DRAFT_KS`` and multiples of the page size; the
kernel takes any depth K >= 2 (K is a run-time argument, bounded only by
shared memory) and any positive ``block_kv`` (its copies chase the block
table row by row), which the fixed config of an off-space depth or page
size uses (checked against the plain version on the card at K 5 and with
blocks smaller than a page, ``tests/test_torch_gpu.py``). Both branches of
the TPU kernel are ported: float pools (q's dtype) and int8 pools with
per-token f32 scale pools (the kv8 policy), one template over q's type and
the pool's. Tensors on the CPU take the plain version in ``kernels.ref``;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KernelLibrary

MAX_HEAD_DIM = 256
DRAFT_KS = (2, 3, 4, 6, 8)       # the depths the space tunes
MAX_SMEM_BYTES = 232448          # 227 KB: the opt-in per-block limit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_verify_launch.argtypes = (
        [vp] * 8 + [i32] * 8 + [ctypes.c_float] + [i32] * 5 + [vp])
    lib.paged_verify_launch.restype = i32
    lib.paged_verify_smem_bytes.argtypes = [i32] * 8
    lib.paged_verify_smem_bytes.restype = i32


LIB = KernelLibrary("paged_verify", _declare)


def key_splits(rows: int, num_warps: int) -> int:
    """Warps that split each query row's keys (the kernel's S)."""
    return num_warps // rows if num_warps >= 2 * rows else 1


def smem_bytes(D: int, q_itemsize: int, kv_itemsize: int, block_kv: int,
               draft_k: int, group: int, pack_gqa: bool,
               num_warps: int) -> int:
    """Dynamic shared memory of one launch — the same formula as
    ``paged_verify_smem_bytes`` in the CUDA source: double-buffered K and
    V staging in the pool's type (``kv_itemsize`` 1 for an int8 pool,
    whose staged rows carry their two f32 scales), the block's query rows
    in q's, then the f32 (acc, m, l) of each row's key splits."""
    rows = draft_k * (group if pack_gqa and group > 1 else 1)
    row = D * kv_itemsize + (4 if kv_itemsize == 1 else 0)
    return (4 * block_kv * row + rows * D * q_itemsize
            + rows * key_splits(rows, num_warps) * (D + 2) * 4)


def paged_verify(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 kv_len: torch.Tensor, *,
                 k_scales: Optional[torch.Tensor] = None,
                 v_scales: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None,
                 block_kv: Optional[int] = None,
                 pack_gqa: bool = True,
                 num_warps: int = 4) -> torch.Tensor:
    """Block-table-indexed K-position verify attention over a page pool.

    q (B, K, Hq, D), K consecutive query positions per sequence, float32
    or bfloat16; k/v_pages (Hkv, P, page_size, D) in q's dtype, or int8
    with ``k_scales``/``v_scales`` (Hkv, P, page_size) float32 per-token
    scales (the kv8 policy; scales go with int8 pools only); block_tables
    (B, max_pages) int; kv_len (B,) int, valid tokens *including* the K
    scattered draft positions, clamped to the table capacity: query t
    attends ``k_pos <= kv_len - K + t``. Query rows with an empty window
    return zeros. ``block_kv`` defaults to one page. Returns
    (B, K, Hq, D) in q's dtype."""
    quant = k_pages.dtype == torch.int8
    if (k_scales is not None) != quant or (v_scales is not None) != quant:
        raise ValueError("paged_verify: k_scales and v_scales go with int8 "
                         f"pools and only with them (pools {k_pages.dtype})")
    if not q.is_cuda:
        return ref.paged_verify(q, k_pages, v_pages, block_tables, kv_len,
                                k_scales=k_scales, v_scales=v_scales,
                                scale=scale)
    q = q.contiguous()
    B, K, Hq, D = q.shape
    Hkv, n_pages, page_size, Dk = k_pages.shape
    if block_kv is None:
        block_kv = page_size
    group = Hq // Hkv if Hkv else 0
    pools = (k_pages, v_pages) + ((k_scales, v_scales) if quant else ())
    errors = [
        (q.dtype in (torch.float32, torch.bfloat16),
         f"q dtype {q.dtype} (float32 or bfloat16)"),
        (v_pages.dtype == k_pages.dtype
         and k_pages.dtype in (q.dtype, torch.int8),
         "the pools' dtype must be q's or int8"),
        (v_pages.shape == k_pages.shape and Dk == D, "pool shapes"),
        (not quant or all(s.dtype == torch.float32
                          and s.shape == k_pages.shape[:3]
                          for s in (k_scales, v_scales)),
         "k_scales/v_scales must be float32 (Hkv, P, page_size)"),
        (K >= 2, f"draft_k {K} < 2 (one position is paged_decode)"),
        (Hkv > 0 and Hq % Hkv == 0, f"Hq {Hq} not a multiple of Hkv {Hkv}"),
        (D <= MAX_HEAD_DIM, f"head_dim {D} > {MAX_HEAD_DIM}"),
        (D * q.element_size() % 16 == 0
         and D * k_pages.element_size() % 16 == 0,
         f"head_dim {D} rows are not 16-byte multiples"),
        (block_kv > 0, f"block_kv {block_kv}"),
        (1 <= num_warps <= 32, f"num_warps {num_warps}"),
        (block_tables.dim() == 2 and block_tables.shape[0] == B
         and kv_len.shape == (B,), "block_tables (B, max_pages), kv_len (B,)"),
        (all(t.is_cuda and t.device == q.device
             for t in pools + (block_tables, kv_len)),
         "every operand on q's device"),
        (all(t.is_contiguous() and t.data_ptr() % 16 == 0
             for t in (q,) + pools),
         "q, the pools and the scales must be contiguous and 16-byte "
         "aligned"),
    ]
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("paged_verify: " + "; ".join(bad))
    smem = smem_bytes(D, q.element_size(), k_pages.element_size(), block_kv,
                      K, group, pack_gqa, num_warps)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged_verify: {smem} bytes of shared memory > "
                         f"{MAX_SMEM_BYTES} (block_kv {block_kv}, K {K})")
    if scale is None:
        scale = D ** -0.5
    tables = block_tables.to(torch.int32).contiguous()
    lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = LIB.load()
    err = lib.paged_verify_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, K, Hq, Hkv, D, n_pages, page_size, tables.shape[1], float(scale),
        block_kv, int(bool(pack_gqa)), num_warps, _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_verify launch failed: cudaError {err}")
    paged_verify.launches += 1
    return out

paged_verify.launches = 0
