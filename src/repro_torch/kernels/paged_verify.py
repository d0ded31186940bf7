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
blocks smaller than a page, ``tests/test_torch_gpu.py``). Tensors on the CPU take the plain version in
``kernels.ref``; a CUDA tensor launches the kernel or raises. Int8 pools
(the kv8 policy) are not ported yet and raise ``NotImplementedError``.
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
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_verify_launch.argtypes = (
        [vp] * 6 + [i32] * 8 + [ctypes.c_float] + [i32] * 4 + [vp])
    lib.paged_verify_launch.restype = i32
    lib.paged_verify_smem_bytes.argtypes = [i32] * 7
    lib.paged_verify_smem_bytes.restype = i32


LIB = KernelLibrary("paged_verify", _declare)


def key_splits(rows: int, num_warps: int) -> int:
    """Warps that split each query row's keys (the kernel's S)."""
    return num_warps // rows if num_warps >= 2 * rows else 1


def smem_bytes(D: int, itemsize: int, block_kv: int, draft_k: int,
               group: int, pack_gqa: bool, num_warps: int) -> int:
    """Dynamic shared memory of one launch — the same formula as
    ``paged_verify_smem_bytes`` in the CUDA source: double-buffered K and
    V staging, the block's query rows, then the f32 (acc, m, l) of each
    row's key splits."""
    rows = draft_k * (group if pack_gqa and group > 1 else 1)
    return (4 * block_kv * D * itemsize + rows * D * itemsize
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

    q (B, K, Hq, D), K consecutive query positions per sequence; k/v_pages
    (Hkv, P, page_size, D) float32 or bfloat16 (q's dtype); block_tables
    (B, max_pages) int; kv_len (B,) int, valid tokens *including* the K
    scattered draft positions, clamped to the table capacity: query t
    attends ``k_pos <= kv_len - K + t``. Query rows with an empty window
    return zeros. ``block_kv`` defaults to one page. Returns
    (B, K, Hq, D) in q's dtype."""
    if k_pages.dtype == torch.int8 or k_scales is not None \
            or v_scales is not None:
        raise NotImplementedError(
            "int8 pools (the kv8 policy) are not ported yet")
    if not q.is_cuda:
        return ref.paged_verify(q, k_pages, v_pages, block_tables, kv_len,
                                scale=scale)
    q = q.contiguous()
    B, K, Hq, D = q.shape
    Hkv, n_pages, page_size, Dk = k_pages.shape
    if block_kv is None:
        block_kv = page_size
    group = Hq // Hkv if Hkv else 0
    errors = [
        (q.dtype in _DTYPE_CODE, f"dtype {q.dtype} (float32 or bfloat16)"),
        (k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
         "q and the pools must share a dtype"),
        (v_pages.shape == k_pages.shape and Dk == D, "pool shapes"),
        (K >= 2, f"draft_k {K} < 2 (one position is paged_decode)"),
        (Hkv > 0 and Hq % Hkv == 0, f"Hq {Hq} not a multiple of Hkv {Hkv}"),
        (D <= MAX_HEAD_DIM, f"head_dim {D} > {MAX_HEAD_DIM}"),
        (D * q.element_size() % 16 == 0,
         f"head_dim {D} rows are not 16-byte multiples"),
        (block_kv > 0, f"block_kv {block_kv}"),
        (1 <= num_warps <= 32, f"num_warps {num_warps}"),
        (block_tables.dim() == 2 and block_tables.shape[0] == B
         and kv_len.shape == (B,), "block_tables (B, max_pages), kv_len (B,)"),
        (all(t.is_cuda and t.device == q.device
             for t in (k_pages, v_pages, block_tables, kv_len)),
         "every operand on q's device"),
        (all(t.is_contiguous() and t.data_ptr() % 16 == 0
             for t in (q, k_pages, v_pages)),
         "q and the pools must be contiguous and 16-byte aligned"),
    ]
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError("paged_verify: " + "; ".join(bad))
    smem = smem_bytes(D, q.element_size(), block_kv, K, group, pack_gqa,
                      num_warps)
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
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, K, Hq, Hkv, D, n_pages, page_size, tables.shape[1], float(scale),
        block_kv, int(bool(pack_gqa)), num_warps, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_verify launch failed: cudaError {err}")
    paged_verify.launches += 1
    return out


paged_verify.launches = 0
