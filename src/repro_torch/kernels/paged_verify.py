"""Paged-KV speculative-verify attention: the wrapper around
``csrc/paged_verify.cu``.

The CUDA C++ kernel replaces the TPU kernel ``paged_verify`` of
``src/repro/kernels/paged_verify.py``, both its branches: float pools
(q's dtype) and int8 pools with per-token f32 scale pools (the kv8
policy), one template over q's type and the pool's. The source's header
note says what bounds it on Hopper (HBM bytes, as ``paged_decode``) and
how its design, ``paged_decode``'s carried over to K query positions,
answers that: each (sequence, head) row split over a thread-block cluster
of ``kv_splits`` blocks whose partials merge in distributed shared
memory, a ring of two chunks fed by bulk copies, and the block's K·g
query rows (or K, unpacked) held in registers, at most four to a row
group, their running state too. The source includes no header.

It is built and loaded like ``paged_decode`` (``kernels.build``); the
wrapper raises on a launch the C function refuses (a cluster the card
cannot hold resident is refused, never launched another way).

Tunables (``kernels.ops.PAGED_VERIFY``): ``draft_k`` (pinned by the
engine's speculation depth), ``block_kv`` rows a chunk, ``pack_gqa`` (one
block per KV head scoring K rows of each of its query heads, or one block
per query head) and ``kv_splits`` (blocks a row). ``num_warps`` is not
tuned: the space runs ``NUM_WARPS`` (the kernel takes 1 to 8). The tuned
space takes the depths ``DRAFT_KS`` and whole pages or a part of one
page; the kernel takes any depth K >= 2 (K is a run-time argument, bounded
only by shared memory) and any positive ``block_kv``, which the fixed
config of an off-space depth or page size uses (checked against the plain
version on the card at K 5 and 9 and with blocks smaller than a page,
``tests/test_torch_gpu.py``). ``path`` says how a launch copies its
chunks; ``paged_verify.path_launches`` counts launches by path. Tensors
on the CPU take the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel or raises.
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
MAX_WARPS = 8                    # the kernel's launch bounds
NUM_WARPS = 8                    # the warps a block runs in the space
MAX_SET = 4                      # query rows a row group holds (kMaxSet)
MAX_CLUSTER = 8                  # the portable thread-block cluster size
KV_SPLITS = (1, 2, 4, 8)         # blocks (one cluster) a row
STAGES = 2                       # the ring's depth (kStages in the source)
BAR_BYTES = 64                   # the ring's mbarriers
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_verify_launch.argtypes = (
        [vp] * 8 + [i32] * 8 + [ctypes.c_float] + [i32] * 7 + [vp])
    lib.paged_verify_launch.restype = i32
    lib.paged_verify_smem_bytes.argtypes = [i32] * 7
    lib.paged_verify_smem_bytes.restype = i32


LIB = KernelLibrary("paged_verify", _declare)


def query_rows(draft_k: int, group: int, pack_gqa: bool) -> int:
    """Query rows of a block: K positions of each packed head."""
    return draft_k * (group if pack_gqa and group > 1 else 1)


def query_sets(rows: int) -> int:
    """The fewest query sets of at most ``MAX_SET`` rows each
    (``query_sets`` of the source)."""
    return -(-rows // MAX_SET)


def _lanes_per_row(D: int, itemsize: int) -> int:
    """Lanes that share one staged row: a lane reads 16 bytes of a float
    pool, 8 bytes (8 values) of an int8 one."""
    n_vec, tpr = D // (8 if itemsize == 1 else 16 // itemsize), 1
    while tpr < n_vec and tpr < 32:
        tpr *= 2
    return tpr


def smem_bytes(D: int, itemsize: int, block_kv: int, draft_k: int,
               group: int, pack_gqa: bool,
               num_warps: int = NUM_WARPS) -> int:
    """Dynamic shared memory of one launch — the same formula as
    ``paged_verify_smem_bytes`` in the CUDA source (kept in Python so the
    config space can check it without the card): the ring's mbarriers,
    the block's partial (m, l and acc of every query row, what rank 0
    reads), and the larger of the ring of ``STAGES`` chunks of K and V
    rows and the row groups' merge of one query set each. ``itemsize`` is
    the pool's: 1 for an int8 pool, whose staged rows carry their two f32
    scales. q stays in registers, so its dtype takes no shared memory."""
    rows = query_rows(draft_k, group, pack_gqa)
    set_rows = -(-rows // query_sets(rows))
    n_rg = num_warps * 32 // _lanes_per_row(D, itemsize)
    row = D * itemsize + (4 if itemsize == 1 else 0)
    partial = -(-rows * (D + 2) * 4 // 16) * 16
    return BAR_BYTES + partial + max(STAGES * 2 * block_kv * row,
                                     n_rg * set_rows * (D + 2) * 4)


def path(itemsize: int, page_size: int, block_kv: int) -> str:
    """How a launch copies its chunks, from the layout alone (the rule of
    ``paged_decode.path``): ``"bulk"`` (one bulk copy a page run) where
    every run is a 16-byte multiple at a 16-byte aligned address, which
    float pools always are and an int8 pool's f32 scale runs are when the
    page size and ``block_kv`` are multiples of 4 rows; else
    ``"cp_async"`` (16-byte copies a row)."""
    if itemsize != 1 or (page_size % 4 == 0 and block_kv % 4 == 0):
        return "bulk"
    return "cp_async"


def paged_verify(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 kv_len: torch.Tensor, *,
                 k_scales: Optional[torch.Tensor] = None,
                 v_scales: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None,
                 block_kv: Optional[int] = None,
                 pack_gqa: bool = True,
                 num_warps: int = NUM_WARPS,
                 kv_splits: int = 1) -> torch.Tensor:
    """Block-table-indexed K-position verify attention over a page pool.

    q (B, K, Hq, D), K consecutive query positions per sequence, float32
    or bfloat16; k/v_pages (Hkv, P, page_size, D) in q's dtype, or int8
    with ``k_scales``/``v_scales`` (Hkv, P, page_size) float32 per-token
    scales (the kv8 policy; scales go with int8 pools only); block_tables
    (B, max_pages) int; kv_len (B,) int, valid tokens *including* the K
    scattered draft positions, clamped to the table capacity: query t
    attends ``k_pos <= kv_len - K + t``. Query rows with an empty window
    return zeros. ``block_kv`` defaults to one page; ``kv_splits`` blocks
    (one cluster) share each row. Returns (B, K, Hq, D) in q's dtype."""
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
        (1 <= num_warps <= MAX_WARPS, f"num_warps {num_warps}"),
        (kv_splits in KV_SPLITS, f"kv_splits {kv_splits} (of {KV_SPLITS})"),
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
    smem = smem_bytes(D, k_pages.element_size(), block_kv, K, group,
                      pack_gqa, num_warps)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged_verify: {smem} bytes of shared memory > "
                         f"{MAX_SMEM_BYTES} (block_kv {block_kv}, K {K})")
    if scale is None:
        scale = D ** -0.5
    tables = block_tables.to(torch.int32).contiguous()
    lens = kv_len.to(torch.int32).contiguous()
    route = path(k_pages.element_size(), page_size, block_kv)
    out = torch.empty_like(q)
    lib = LIB.load()
    err = lib.paged_verify_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, K, Hq, Hkv, D, n_pages, page_size, tables.shape[1], float(scale),
        block_kv, int(bool(pack_gqa)), num_warps, kv_splits,
        int(route == "bulk"), _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_verify launch failed ({route}, kv_splits "
                           f"{kv_splits}): cudaError {err}")
    paged_verify.launches += 1
    paged_verify.path_launches[route] += 1
    return out


paged_verify.launches = 0
paged_verify.path_launches = {"bulk": 0, "cp_async": 0}
