"""Ragged GQA decode over a dense KV cache: the wrapper around
``csrc/gqa_decode.cu``.

The CUDA C++ kernel replaces the TPU kernel ``gqa_decode`` of
``src/repro/kernels/gqa_decode.py`` (whose body is ``_decode_kernel`` of
``src/repro/kernels/decode_attention.py``); ``kernels.decode_attention``
launches the same kernel with the query group packed, as the reference's
two modules share ``_decode_kernel``. The source's header note says what
bounds it on Hopper (HBM bytes) and how its design answers that: each row
split over a thread-block cluster of ``k_splits`` blocks whose partials
merge in distributed shared memory, in one launch, and a ring of two
chunks fed by TMA (bf16) or cp.async (f32). It is built and loaded like
``paged_decode`` (``kernels.build``); a bf16 cache that a tensor map
cannot take, or a cluster the card cannot hold, makes the launch fail and
the wrapper raise.

Cache layout: the kernel reads K and V through the strides of the
``(B, Hkv, T, D)`` tensors it is handed, with D contiguous. The serving
cache stays ``(B, T, Hkv, D)``, as the reference stores it, and
``models.attention.attn_decode`` passes ``cache.transpose(1, 2)``: no copy
of the cache per step.

Tunables (``kernels.ops.GQA_DECODE_RAGGED``): ``block_kv`` keys a chunk
(a multiple of 16 up to 256: a TMA box's rows, each block of a stage on
its swizzle atom), ``k_splits`` blocks (one cluster) a row
(``KV_SPLITS``), ``pack_gqa`` (one row per KV head scoring its whole
query group, or one per query head) and ``num_warps`` (1-8, each scoring
32 keys at a time). ``block_kv`` is clamped to the cache length rounded
up to a warp's 32 keys, as the reference clamps it to its 128-lane tile.
Tensors on the CPU take the plain version in ``kernels.ref``; a CUDA
tensor launches the kernel or raises.

An int8 cache (the kv8 policy) goes through ``kernels.gqa_decode_kv8``,
which launches the kernel template of ``csrc/gqa_decode.cuh`` built for
int8 rows (``csrc/gqa_decode_kv8.cu``, the library ``LIB_KV8``) through
``launch`` with the cache's scales: that kernel keeps the splits of a
grid axis combined by a second launch, and ``smem_bytes`` is its shared
memory. This wrapper refuses an int8 cache.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import KernelLibrary

MAX_HEAD_DIM = 256
MAX_PACKED_GROUP = 8
MAX_SMEM_BYTES = 232448          # 227 KB: the opt-in per-block limit
KEY_TILE = 32                    # keys a warp scores at a time
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The float kernel (csrc/gqa_decode.cu)
KV_SPLITS = (1, 2, 4, 8)         # blocks (one cluster, at most the
                                 # portable size: kMaxSplits) a row
MAX_WARPS = 8                    # the kernel's launch bounds
MAX_BLOCK_KV = 256               # a TMA box's rows
STAGES = 2                       # the ring's depth (kStages)
BAR_BYTES = 64                   # the ring's mbarriers (kBarBytes)
ALIGN_BYTES = 1024               # slack to a swizzle atom (kAlign)


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gqa_decode_launch.argtypes = (
        [vp] * 5 + [i32] * 5 + [i64] * 3 + [ctypes.c_float] + [i32] * 5
        + [vp])
    lib.gqa_decode_launch.restype = i32
    lib.gqa_decode_smem_bytes.argtypes = [i32] * 5
    lib.gqa_decode_smem_bytes.restype = i32


def _declare_kv8(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gqa_decode_kv8_launch.argtypes = (
        [vp] * 9 + [i32] * 5 + [i64] * 6 + [ctypes.c_float] + [i32] * 5
        + [vp])
    lib.gqa_decode_kv8_launch.restype = i32
    lib.gqa_decode_kv8_smem_bytes.argtypes = [i32] * 4
    lib.gqa_decode_kv8_smem_bytes.restype = i32


LIB = KernelLibrary("gqa_decode", _declare)
LIB_KV8 = KernelLibrary("gqa_decode_kv8", _declare_kv8)


def rows_per_block(group: int, pack_gqa: bool) -> int:
    return group if pack_gqa and group > 1 else 1


def clamp_block_kv(block_kv: int, T: int) -> int:
    """The block the kernel stages: ``block_kv`` clamped to the cache
    length rounded up to whole warps of keys."""
    return min(block_kv, -(-T // KEY_TILE) * KEY_TILE)


def smem_bytes(D: int, itemsize: int, block_kv: int, group: int,
               pack_gqa: bool, num_warps: int) -> int:
    """Dynamic shared memory of one int8 launch — the same formula as
    ``smem_bytes`` in ``csrc/gqa_decode.cuh`` (``itemsize`` the cache's,
    1 for int8 rows): the block's query rows in
    f32, then the larger of the double-buffered K/V staging (rows padded
    by 16 bytes) and the warps' f32 (acc, m, l) merged at the end."""
    rows = rows_per_block(group, pack_gqa)
    return rows * D * 4 + max(4 * block_kv * (D * itemsize + 16),
                              num_warps * rows * (D + 2) * 4)


def tile_bytes(D: int, itemsize: int, block_kv: int) -> int:
    """One stage of K (or of V) in shared memory — ``tile_bytes`` of the
    CUDA source: ``block_kv`` rows of each column block of D, 128-byte
    rows, and 64-byte rows for a row's last 1-64 bytes."""
    row = D * itemsize
    tail = row % 128
    return (row - tail + (128 if tail > 64 else 64 if tail else 0)) * block_kv


def float_smem_bytes(D: int, itemsize: int, block_kv: int, group: int,
                     pack_gqa: bool, num_warps: int) -> int:
    """Dynamic shared memory of one float launch — the same formula as
    ``gqa_decode_smem_bytes`` in ``csrc/gqa_decode.cu`` (kept in Python so
    the config space can check it without the card): slack to align the
    ring, the larger of the ring of ``STAGES`` chunks of K and V
    (``tile_bytes`` each) and the warps' f32 (m, l, acc) merged at the
    end, the block's query rows in f32, the warps' probability scratch,
    the block's partial (what rank 0 reads) and the mbarriers."""
    rows = rows_per_block(group, pack_gqa)
    tile = tile_bytes(D, itemsize, block_kv)
    merge = -(-num_warps * rows * (D + 2) * 4 // 16) * 16
    partial = -(-rows * (D + 2) * 4 // 16) * 16
    return (ALIGN_BYTES + max(STAGES * 2 * tile, merge) + rows * D * 4
            + num_warps * rows * KEY_TILE * 4 + partial + BAR_BYTES)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: Optional[torch.Tensor], *, scale: Optional[float],
           block_kv: int, k_splits: int, pack_gqa: bool, num_warps: int,
           name: str,
           scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
           ) -> torch.Tensor:
    """Check the operands and launch the kernel on q's stream; returns
    (B, Hq, D) in q's dtype. A float cache shares q's dtype and goes
    through the one-launch kernel of ``csrc/gqa_decode.cu``; an int8
    cache comes with ``scales`` = (k_scale, v_scale), (B, Hkv, T) f32,
    any strides, and goes through ``csrc/gqa_decode_kv8.cu`` and its
    combine. Counts nothing: the public wrappers count their own
    launches."""
    quant = scales is not None
    if (k.dtype == torch.int8) != quant:
        raise ValueError(
            f"{name}: " + ("an int8 cache goes through gqa_decode_kv8 with "
                           "its scales" if not quant else
                           "takes an int8 cache with its scales"))
    if not q.is_cuda:
        if quant:
            return ref.gqa_decode_kv8(q, k, v, *scales, kv_len=kv_len,
                                      scale=scale)
        return ref.gqa_decode(q, k, v, kv_len=kv_len, scale=scale)
    q = q.contiguous()
    B, Hq, D = q.shape
    if kv_len is None:
        kv_len = torch.full((B,), k.shape[2], dtype=torch.int32,
                            device=q.device)
    _, Hkv, T, Dk = k.shape
    group = Hq // Hkv if Hkv else 0
    item = k.element_size()
    errors = [
        (q.dtype in _DTYPE_CODE, f"dtype {q.dtype} (float32 or bfloat16)"),
        (v.dtype == k.dtype and (quant or k.dtype == q.dtype),
         "k and v must share a dtype, q's for a float cache"),
        (k.shape == v.shape and k.shape[0] == B and Dk == D,
         "k, v (B, Hkv, T, D) with q's B and D"),
        (k.stride() == v.stride() and k.stride(-1) == 1,
         "k and v must share strides, D contiguous"),
        (all(s * item % 16 == 0 for s in k.stride()[:3]),
         "cache strides must be 16-byte multiples"),
        (T > 0, "an empty cache"),
        (Hkv > 0 and Hq % Hkv == 0, f"Hq {Hq} not a multiple of Hkv {Hkv}"),
        (D <= MAX_HEAD_DIM, f"head_dim {D} > {MAX_HEAD_DIM}"),
        (D * item % 16 == 0, f"head_dim {D} rows are not 16-byte multiples"),
        (not (pack_gqa and group > MAX_PACKED_GROUP),
         f"pack_gqa with group {group} > {MAX_PACKED_GROUP}"),
        (kv_len.shape == (B,), "kv_len (B,)"),
        (all(t.is_cuda and t.device == q.device for t in (k, v, kv_len)),
         "every operand on q's device"),
        (all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
         "q and the cache must be 16-byte aligned"),
    ]
    if quant:
        ks, vs = scales
        errors += [
            (block_kv > 0, f"block_kv {block_kv}"),
            (1 <= k_splits <= 32, f"k_splits {k_splits}"),
            (1 <= num_warps <= 32, f"num_warps {num_warps}"),
            (ks.dtype == vs.dtype == torch.float32,
             "k_scale and v_scale must be float32"),
            (ks.shape == vs.shape == (B, Hkv, T),
             "k_scale, v_scale (B, Hkv, T)"),
            (ks.stride() == vs.stride(),
             "k_scale and v_scale must share strides"),
            (all(t.is_cuda and t.device == q.device for t in (ks, vs)),
             "the scales on q's device"),
            (all(t.data_ptr() % 4 == 0 for t in (ks, vs)),
             "the scales must be 4-byte aligned"),
        ]
    else:
        errors += [
            (0 < block_kv and block_kv % 16 == 0
             and clamp_block_kv(block_kv, T) <= MAX_BLOCK_KV,
             f"block_kv {block_kv} (a multiple of 16, at most "
             f"{MAX_BLOCK_KV} staged)"),
            (k_splits in KV_SPLITS, f"k_splits {k_splits} (of {KV_SPLITS})"),
            (1 <= num_warps <= MAX_WARPS, f"num_warps {num_warps}"),
        ]
    bad = [msg for ok, msg in errors if not ok]
    if bad:
        raise ValueError(f"{name}: " + "; ".join(bad))
    block_kv = clamp_block_kv(block_kv, T)
    fits = smem_bytes if quant else float_smem_bytes
    smem = fits(D, item, block_kv, group, pack_gqa, num_warps)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: {smem} bytes of shared memory > "
                         f"{MAX_SMEM_BYTES} (block_kv {block_kv})")
    if scale is None:
        scale = D ** -0.5
    lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    sb, sh, st, _ = k.stride()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    cfg = (float(scale), block_kv, k_splits, int(bool(pack_gqa)), num_warps,
           _DTYPE_CODE[q.dtype], stream)
    if quant:
        part_o = part_lse = None
        if k_splits > 1:
            g = rows_per_block(group, pack_gqa)
            rows = B * Hq // g
            part_o = torch.empty(rows, k_splits, g, D, dtype=torch.float32,
                                 device=q.device)
            part_lse = torch.empty(rows, k_splits, g, dtype=torch.float32,
                                   device=q.device)
        tail = (None if part_o is None else part_o.data_ptr(),
                None if part_lse is None else part_lse.data_ptr(),
                B, Hq, Hkv, T, D, sb, sh, st)
        err = LIB_KV8.load().gqa_decode_kv8_launch(
            *ptrs, ks.data_ptr(), vs.data_ptr(), lens.data_ptr(),
            out.data_ptr(), *tail, *ks.stride(), *cfg)
    else:
        err = LIB.load().gqa_decode_launch(
            *ptrs, lens.data_ptr(), out.data_ptr(), B, Hq, Hkv, T, D, sb, sh,
            st, *cfg)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: cudaError {err}" + (
                "" if quant else f" (k_splits {k_splits}: a cluster the card "
                "cannot hold, or a bf16 cache no tensor map takes)"))
    return out


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               kv_len: Optional[torch.Tensor] = None,
               scale: Optional[float] = None, block_kv: int = 64,
               k_splits: int = 1, pack_gqa: bool = True,
               num_warps: int = 4) -> torch.Tensor:
    """Ragged batched GQA decode. q (B, Hq, D); k, v (B, Hkv, T, D) float32
    or bfloat16 (q's dtype), any strides with D contiguous; kv_len (B,)
    int, clamped to T (None: every request attends all T). Requests with
    kv_len == 0 get zeros. Returns (B, Hq, D) in q's dtype."""
    out = launch(q, k, v, kv_len, scale=scale, block_kv=block_kv,
                 k_splits=k_splits, pack_gqa=pack_gqa, num_warps=num_warps,
                 name="gqa_decode")
    if q.is_cuda:
        gqa_decode.launches += 1
    return out


gqa_decode.launches = 0
