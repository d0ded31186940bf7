"""Autotuned kernel entry points (subset of ``repro.kernels.ops``).

For each of the port's kernels this module declares

  * a **Hopper** ``ConfigSpace`` whose validity follows the card (shared
    memory per block, registers per thread) — the TPU spaces and the
    shipped TPU tuning DB do not carry over, every key there names a TPU;
  * a workload that counts the bytes (and operations) a call moves;
  * a runner factory that builds operands on the card for timing a config;
  * a heuristic default;

and the entry points ``paged_decode(...)``, ``paged_verify(...)``,
``decode(...)``, ``ragged_decode(...)``, ``ragged_decode_kv8(...)``,
``matmul(...)``, ``matmul_w8a8(...)``, ``attention(...)``,
``attention_bwd(...)``, ``latent_decode(...)`` and ``rmsnorm(...)`` that
resolve their config
through the tuner and dispatch. Every entry point accepts
``config=`` to bypass tuning. Tensors on the CPU need no config: the
kernel wrappers run their plain versions there. A pool laid out with a
page size outside the space, or a verify deeper or shallower than the
tuned depths, dispatches a fixed config with no tuning, as the reference
does.

Importing this module registers the eleven kernels in ``kernels.registry``
under the reference's names, scenarios and bench cases.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import (
    Autotuner, Config, ConfigSpace, KernelRunner, KernelWorkload, Param,
    TunableKernel, TuningContext, current_chip, default_tuner,
)
from repro_torch.core.config_space import dtype_bytes, smem_fits
from repro_torch.kernels import decode_attention as da_kernel
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import flash_attention_bwd as fab_kernel
from repro_torch.kernels import gqa_decode as gqa_kernel
from repro_torch.kernels import gqa_decode_kv8 as kv8_kernel
from repro_torch.kernels import matmul as mm_kernel
from repro_torch.kernels import matmul_w8a8 as mm8_kernel
from repro_torch.kernels import mla_decode as mla_kernel
from repro_torch.kernels import paged_decode as pd_kernel
from repro_torch.kernels import paged_verify as pv_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import rms_norm as rms_kernel
from repro_torch.quant import absmax_scale, quantize, quantize_kv
from repro_torch.quant.qtensor import k_major


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rup(a: int, b: int) -> int:
    return _cdiv(a, b) * b


@functools.lru_cache(maxsize=8)
def device_chip(device_index: int):
    """Spec of CUDA card ``device_index``, built once per process."""
    return current_chip(device_index)


# Operands built for timing are memoized by scenario: a space tunes many
# configs on the same pool. Two entries bound the device memory held (the
# deployment pool is ~1 GB per tensor and configs are enumerated grouped
# by page size).
_OPERANDS: Dict[Tuple, object] = {}
_OPERANDS_MAX = 2


def _memo_operands(key: Tuple, build):
    if key not in _OPERANDS:
        while len(_OPERANDS) >= _OPERANDS_MAX:
            _OPERANDS.pop(next(iter(_OPERANDS)))
        _OPERANDS[key] = build()
    return _OPERANDS[key]


def release_tuning_operands() -> None:
    """Drop the operands built for timing (the deployment pool holds about
    2 GB); serving calls this once its contexts are tuned."""
    _OPERANDS.clear()


def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


def _q_dtype(ctx: TuningContext) -> str:
    """q's dtype. A float context's dtype is q's and the cache's; an int8
    context's (kv8) is the cache's, and q rides in ``extra["q_dtype"]``:
    float32 in the reference's bench cases, the model's dtype at
    serving."""
    if ctx.dtype != "int8":
        return ctx.dtype
    return ctx.extra.get("q_dtype", "float32")


def _fixed_block_kv(page_size: int, smem_of, limit: int) -> int:
    """The reference's fixed block of one page, halved until its shared
    memory (``smem_of(block_kv)``) fits the kernel's limit."""
    block_kv = page_size
    while block_kv > 1 and smem_of(block_kv) > limit:
        block_kv = _cdiv(block_kv, 2)
    return block_kv


# ===========================================================================
# Paged decode (block-table attention over the shared page pool)
# ===========================================================================

PAGE_SIZES = (8, 16, 32, 64, 128)
BLOCK_KV = (16, 32, 64, 128, 256)


def _group(ctx: TuningContext) -> int:
    return ctx.shape("q")[1] // ctx.shape("k")[1]


def _paged_smem(cfg: Config, ctx: TuningContext) -> int:
    D = ctx.shape("q")[2]
    return pd_kernel.smem_bytes(D, dtype_bytes(ctx.dtype), cfg["block_kv"],
                                _group(ctx), cfg["pack_gqa"],
                                cfg["num_warps"])


def _paged_chunks(cfg: Config, ctx: TuningContext) -> int:
    """Chunks of ``block_kv`` tokens in the pool's capacity."""
    cap = _rup(ctx.shape("k")[2], cfg["page_size"])
    return _cdiv(cap, cfg["block_kv"])


def paged_decode_space() -> ConfigSpace:
    sp = ConfigSpace(
        "paged_decode",
        [
            Param("page_size", PAGE_SIZES),
            Param("block_kv", BLOCK_KV),
            Param("pack_gqa", (True, False)),
            Param("num_warps", (2, 4, 8)),
            Param("kv_splits", pd_kernel.KV_SPLITS),
        ],
        version=2,
    )
    sp.constrain("smem", smem_fits(_paged_smem))
    # A chunk is whole pages, or a part of one page (the bulk copies start
    # mid-page), so a large page still streams in small chunks.
    sp.constrain("block_kv:page_size",
                 lambda c, x: c["block_kv"] % c["page_size"] == 0
                 or c["page_size"] % c["block_kv"] == 0)
    sp.constrain(
        "block_kv<=capacity",
        lambda c, x: c["block_kv"] <= _rup(x.shape("k")[2], c["page_size"]))
    # A deployed pool fixes the page size (extra["page_size"]); deployment
    # tuning (no extra) sweeps it and the winner sizes the pool.
    sp.constrain("page_size==pool",
                 lambda c, x: ("page_size" not in x.extra
                               or c["page_size"] == x.extra["page_size"]))
    # Packing a group of one is the unpacked kernel; past eight heads the
    # packed kernel is not instantiated.
    sp.constrain("pack_gqa:group",
                 lambda c, x: not c["pack_gqa"]
                 or 1 < _group(x) <= pd_kernel.MAX_PACKED_GROUP)
    # No split smaller than one chunk: it would run as a smaller split does.
    sp.constrain("kv_splits<=chunks",
                 lambda c, x: c["kv_splits"] <= _paged_chunks(c, x))
    # The splits of a row run as one thread-block cluster: at most the
    # portable cluster size, which any SM layout of the card can hold.
    sp.constrain("cluster",
                 lambda c, x: c["kv_splits"] <= pd_kernel.MAX_CLUSTER)
    return sp


def paged_decode_bytes(B: int, Hq: int, Hkv: int, D: int, kv_tokens: float,
                       max_pages: int, itemsize: int, *,
                       q_itemsize: Optional[int] = None,
                       scale_bytes: int = 0) -> float:
    """HBM bytes of one call reading each K/V row once: the dense decode's
    (``dense_decode_bytes``: the K and V rows of ``kv_tokens`` resident
    tokens, int8 ones with their f32 scales, q in, o out, the lengths)
    and the block tables."""
    return dense_decode_bytes(B, Hq, Hkv, D, kv_tokens, itemsize,
                              q_itemsize=q_itemsize,
                              scale_bytes=scale_bytes) + 4.0 * B * max_pages


def paged_decode_flops(Hq: int, D: int, kv_tokens: float) -> float:
    """q·k and p·v: 4 operations per resident token, query head and dim."""
    return 4.0 * kv_tokens * Hq * D


def _ragged_lens(ctx: TuningContext) -> torch.Tensor:
    """The ragged lengths the runners of paged_decode and
    gqa_decode_ragged time with: the reference's seed-7 draw in
    [1, T * fill] (seeded, on the CPU)."""
    B = ctx.shape("q")[0]
    T = ctx.shape("k")[2]
    hi = max(2, int(T * float(ctx.extra.get("fill", 1.0)))) + 1
    gen = torch.Generator().manual_seed(7)
    return torch.randint(1, hi, (B,), generator=gen, dtype=torch.int32)


def _paged_workload(cfg: Config, ctx: TuningContext) -> KernelWorkload:
    """What the timed call moves under ``cfg``: unpacked heads each read
    their KV head's rows, so the group re-reads them. An int8 context
    (kv8) reads int8 rows with their f32 scales, q and o in q's dtype,
    and counts operations at q's dtype's peak (the pool is dequantized to
    f32 first)."""
    B, Hq, D = ctx.shape("q")
    Hkv, T = ctx.shape("k")[1], ctx.shape("k")[2]
    ps = cfg["page_size"]
    kv_tokens = float(torch.clamp(_ragged_lens(ctx), max=_rup(T, ps)).sum())
    reads = 1 if cfg["pack_gqa"] else _group(ctx)
    q_dtype = _q_dtype(ctx)
    return KernelWorkload(
        flops=paged_decode_flops(Hq, D, kv_tokens),
        hbm_bytes=paged_decode_bytes(
            B, Hq, Hkv, D, kv_tokens * reads, _cdiv(T, ps),
            dtype_bytes(ctx.dtype), q_itemsize=dtype_bytes(q_dtype),
            scale_bytes=4 if ctx.dtype == "int8" else 0),
        dtype=q_dtype)


def _fill_splits(ctx: TuningContext, pack: bool, block_kv: int) -> int:
    """The fewest kv_splits (none smaller than a chunk) whose rows x
    kv_splits blocks give every SM a block: a row is (b, kv head) packed,
    (b, q head) unpacked."""
    B, Hq = ctx.shape("q")[:2]
    rows = B * (ctx.shape("k")[1] if pack else Hq)
    cap = _rup(ctx.shape("k")[2], int(ctx.extra.get("page_size", 16)))
    splits = [s for s in pd_kernel.KV_SPLITS if s <= _cdiv(cap, block_kv)]
    return next((s for s in splits if rows * s >= ctx.chip.sm_count),
                splits[-1])


def _paged_heuristic(ctx: TuningContext) -> Config:
    """vLLM-style default: 16-token pages, 64 rows per step, packed heads;
    the fewest splits that give every SM a block."""
    ps = int(ctx.extra.get("page_size", 16))
    cap = _rup(ctx.shape("k")[2], ps)
    fits = [v for v in BLOCK_KV if v % ps == 0 and v <= max(64, ps)
            and v <= cap]
    block_kv = max(fits) if fits else ps
    pack = 1 < _group(ctx) <= pd_kernel.MAX_PACKED_GROUP
    return {"page_size": ps, "block_kv": block_kv, "pack_gqa": pack,
            "num_warps": 4, "kv_splits": _fill_splits(ctx, pack, block_kv)}


def _pool_operands(ctx: TuningContext, ps: int, lens: torch.Tensor,
                   device, K: Optional[int] = None):
    """A filled pool of pages of ``ps`` from the logical (q, k) shapes;
    page 0 is the scratch page and each sequence owns a contiguous run of
    pages. q is (B, Hq, D), or (B, K, Hq, D) for a verify of depth K.
    An int8 context (kv8) quantizes the pools through the wire format
    (``quant.quantize_kv``, as serving writes them) with q in its own
    dtype. Returns (args (q, k_pages, v_pages, tables, lens), kwargs:
    ``k_scales``/``v_scales`` under int8)."""
    B, Hq, D = ctx.shape("q")
    Hkv, T = ctx.shape("k")[1], ctx.shape("k")[2]
    quant = ctx.dtype == "int8"
    dtype = torch.float32 if quant else getattr(torch, ctx.dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    pps = _cdiv(T, ps)
    n_pages = 1 + B * pps
    q = _randn((B, Hq, D) if K is None else (B, K, Hq, D),
               getattr(torch, _q_dtype(ctx)), gen)
    kp = _randn((Hkv, n_pages, ps, D), dtype, gen)
    vp = _randn((Hkv, n_pages, ps, D), dtype, gen)
    tbl = torch.arange(1, n_pages, dtype=torch.int32,
                       device=device).reshape(B, pps)
    kw = {}
    if quant:
        kp, ks, vp, vs = quantize_kv(kp, vp)
        kw = {"k_scales": ks, "v_scales": vs}
    return (q, kp, vp, tbl, lens.to(device)), kw


def _paged_operands(ctx: TuningContext, cfg: Optional[Config] = None,
                    device="cuda"):
    """Registry operands: the pool at the config's (or the context's, or
    16-token) page size, ragged lengths from ``extra["fill"]``."""
    ps = int((cfg or {}).get("page_size", ctx.extra.get("page_size", 16)))
    return _pool_operands(ctx, ps, _ragged_lens(ctx), device)


def _paged_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    """A filled pool with the config's page size (``_pool_operands``)."""
    ps = cfg["page_size"]
    args, kw = _memo_operands(
        ("paged_decode", ctx.signature(), ps),
        lambda: _pool_operands(ctx, ps, _ragged_lens(ctx), "cuda"))
    return KernelRunner(pd_kernel.paged_decode, *args, **kw,
                        block_kv=cfg["block_kv"], pack_gqa=cfg["pack_gqa"],
                        num_warps=cfg["num_warps"],
                        kv_splits=cfg["kv_splits"])


PAGED_DECODE = TunableKernel(
    name="paged_decode",
    space=paged_decode_space(),
    version=2,
    workload_fn=_paged_workload,
    make_runner=_paged_runner,
    heuristic=_paged_heuristic,
)


def paged_decode_context(chip, B: int, Hq: int, Hkv: int, D: int,
                         capacity: int, dtype: str,
                         page_size: Optional[int] = None,
                         q_dtype: Optional[str] = None) -> TuningContext:
    """Tuning scenario of a decode over B sequences of ``capacity`` token
    slots; ``page_size`` pins the pool's layout (omit it for deployment
    tuning, where the winner sizes the pool). ``dtype`` is the pool's:
    an int8 pool (kv8) keys apart from the float pools of the same shapes,
    with q's dtype in ``extra`` unless it is the reference's float32 (as
    ``gqa_decode_kv8_context``)."""
    extra = {} if page_size is None else {"page_size": int(page_size)}
    if dtype == "int8" and q_dtype not in (None, "float32"):
        extra["q_dtype"] = q_dtype
    return TuningContext(chip=chip, shapes={"q": (B, Hq, D),
                                            "k": (B, Hkv, capacity, D)},
                         dtype=dtype, extra=extra)


def paged_decode_fixed_config(group: int, D: int, page_size: int,
                              itemsize: int) -> Config:
    """What a pool with an off-space page size dispatches, untuned: the
    reference's one page per step with packed heads
    (``src/repro/kernels/ops.py:836-840``), one block a row, the block
    halved until it fits in shared memory (pages of 256 at bf16 and D 128
    would stage 256 KB). ``itemsize`` is the pool's (1 for int8, whose
    rows stage their scales too), not q's."""
    pack = 1 < group <= pd_kernel.MAX_PACKED_GROUP
    block_kv = _fixed_block_kv(
        page_size, lambda bkv: pd_kernel.smem_bytes(D, itemsize, bkv, group,
                                                    pack, 4),
        pd_kernel.MAX_SMEM_BYTES)
    return {"block_kv": block_kv, "pack_gqa": pack, "num_warps": 4,
            "kv_splits": 1}


def paged_decode_config(q, k_pages, block_tables,
                        tuner: Optional[Autotuner] = None) -> Config:
    """The config a decode on these operands dispatches: the fixed config
    for a pool whose page size is outside the space, else the tuner's
    for the pool's layout (memoized per shape)."""
    B, Hq, D = q.shape
    Hkv, _, ps, _ = k_pages.shape
    if ps not in PAGE_SIZES:
        return paged_decode_fixed_config(Hq // Hkv, D, ps,
                                         k_pages.element_size())
    tuner = tuner or default_tuner()
    max_pages = block_tables.shape[1]
    dt, qt = dtype_name(k_pages.dtype), dtype_name(q.dtype)
    # an int8 pool's scenario also depends on q's dtype (its bytes and
    # peak); a float pool's dtype is q's
    key = (B, Hq, Hkv, D, ps, max_pages, dt, qt, q.device.index)
    return tuner.dispatch_config(
        PAGED_DECODE, key,
        lambda: paged_decode_context(device_chip(q.device.index), B, Hq, Hkv,
                                     D, max_pages * ps, dt, ps, qt))


def paged_decode(q, k_pages, v_pages, block_tables, kv_len, *,
                 k_scales=None, v_scales=None,
                 scale: Optional[float] = None,
                 config: Optional[Config] = None,
                 tuner: Optional[Autotuner] = None):
    """Autotuned paged decode. q (B, Hq, D); k/v_pages (Hkv, P, page_size,
    D) in q's dtype, or int8 with ``k_scales``/``v_scales`` (Hkv, P,
    page_size) f32 (the kv8 policy: an "int8" context, so int8 and float
    pools tune apart); block_tables (B, max_pages); kv_len (B,). The pool
    pins ``page_size``, so the lookup context carries it and the
    remaining tunables dispatch to the kernel."""
    if config is None and q.is_cuda:
        config = paged_decode_config(q, k_pages, block_tables, tuner)
    cfg = {k: v for k, v in (config or {}).items() if k != "page_size"}
    return pd_kernel.paged_decode(q, k_pages, v_pages, block_tables, kv_len,
                                  k_scales=k_scales, v_scales=v_scales,
                                  scale=scale, **cfg)


# ===========================================================================
# Paged verify (speculative decoding: K draft positions per sequence scored
# in one launch, each with its causal tail over the same page pool)
# ===========================================================================

def _verify_smem(cfg: Config, ctx: TuningContext) -> int:
    """The kernel's shared memory: staging in the pool's dtype (an int8
    context's rows with their scales) and the block's partial; q stays in
    registers."""
    D = ctx.shape("q")[2]
    return pv_kernel.smem_bytes(D, dtype_bytes(ctx.dtype), cfg["block_kv"],
                                cfg["draft_k"], _group(ctx), cfg["pack_gqa"])


def paged_verify_space() -> ConfigSpace:
    # No num_warps: every block runs pv_kernel.NUM_WARPS, so a deployment
    # context keeps at most 1,000 valid configs (five depths, 25 page and
    # block pairs, both packings, four splits) and the DB's tune of its six
    # entries stays one chip call.
    sp = ConfigSpace(
        "paged_verify",
        [
            Param("draft_k", pv_kernel.DRAFT_KS),
            Param("page_size", PAGE_SIZES),
            Param("block_kv", BLOCK_KV),
            Param("pack_gqa", (True, False)),
            Param("kv_splits", pv_kernel.KV_SPLITS),
        ],
        version=2,
    )
    sp.constrain("smem", smem_fits(_verify_smem))
    # A chunk is whole pages, or a part of one page (the bulk copies start
    # mid-page), so a large page still streams in small chunks.
    sp.constrain("block_kv:page_size",
                 lambda c, x: c["block_kv"] % c["page_size"] == 0
                 or c["page_size"] % c["block_kv"] == 0)
    # With this constraint the reference's canonicalisation (block_kv
    # clamped to the capacity) maps every valid config to itself.
    sp.constrain(
        "block_kv<=capacity",
        lambda c, x: c["block_kv"] <= _rup(x.shape("k")[2], c["page_size"]))
    # Layout pins, as in paged_decode: a deployed pool fixes page_size and
    # the engine's speculation depth fixes draft_k (extra); deployment
    # tuning (no extra) sweeps both, and its winner recommends the depth.
    sp.constrain("page_size==pool",
                 lambda c, x: ("page_size" not in x.extra
                               or c["page_size"] == x.extra["page_size"]))
    sp.constrain("draft_k==request",
                 lambda c, x: ("draft_k" not in x.extra
                               or c["draft_k"] == x.extra["draft_k"]))
    # Packing a group of one is the unpacked kernel.
    sp.constrain("pack_gqa:group",
                 lambda c, x: not c["pack_gqa"] or _group(x) > 1)
    # No split smaller than one chunk: it would run as a smaller split does.
    sp.constrain("kv_splits<=chunks",
                 lambda c, x: c["kv_splits"] <= _paged_chunks(c, x))
    # The splits of a row run as one thread-block cluster: at most the
    # portable cluster size, which any SM layout of the card can hold.
    sp.constrain("cluster",
                 lambda c, x: c["kv_splits"] <= pv_kernel.MAX_CLUSTER)
    return sp


def verify_attended(kv_len: torch.Tensor, K: int, capacity: int) -> float:
    """Keys the K query rows of every sequence attend, summed: row t of a
    sequence of L = min(kv_len, capacity) tokens sees L - K + t + 1."""
    lens = torch.clamp(kv_len.long().cpu(), 0, capacity)
    t = torch.arange(K)
    return float(torch.clamp(lens[:, None] - K + t[None] + 1, min=0).sum())


def paged_verify_bytes(B: int, K: int, Hq: int, Hkv: int, D: int,
                       kv_tokens: float, max_pages: int, itemsize: int, *,
                       q_itemsize: Optional[int] = None,
                       scale_bytes: int = 0) -> float:
    """HBM bytes of one call reading each K/V row once: paged_decode's
    bytes with K query positions — the K and V rows of ``kv_tokens``
    resident tokens (drafts included) over Hkv heads (int8 ones with their
    f32 scales), the K query rows in and the K output rows out (in
    ``q_itemsize``, by default the pool's), the block tables and
    lengths."""
    return paged_decode_bytes(B, K * Hq, Hkv, D, kv_tokens, max_pages,
                              itemsize, q_itemsize=q_itemsize,
                              scale_bytes=scale_bytes)


def paged_verify_flops(Hq: int, D: int, attended: float) -> float:
    """q·k and p·v: 4 operations per attended (query row, key) pair, query
    head and dim."""
    return 4.0 * attended * Hq * D


def _verify_lens(ctx: TuningContext, K: int) -> torch.Tensor:
    """Ragged lengths the runner times with, all >= K: the engine always
    scatters its K positions before verifying them (seeded, on the CPU)."""
    B = ctx.shape("q")[0]
    T = ctx.shape("k")[2]
    hi = max(K + 1, int(T * float(ctx.extra.get("fill", 1.0)))) + 1
    gen = torch.Generator().manual_seed(11)
    return torch.randint(K, hi, (B,), generator=gen, dtype=torch.int32)


def _paged_verify_workload(cfg: Config, ctx: TuningContext) -> KernelWorkload:
    """What the timed call moves under ``cfg``: unpacked heads each read
    their KV head's rows, so the group re-reads them; kv_splits moves no
    byte (the partials stay in shared memory). An int8 context (kv8) reads
    int8 rows with their f32 scales, q and o in q's dtype, and counts
    operations at q's dtype's peak, as ``_paged_workload``."""
    B, Hq, D = ctx.shape("q")
    Hkv, T = ctx.shape("k")[1], ctx.shape("k")[2]
    ps, K = cfg["page_size"], cfg["draft_k"]
    cap = _rup(T, ps)
    lens = _verify_lens(ctx, K)
    kv_tokens = float(torch.clamp(lens, max=cap).sum())
    reads = 1 if cfg["pack_gqa"] else _group(ctx)
    q_dtype = _q_dtype(ctx)
    return KernelWorkload(
        flops=paged_verify_flops(Hq, D, verify_attended(lens, K, cap)),
        hbm_bytes=paged_verify_bytes(
            B, K, Hq, Hkv, D, kv_tokens * reads, _cdiv(T, ps),
            dtype_bytes(ctx.dtype), q_itemsize=dtype_bytes(q_dtype),
            scale_bytes=4 if ctx.dtype == "int8" else 0),
        dtype=q_dtype)


def _paged_verify_heuristic(ctx: TuningContext) -> Config:
    """The reference's depth 4 and packed heads; ``_paged_heuristic``'s
    chunk (64 rows, or a page past 64) and its fewest splits that give
    every SM a block."""
    cfg = _paged_heuristic(ctx)
    pack = _group(ctx) > 1
    return {"draft_k": int(ctx.extra.get("draft_k", 4)),
            "page_size": cfg["page_size"], "block_kv": cfg["block_kv"],
            "pack_gqa": pack,
            "kv_splits": _fill_splits(ctx, pack, cfg["block_kv"])}


def _paged_verify_operands(ctx: TuningContext, cfg: Optional[Config] = None,
                           device="cuda"):
    """Registry operands: the pool as ``_paged_operands``, a K-position
    query block (K from the config, the context or 4) and lengths >= K."""
    cfg = cfg or {}
    ps = int(cfg.get("page_size", ctx.extra.get("page_size", 16)))
    K = int(cfg.get("draft_k", ctx.extra.get("draft_k", 4)))
    return _pool_operands(ctx, ps, _verify_lens(ctx, K), device, K)


def _paged_verify_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    """The decode runner's pool with the config's page size, a K-position
    query block and lengths >= K."""
    ps, K = cfg["page_size"], cfg["draft_k"]
    args, kw = _memo_operands(
        ("paged_verify", ctx.signature(), ps, K),
        lambda: _pool_operands(ctx, ps, _verify_lens(ctx, K), "cuda", K))
    return KernelRunner(pv_kernel.paged_verify, *args, **kw,
                        block_kv=cfg["block_kv"], pack_gqa=cfg["pack_gqa"],
                        kv_splits=cfg["kv_splits"])


PAGED_VERIFY = TunableKernel(
    name="paged_verify",
    space=paged_verify_space(),
    version=2,
    workload_fn=_paged_verify_workload,
    make_runner=_paged_verify_runner,
    heuristic=_paged_verify_heuristic,
)


def paged_verify_context(chip, B: int, Hq: int, Hkv: int, D: int,
                         capacity: int, dtype: str,
                         page_size: Optional[int] = None,
                         draft_k: Optional[int] = None,
                         q_dtype: Optional[str] = None) -> TuningContext:
    """Tuning scenario of a verify over B sequences of ``capacity`` token
    slots. ``page_size`` pins the pool's layout and ``draft_k`` the
    engine's speculation depth, so each depth is its own scenario; omit
    both for deployment tuning, whose winner sizes the pool and
    recommends the depth. ``dtype`` is the pool's: an int8 pool (kv8)
    keys apart from the float pools, with q's dtype in ``extra`` unless it
    is the reference's float32 (as ``paged_decode_context``)."""
    extra = {}
    if page_size is not None:
        extra["page_size"] = int(page_size)
    if draft_k is not None:
        extra["draft_k"] = int(draft_k)
    if dtype == "int8" and q_dtype not in (None, "float32"):
        extra["q_dtype"] = q_dtype
    return TuningContext(chip=chip, shapes={"q": (B, Hq, D),
                                            "k": (B, Hkv, capacity, D)},
                         dtype=dtype, extra=extra)


def paged_verify_fixed_config(K: int, group: int, D: int, page_size: int,
                              itemsize: int) -> Config:
    """What a verify at an off-space depth or page size dispatches,
    untuned: the reference's one page per step with packed heads
    (``src/repro/kernels/ops.py:1056-1060``), one block a row, the block
    halved until it fits in shared memory. ``itemsize`` is the pool's (1
    for int8, whose rows stage their scales too); q stays in registers."""
    pack = group > 1
    block_kv = _fixed_block_kv(
        page_size, lambda bkv: pv_kernel.smem_bytes(D, itemsize, bkv, K,
                                                    group, pack),
        pv_kernel.MAX_SMEM_BYTES)
    return {"block_kv": block_kv, "pack_gqa": pack, "kv_splits": 1}


def paged_verify_config(q, k_pages, block_tables,
                        tuner: Optional[Autotuner] = None) -> Config:
    """The config a verify on these operands dispatches: the fixed config
    for a page size or depth outside the space, else the tuner's for the
    pool's layout and the depth (memoized per shape)."""
    B, K, Hq, D = q.shape
    Hkv, _, ps, _ = k_pages.shape
    if ps not in PAGE_SIZES or K not in pv_kernel.DRAFT_KS:
        return paged_verify_fixed_config(K, Hq // Hkv, D, ps,
                                         k_pages.element_size())
    tuner = tuner or default_tuner()
    max_pages = block_tables.shape[1]
    dt, qt = dtype_name(k_pages.dtype), dtype_name(q.dtype)
    # an int8 pool's scenario also depends on q's dtype (its bytes, its
    # shared memory and its peak); a float pool's dtype is q's
    key = (B, K, Hq, Hkv, D, ps, max_pages, dt, qt, q.device.index)
    return tuner.dispatch_config(
        PAGED_VERIFY, key,
        lambda: paged_verify_context(device_chip(q.device.index), B, Hq, Hkv,
                                     D, max_pages * ps, dt, ps, K, qt))


def paged_verify(q, k_pages, v_pages, block_tables, kv_len, *,
                 k_scales=None, v_scales=None,
                 scale: Optional[float] = None,
                 config: Optional[Config] = None,
                 tuner: Optional[Autotuner] = None):
    """Autotuned speculative verify. q (B, K, Hq, D), K consecutive query
    positions per sequence; k/v_pages (Hkv, P, page_size, D) in q's
    dtype, or int8 with ``k_scales``/``v_scales`` (Hkv, P, page_size) f32
    (the kv8 policy: an "int8" context, so int8 and float pools tune
    apart); block_tables (B, max_pages); kv_len (B,) valid tokens
    *including* the K scattered draft positions. The pool pins
    ``page_size`` and q pins ``draft_k``, so the lookup context carries
    both and the remaining tunables dispatch to the kernel."""
    if config is None and q.is_cuda:
        config = paged_verify_config(q, k_pages, block_tables, tuner)
    cfg = {k: v for k, v in (config or {}).items()
           if k not in ("page_size", "draft_k")}
    return pv_kernel.paged_verify(q, k_pages, v_pages, block_tables, kv_len,
                                  k_scales=k_scales, v_scales=v_scales,
                                  scale=scale, **cfg)


# ===========================================================================
# Dense-cache decode: one token per head against a (B, Hkv, T, D) cache.
# decode_attention (heads packed) and gqa_decode_ragged (per-request
# kv_len, pack_gqa tunable) share one CUDA kernel (csrc/gqa_decode.cu: one
# launch, the splits of a row in one thread-block cluster); the int8
# kernel (gqa_decode_kv8) keeps the template of csrc/gqa_decode.cuh, with
# the splits on a grid axis and a second launch combining them
# ===========================================================================

DENSE_BLOCK_KV = (32, 64, 128, 256)
K_SPLITS = (1, 2, 4, 8, 16, 32)            # gqa_decode_kv8's
FLOAT_WARPS = (1, 2, 4, 8)


def _dense_pack(cfg: Config) -> bool:
    return cfg.get("pack_gqa", True)


def _dense_smem(cfg: Config, ctx: TuningContext) -> int:
    D = ctx.shape("q")[2]
    return gqa_kernel.smem_bytes(
        D, dtype_bytes(ctx.dtype),
        gqa_kernel.clamp_block_kv(cfg["block_kv"], ctx.shape("k")[2]),
        _group(ctx), _dense_pack(cfg), cfg["num_warps"])


def _dense_space(name: str, version: int, with_pack: bool) -> ConfigSpace:
    params = [Param("block_kv", DENSE_BLOCK_KV), Param("k_splits", K_SPLITS)]
    if with_pack:
        params.append(Param("pack_gqa", (True, False)))
    params.append(Param("num_warps", (2, 4, 8)))
    sp = ConfigSpace(name, params, version=version)
    sp.constrain("smem", smem_fits(_dense_smem))
    sp.constrain(
        "splits<=blocks",
        lambda c, x: c["k_splits"] <= max(1, _cdiv(x.shape("k")[2],
                                                   c["block_kv"])))
    # A packed block holds the whole group in registers (up to eight heads);
    # packing a group of one is the unpacked kernel, so the ragged space,
    # where pack_gqa is tunable, keeps one of the two.
    if with_pack:
        sp.constrain("pack_gqa:group",
                     lambda c, x: not c["pack_gqa"]
                     or 1 < _group(x) <= gqa_kernel.MAX_PACKED_GROUP)
    else:
        sp.constrain("group",
                     lambda c, x: _group(x) <= gqa_kernel.MAX_PACKED_GROUP)
    return sp


def _float_dense_smem(cfg: Config, ctx: TuningContext) -> int:
    D = ctx.shape("q")[2]
    return gqa_kernel.float_smem_bytes(
        D, dtype_bytes(ctx.dtype),
        gqa_kernel.clamp_block_kv(cfg["block_kv"], ctx.shape("k")[2]),
        _group(ctx), _dense_pack(cfg), cfg["num_warps"])


def _dense_chunks(cfg: Config, ctx: TuningContext) -> int:
    """Chunks of the (clamped) ``block_kv`` keys in the cache's T."""
    T = ctx.shape("k")[2]
    return _cdiv(T, gqa_kernel.clamp_block_kv(cfg["block_kv"], T))


def _float_dense_space(name: str, version: int,
                      with_pack: bool) -> ConfigSpace:
    """The float kernel's space (csrc/gqa_decode.cu): ``k_splits`` blocks
    of one thread-block cluster a row (at most the portable cluster size,
    which any SM layout of the card holds), ``num_warps`` warps of 32
    keys."""
    params = [Param("block_kv", DENSE_BLOCK_KV),
              Param("k_splits", gqa_kernel.KV_SPLITS)]
    if with_pack:
        params.append(Param("pack_gqa", (True, False)))
    params.append(Param("num_warps", FLOAT_WARPS))
    sp = ConfigSpace(name, params, version=version)
    sp.constrain("smem", smem_fits(_float_dense_smem))
    # No split smaller than one chunk: it would run as a smaller split does.
    sp.constrain("k_splits<=chunks",
                 lambda c, x: c["k_splits"] <= _dense_chunks(c, x))
    # Every warp scores 32 keys of a chunk at a time: a warp past the chunk
    # would idle.
    sp.constrain("warps<=block_kv/32",
                 lambda c, x: c["num_warps"] * gqa_kernel.KEY_TILE
                 <= gqa_kernel.clamp_block_kv(c["block_kv"], x.shape("k")[2]))
    if with_pack:
        sp.constrain("pack_gqa:group",
                     lambda c, x: not c["pack_gqa"]
                     or 1 < _group(x) <= gqa_kernel.MAX_PACKED_GROUP)
    else:
        sp.constrain("group",
                     lambda c, x: _group(x) <= gqa_kernel.MAX_PACKED_GROUP)
    return sp


def _float_decode_heuristic(ctx: TuningContext) -> Config:
    """Packed heads where the group allows, 64 keys a chunk scored by two
    warps, and the fewest splits whose rows x k_splits blocks reach every
    SM (at most one split a chunk)."""
    pack = 1 < _group(ctx) <= gqa_kernel.MAX_PACKED_GROUP
    B, Hq = ctx.shape("q")[:2]
    rows = B * (ctx.shape("k")[1] if pack else Hq)
    block = gqa_kernel.clamp_block_kv(64, ctx.shape("k")[2])
    cfg = {"block_kv": block, "pack_gqa": pack,
           "num_warps": min(2, block // gqa_kernel.KEY_TILE)}
    # f32 rows of 256 stage in 32-key chunks
    while block > gqa_kernel.KEY_TILE and \
            _float_dense_smem(cfg, ctx) > ctx.chip.smem_per_block:
        block //= 2
        cfg.update(block_kv=block, num_warps=1)
    splits = [s for s in gqa_kernel.KV_SPLITS
              if s <= _dense_chunks(cfg, ctx)]
    cfg["k_splits"] = next((s for s in splits
                            if rows * s >= ctx.chip.sm_count), splits[-1])
    return {k: cfg[k] for k in ("block_kv", "k_splits", "pack_gqa",
                                "num_warps")}


def dense_decode_bytes(B: int, Hq: int, Hkv: int, D: int, kv_tokens: float,
                       itemsize: int, *, q_itemsize: Optional[int] = None,
                       scale_bytes: int = 0) -> float:
    """HBM bytes of one call reading each K/V row once: the K and V rows
    of ``kv_tokens`` valid positions over Hkv heads (an int8 row with its
    f32 scale: ``itemsize`` 1, ``scale_bytes`` 4), q in, o out (in
    ``q_itemsize``, by default the cache's), the lengths."""
    q_item = itemsize if q_itemsize is None else q_itemsize
    return (2.0 * kv_tokens * Hkv * (D * itemsize + scale_bytes)
            + 2.0 * B * Hq * D * q_item + 4.0 * B)


def _dense_canonical(cfg: Config, ctx: TuningContext) -> Config:
    """The kernel clamps its KV block to the cache length rounded up to 32
    keys; block_kv values past that launch the same program."""
    c = dict(cfg)
    c["block_kv"] = gqa_kernel.clamp_block_kv(c["block_kv"],
                                              ctx.shape("k")[2])
    return c


def _dense_workload(cfg: Config, ctx: TuningContext,
                    lens: Optional[torch.Tensor],
                    combine: bool = False) -> KernelWorkload:
    """What the timed call moves under ``cfg``: the valid K/V rows (int8
    rows with their f32 scales under kv8; each group head re-reads them
    unpacked), q and o in q's dtype, and, for a kernel that ``combine``s
    its splits in a second launch (gqa_decode_kv8), with k_splits > 1 the
    f32 partials written and read back; the float kernel merges them in
    shared memory. Operations are counted at q's dtype's peak (an int8
    cache is dequantized to f32 first)."""
    B, Hq, D = ctx.shape("q")
    Hkv, T = ctx.shape("k")[1], ctx.shape("k")[2]
    kv_tokens = float(B * T if lens is None
                      else torch.clamp(lens, 0, T).sum())
    pack = _dense_pack(cfg)
    g = gqa_kernel.rows_per_block(_group(ctx), pack)
    reads = 1 if pack else _group(ctx)
    ks = cfg["k_splits"]
    partials = 0.0 if ks == 1 or not combine else \
        2.0 * (B * Hq // g) * ks * g * (D + 1) * 4
    q_dtype = _q_dtype(ctx)
    return KernelWorkload(
        flops=paged_decode_flops(Hq, D, kv_tokens),
        hbm_bytes=dense_decode_bytes(
            B, Hq, Hkv, D, kv_tokens * reads, dtype_bytes(ctx.dtype),
            q_itemsize=dtype_bytes(q_dtype),
            scale_bytes=4 if ctx.dtype == "int8" else 0) + partials,
        dtype=q_dtype)


def _dense_operands(ctx: TuningContext, device, with_lens: bool):
    """q, and k, v as (B, Hkv, T, D) views of caches stored (B, T, Hkv,
    D), the layout the serving path hands the kernel; the ragged kernel
    also gets the seeded lengths."""
    B, Hq, D = ctx.shape("q")
    Hkv, T = ctx.shape("k")[1], ctx.shape("k")[2]
    dtype = getattr(torch, ctx.dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn((B, Hq, D), dtype, gen)
    k = _randn((B, T, Hkv, D), dtype, gen).transpose(1, 2)
    v = _randn((B, T, Hkv, D), dtype, gen).transpose(1, 2)
    kw = {"kv_len": _ragged_lens(ctx).to(device)} if with_lens else {}
    return (q, k, v), kw


def _dense_runner(fn, with_lens: bool):
    def make(cfg: Config, ctx: TuningContext) -> KernelRunner:
        args, kw = _memo_operands(
            ("dense_decode", ctx.signature(), with_lens),
            lambda: _dense_operands(ctx, "cuda", with_lens))
        return KernelRunner(fn, *args, **kw, **cfg)
    return make


def _refuse_int8(k: torch.Tensor) -> None:
    if k.dtype == torch.int8:
        raise NotImplementedError(
            "an int8 cache (the kv8 policy) takes its scales through "
            "ragged_decode_kv8 (gqa_decode_kv8), not the float entry points")


DECODE_ATTENTION = TunableKernel(
    name="decode_attention",
    space=_float_dense_space("decode_attention", 3, with_pack=False),
    version=3,
    workload_fn=lambda cfg, ctx: _dense_workload(cfg, ctx, None),
    make_runner=_dense_runner(da_kernel.decode_attention, with_lens=False),
    heuristic=lambda ctx: {k: v for k, v in
                           _float_decode_heuristic(ctx).items()
                           if k != "pack_gqa"},
    canonicalize=_dense_canonical,
)


def decode_attention_context(chip, B: int, Hq: int, Hkv: int, D: int,
                             T: int, dtype: str) -> TuningContext:
    return TuningContext(chip=chip, shapes={"q": (B, Hq, D),
                                            "k": (B, Hkv, T, D)},
                         dtype=dtype)


def decode(q, k, v, *, kv_len=None, config: Optional[Config] = None,
           tuner: Optional[Autotuner] = None):
    """Autotuned decode attention. q (B, Hq, D); k, v (B, Hkv, T, D)."""
    _refuse_int8(k)
    if config is None and q.is_cuda:
        tuner = tuner or default_tuner()
        B, Hq, D = q.shape
        Hkv, T = k.shape[1], k.shape[2]
        dt = dtype_name(k.dtype)
        config = tuner.dispatch_config(
            DECODE_ATTENTION, (B, Hq, Hkv, T, D, dt, q.device.index),
            lambda: decode_attention_context(device_chip(q.device.index), B,
                                             Hq, Hkv, D, T, dt))
    return da_kernel.decode_attention(q, k, v, kv_len=kv_len,
                                      **(config or {}))


def _gqa_decode_heuristic(ctx: TuningContext) -> Config:
    """The reference's one split with packed heads, at a block the card
    stages comfortably: the int8 kernel's base (``_kv8_heuristic``)."""
    return {"block_kv": 64, "k_splits": 1,
            "pack_gqa": 1 < _group(ctx) <= gqa_kernel.MAX_PACKED_GROUP,
            "num_warps": 4}


GQA_DECODE_RAGGED = TunableKernel(
    name="gqa_decode_ragged",
    space=_float_dense_space("gqa_decode_ragged", 2, with_pack=True),
    version=2,
    workload_fn=lambda cfg, ctx: _dense_workload(cfg, ctx, _ragged_lens(ctx)),
    make_runner=_dense_runner(gqa_kernel.gqa_decode, with_lens=True),
    heuristic=_float_decode_heuristic,
    canonicalize=_dense_canonical,
)


def gqa_decode_context(chip, B: int, Hq: int, Hkv: int, D: int, T: int,
                       dtype: str,
                       fill: Optional[float] = None) -> TuningContext:
    """Tuning scenario of a ragged decode over B requests of T cache slots;
    ``fill`` (the mean valid share the runner's lengths draw from) as the
    reference's bench cases give it, omitted at serving."""
    extra = {} if fill is None else {"fill": float(fill)}
    return TuningContext(chip=chip, shapes={"q": (B, Hq, D),
                                            "k": (B, Hkv, T, D)},
                         dtype=dtype, extra=extra)


def ragged_decode(q, k, v, *, kv_len=None, config: Optional[Config] = None,
                  tuner: Optional[Autotuner] = None):
    """Autotuned ragged GQA decode. q (B, Hq, D); k, v (B, Hkv, T, D), any
    strides with D contiguous; kv_len (B,) per-request valid lengths."""
    _refuse_int8(k)
    if config is None and q.is_cuda:
        tuner = tuner or default_tuner()
        B, Hq, D = q.shape
        Hkv, T = k.shape[1], k.shape[2]
        dt = dtype_name(k.dtype)
        config = tuner.dispatch_config(
            GQA_DECODE_RAGGED, (B, Hq, Hkv, T, D, dt, q.device.index),
            lambda: gqa_decode_context(device_chip(q.device.index), B, Hq,
                                       Hkv, D, T, dt))
    return gqa_kernel.gqa_decode(q, k, v, kv_len=kv_len, **(config or {}))


# ===========================================================================
# Int8-KV ragged decode (kv8): the dense decode over an int8 cache with its
# per-token f32 scales, dequantized inside the kernel
# ===========================================================================

def _kv8_heuristic(ctx: TuningContext) -> Config:
    """``_gqa_decode_heuristic`` at 128 int8 rows a block (72 KB of
    staging at D 128, where 64 bf16 rows took 68 KB)."""
    return dict(_gqa_decode_heuristic(ctx), block_kv=128)


def _kv8_operands(ctx: TuningContext, device):
    """q in its dtype, and a (B, T, Hkv, D) cache quantized through the
    kv8 wire format (``quant.quantize_kv``, as serving writes it) handed
    over as (B, Hkv, T, D) and (B, Hkv, T) views, with the seeded ragged
    lengths: args (q, k, v, k_scale, v_scale), kwargs kv_len."""
    B, Hq, D = ctx.shape("q")
    Hkv, T = ctx.shape("k")[1], ctx.shape("k")[2]
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn((B, Hq, D), getattr(torch, _q_dtype(ctx)), gen)
    kq, ks, vq, vs = quantize_kv(_randn((B, T, Hkv, D), torch.float32, gen),
                                 _randn((B, T, Hkv, D), torch.float32, gen))
    args = (q, kq.transpose(1, 2), vq.transpose(1, 2), ks.transpose(1, 2),
            vs.transpose(1, 2))
    return args, {"kv_len": _ragged_lens(ctx).to(device)}


def _kv8_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    args, kw = _memo_operands(("gqa_decode_kv8", ctx.signature()),
                              lambda: _kv8_operands(ctx, "cuda"))
    return KernelRunner(kv8_kernel.gqa_decode_kv8, *args, **kw, **cfg)


GQA_DECODE_KV8 = TunableKernel(
    name="gqa_decode_kv8",
    space=_dense_space("gqa_decode_kv8", 1, with_pack=True),
    version=1,
    workload_fn=lambda cfg, ctx: _dense_workload(cfg, ctx, _ragged_lens(ctx),
                                                 combine=True),
    make_runner=_kv8_runner,
    heuristic=_kv8_heuristic,
    canonicalize=_dense_canonical,
)


def gqa_decode_kv8_context(chip, B: int, Hq: int, Hkv: int, D: int, T: int,
                           q_dtype: str = "float32") -> TuningContext:
    """Tuning scenario of an int8-cache ragged decode over B requests of T
    cache slots: dtype "int8" (the cache's, as the reference keys it), so
    kv8 and float caches never share a tuned entry; q's dtype rides in
    ``extra`` unless it is the reference's float32."""
    extra = {} if q_dtype == "float32" else {"q_dtype": q_dtype}
    return TuningContext(chip=chip, shapes={"q": (B, Hq, D),
                                            "k": (B, Hkv, T, D)},
                         dtype="int8", extra=extra)


def ragged_decode_kv8(q, k, v, k_scale, v_scale, *, kv_len=None,
                      config: Optional[Config] = None,
                      tuner: Optional[Autotuner] = None):
    """Autotuned int8-KV ragged decode. q (B, Hq, D) float; k, v
    (B, Hkv, T, D) int8; k_scale, v_scale (B, Hkv, T) f32 per-token
    scales (any strides, D contiguous); kv_len (B,) valid lengths."""
    if config is None and q.is_cuda:
        tuner = tuner or default_tuner()
        B, Hq, D = q.shape
        Hkv, T = k.shape[1], k.shape[2]
        qt = dtype_name(q.dtype)
        config = tuner.dispatch_config(
            GQA_DECODE_KV8, (B, Hq, Hkv, T, D, "int8", qt, q.device.index),
            lambda: gqa_decode_kv8_context(device_chip(q.device.index), B,
                                           Hq, Hkv, D, T, qt))
    return kv8_kernel.gqa_decode_kv8(q, k, v, k_scale, v_scale,
                                     kv_len=kv_len, **(config or {}))


# ===========================================================================
# Blocked matmul
# ===========================================================================

def _mm_path(ctx: TuningContext) -> str:
    """The kernel the context's operands take (``matmul.path``: fma, wgmma
    or mma_sync), contiguous operands assumed."""
    K, N = ctx.shape("y")
    return mm_kernel.path(getattr(torch, ctx.dtype), K, N)


def _mm_smem(cfg: Config, ctx: TuningContext) -> int:
    if _mm_path(ctx) == "wgmma":
        return mm_kernel.wgmma_smem_bytes(cfg["block_m"], cfg["block_n"],
                                          cfg["num_stages"])
    return mm_kernel.smem_bytes(dtype_bytes(ctx.dtype), cfg["block_m"],
                                cfg["block_n"], cfg["block_k"],
                                cfg["num_stages"])


def _mm_tile_fits(cfg: Config, ctx: TuningContext) -> bool:
    """wgmma: one or two consumer warpgroups of 64 rows (``num_warps``
    block_m / 16), K slices of 64; the other kernels: a thread's f32
    accumulators within 128 registers."""
    if _mm_path(ctx) == "wgmma":
        return mm_kernel.wgmma_tile_ok(cfg["block_m"], cfg["block_k"],
                                       cfg["num_warps"])
    return mm_kernel.regs_fit(cfg["block_m"], cfg["block_n"],
                              cfg["num_warps"])


def matmul_space() -> ConfigSpace:
    """The reference's tunables (``block_m/n/k``) at Hopper sizes, with
    ``num_warps`` and the ring's ``num_stages`` beside them, under one
    block's shared memory (in the context's dtype) and registers. Version
    2: where the operands take the wgmma kernel (bf16, rows of 16-byte
    multiples) a tile is one or two warpgroups of 64 rows and K slices of
    64, so ``num_warps`` and ``block_k`` follow ``block_m``."""
    sp = ConfigSpace(
        "matmul",
        [
            Param("block_m", mm_kernel.BLOCK_M),
            Param("block_n", mm_kernel.BLOCK_N),
            Param("block_k", mm_kernel.BLOCK_K),
            Param("num_warps", mm_kernel.NUM_WARPS),
            Param("num_stages", mm_kernel.NUM_STAGES),
        ],
        version=2,
    )
    sp.constrain("smem", smem_fits(_mm_smem))
    sp.constrain("registers", _mm_tile_fits)
    return sp


def matmul_bytes(M: int, K: int, N: int, itemsize: int) -> float:
    """x and y read once, the output written once, in x's dtype."""
    return float(M * K + K * N + M * N) * itemsize


def _mm_workload(cfg: Config, ctx: TuningContext) -> KernelWorkload:
    """2·M·K·N operations at the dtype's peak, over ``matmul_bytes``."""
    M, K = ctx.shape("x")
    N = ctx.shape("y")[1]
    return KernelWorkload(flops=2.0 * M * K * N,
                          hbm_bytes=matmul_bytes(M, K, N,
                                                 dtype_bytes(ctx.dtype)),
                          dtype=ctx.dtype)


def _mm_canonical(cfg: Config, ctx: TuningContext) -> Config:
    """The tile the kernel launches (``matmul.clamp_blocks`` on the
    context's path); on the wgmma path ``num_warps`` follows the clamped
    block_m, as the kernel reads it."""
    M, K = ctx.shape("x")
    N = ctx.shape("y")[1]
    route = _mm_path(ctx)
    c = dict(cfg)
    c["block_m"], c["block_n"], c["block_k"] = mm_kernel.clamp_blocks(
        cfg["block_m"], cfg["block_n"], cfg["block_k"], M, N, K, route)
    if route == "wgmma":
        c["num_warps"] = c["block_m"] // 16
    return c


def _mm_heuristic(ctx: TuningContext) -> Config:
    """wgmma: 128 x 256 tiles over two warpgroups, three stages (what a
    Hopper GEMM commonly hard-codes). Otherwise the reference's fixed 256^3
    tile as a port would hard-code it: 128 x 128 of 32-deep slices, four
    warps, three stages."""
    if _mm_path(ctx) == "wgmma":
        return {"block_m": 128, "block_n": 256, "block_k": 64,
                "num_warps": 8, "num_stages": 3}
    return {"block_m": 128, "block_n": 128, "block_k": 32, "num_warps": 4,
            "num_stages": 3}


def _mm_operands(ctx: TuningContext, cfg: Optional[Config] = None,
                 device="cuda"):
    """x (M, K) and y (K, N), standard normals in the context's dtype, as
    the reference draws them. Returns ((x, y), {})."""
    dtype = getattr(torch, ctx.dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    return (_randn(ctx.shape("x"), dtype, gen),
            _randn(ctx.shape("y"), dtype, gen)), {}


def _mm_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    x, y = _memo_operands(("matmul", ctx.signature()),
                          lambda: _mm_operands(ctx)[0])
    return KernelRunner(mm_kernel.matmul, x, y, **cfg)


MATMUL = TunableKernel(
    name="matmul",
    space=matmul_space(),
    version=2,
    workload_fn=_mm_workload,
    make_runner=_mm_runner,
    heuristic=_mm_heuristic,
    canonicalize=_mm_canonical,
)


def matmul_context(chip, M: int, K: int, N: int,
                   dtype: str) -> TuningContext:
    """Tuning scenario of x (M, K) @ y (K, N) in ``dtype``, the
    reference's shapes."""
    return TuningContext(chip=chip, shapes={"x": (M, K), "y": (K, N)},
                         dtype=dtype)


def matmul(x, y, *, config: Optional[Config] = None,
           tuner: Optional[Autotuner] = None):
    """Autotuned blocked matmul: x (M, K) @ y (K, N) -> (M, N) in x's
    dtype, f32 accumulation."""
    if config is None and x.is_cuda:
        tuner = tuner or default_tuner()
        M, K = x.shape
        N = y.shape[1]
        dt = dtype_name(x.dtype)
        config = tuner.dispatch_config(
            MATMUL, (M, K, N, dt, x.device.index),
            lambda: matmul_context(device_chip(x.device.index), M, K, N, dt))
    return mm_kernel.matmul(x, y, **(config or {}))


# ===========================================================================
# w8a8 GEMM: int8 x int8 -> int32 on the tensor cores, fused dequant
# ===========================================================================

def _w8a8_path(ctx: TuningContext) -> str:
    """The kernel the context's operands take (``matmul_w8a8.path``: wgmma
    or mma_sync), aligned operands assumed."""
    return mm8_kernel.path(ctx.shape("x")[1])


def _w8a8_smem(cfg: Config, ctx: TuningContext) -> int:
    if _w8a8_path(ctx) == "wgmma":
        return mm8_kernel.wgmma_smem_bytes(cfg["block_m"], cfg["block_n"],
                                           cfg["num_stages"])
    return mm8_kernel.smem_bytes(cfg["block_m"], cfg["block_n"],
                                 cfg["block_k"])


def _w8a8_regs(cfg: Config, ctx: TuningContext) -> bool:
    if _w8a8_path(ctx) == "wgmma":
        return mm8_kernel.wgmma_regs_fit(cfg["block_m"], cfg["block_n"],
                                         cfg["dequant"])
    return mm8_kernel.regs_fit(cfg["block_m"], cfg["block_n"],
                               cfg["num_warps"], cfg["dequant"])


def _w8a8_tile(cfg: Config, ctx: TuningContext) -> bool:
    """The tiles each kernel takes at the context's rows. wgmma: the
    operands swap roles (block_m 8, 16 or 32: the smallest that covers
    M) exactly where M <= 32, and only there K splits; ``num_warps`` is
    the consumer warpgroups', block_k one TMA row (128). mma.sync: block_m
    from 16, one split (its two stages are the "stages" constraint)."""
    M, K = ctx.shape("x")
    bm, bk = cfg["block_m"], cfg["block_k"]
    if _w8a8_path(ctx) == "mma_sync":
        return bm in mm8_kernel.MMA_BLOCK_M and cfg["split_k"] == 1
    if M <= 32:
        fits = bm == min(v for v in mm8_kernel.SWAP_BLOCK_M if v >= M)
    else:
        fits = not mm8_kernel.swapped(bm) and cfg["split_k"] == 1
    return fits and mm8_kernel.wgmma_tile_ok(bm, cfg["block_n"], bk,
                                             cfg["num_warps"])


def _w8a8_split(cfg: Config, ctx: TuningContext) -> bool:
    """No more splits than K has slices of block_k."""
    return cfg["split_k"] <= -(-ctx.shape("x")[1] // cfg["block_k"])


def _w8a8_stages(cfg: Config, ctx: TuningContext) -> bool:
    """The mma.sync kernel double-buffers; the wgmma ring takes 2-8."""
    return _w8a8_path(ctx) == "wgmma" or cfg["num_stages"] == 2


def matmul_w8a8_space() -> ConfigSpace:
    """The reference's tunables (``block_m/n/k``, ``dequant``,
    ``scale_gran``) cut to what the Hopper kernels tile and one block's
    shared memory and registers take, with ``num_warps``, ``num_stages``
    and ``split_k`` beside them. Version 2: where TMA reads the operands
    (K a multiple of 16) the wgmma kernel's tiles, split-K at decode;
    elsewhere the mma.sync kernel's (16-row, 8-column, 32-deep)."""
    sp = ConfigSpace(
        "matmul_w8a8",
        [
            Param("block_m", mm8_kernel.BLOCK_M),
            Param("block_n", mm8_kernel.BLOCK_N),
            Param("block_k", mm8_kernel.BLOCK_K),
            Param("num_warps", mm8_kernel.NUM_WARPS),
            Param("num_stages", mm8_kernel.NUM_STAGES),
            Param("split_k", mm8_kernel.SPLIT_K),
            Param("dequant", ("epilogue", "inline")),
            Param("scale_gran", ("per_channel", "per_tensor")),
        ],
        version=2,
    )
    sp.constrain("smem", smem_fits(_w8a8_smem))
    sp.constrain("registers", _w8a8_regs)
    sp.constrain("tile", _w8a8_tile)
    sp.constrain("split_k<=slices", _w8a8_split)
    sp.constrain("stages", _w8a8_stages)
    # Runtime operands arrive calibrated at a fixed granularity (their
    # scale shapes), pinning the tunable, as a deployed pool pins
    # paged_decode's page_size; offline sweeps (no extra) leave it free.
    sp.constrain("scale_gran==operands",
                 lambda c, x: ("scale_gran" not in x.extra
                               or c["scale_gran"] == x.extra["scale_gran"]))
    return sp


def matmul_w8a8_bytes(M: int, K: int, N: int, scale_gran: str) -> float:
    """HBM bytes of one call: x and w read once (int8), the f32 output
    written once, and the scales (M + N f32 per channel, two per
    tensor)."""
    scales = 4.0 * (M + N) if scale_gran == "per_channel" else 8.0
    return float(M * K + K * N + 4 * M * N) + scales


def _w8a8_workload(cfg: Config, ctx: TuningContext) -> KernelWorkload:
    """2·M·K·N operations at the int8 tensor-core rate, over the bytes
    each operand needs once (``matmul_w8a8_bytes``)."""
    M, K = ctx.shape("x")
    N = ctx.shape("y")[1]
    return KernelWorkload(flops=2.0 * M * K * N,
                          hbm_bytes=matmul_w8a8_bytes(M, K, N,
                                                      cfg["scale_gran"]),
                          dtype="int8")


def _w8a8_heuristic(ctx: TuningContext) -> Config:
    """What a port of the reference's default would hard-code, epilogue
    dequant at the operands' granularity. wgmma: at decode (M <= 32) 128 w
    rows a block, x's rows padded to 8, 16 or 32, split four ways where K
    has the slices; at prefill 128 x 128 tiles; four stages of 128 bytes
    of K. mma.sync: a mid-size 64 x 128 tile, 64 deep, four warps."""
    M, K = ctx.shape("x")
    cfg = {"block_m": 64, "block_n": 128, "block_k": 64, "num_warps": 4,
           "num_stages": 2, "split_k": 1, "dequant": "epilogue",
           "scale_gran": ctx.extra.get("scale_gran", "per_channel")}
    if _w8a8_path(ctx) == "mma_sync":
        return cfg
    if M <= 32:
        cfg.update(block_m=min(v for v in mm8_kernel.SWAP_BLOCK_M if v >= M),
                   split_k=4 if K >= 4 * 128 else 1)
    else:
        cfg.update(block_m=128)
    return dict(cfg, block_k=128, num_warps=8, num_stages=4)


def _w8a8_canonical(cfg: Config, ctx: TuningContext) -> Config:
    """The tile the kernel launches (``matmul_w8a8.clamp_blocks`` on the
    context's path); on the wgmma path ``split_k`` as the splits that run
    (``matmul_w8a8.effective_splits``: down where K is too short to
    split), and on the mma.sync path none of the wgmma kernel's knobs.
    dequant stays (int32 or f32 accumulators are distinct programs)."""
    M, K = ctx.shape("x")
    N = ctx.shape("y")[1]
    route = _w8a8_path(ctx)
    c = dict(cfg)
    c["block_m"], c["block_n"], c["block_k"] = mm8_kernel.clamp_blocks(
        cfg["block_m"], cfg["block_n"], cfg["block_k"], M, N, K, route)
    if route == "wgmma":
        c["split_k"] = mm8_kernel.effective_splits(K, cfg["split_k"])
    else:
        c["num_stages"], c["split_k"] = 2, 1
    return c


def _w8a8_operands(ctx: TuningContext, cfg: Optional[Config] = None,
                   device="cuda"):
    """Quantized GEMM operands at the granularity the config (or the
    context's pin, or per channel) asks for: x (M, K) and w (K, N) drawn
    in f32 and quantized through ``quant.calibrate`` (per row and per
    column, or per tensor), w stored K-major as ``QTensor`` stores it.
    Returns ((x, w, x_scale, w_scale), {})."""
    gran = ((cfg or {}).get("scale_gran")
            or ctx.extra.get("scale_gran", "per_channel"))
    gen = torch.Generator(device=device).manual_seed(0)
    x = _randn(ctx.shape("x"), torch.float32, gen)
    w = _randn(ctx.shape("y"), torch.float32, gen)
    per_tensor = gran == "per_tensor"
    xs = absmax_scale(x, axis=None if per_tensor else -1)
    ws = absmax_scale(w, axis=None if per_tensor else 0)
    return (quantize(x, xs), k_major(quantize(w, ws)), xs, ws), {}


def _w8a8_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    args, _ = _memo_operands(("matmul_w8a8", ctx.signature(),
                              cfg["scale_gran"]),
                             lambda: _w8a8_operands(ctx, cfg))
    return KernelRunner(mm8_kernel.matmul_w8a8, *args, **cfg)


MATMUL_W8A8 = TunableKernel(
    name="matmul_w8a8",
    space=matmul_w8a8_space(),
    version=2,
    workload_fn=_w8a8_workload,
    make_runner=_w8a8_runner,
    heuristic=_w8a8_heuristic,
    canonicalize=_w8a8_canonical,
)


def matmul_w8a8_context(chip, M: int, K: int, N: int,
                        scale_gran: str = "per_channel") -> TuningContext:
    """Tuning scenario of x (M, K) @ w (K, N) at dtype int8, the
    operands' scale granularity pinned (the reference's context)."""
    return TuningContext(chip=chip, shapes={"x": (M, K), "y": (K, N)},
                         dtype="int8", extra={"scale_gran": scale_gran})


def matmul_w8a8(x, w, x_scale, w_scale, *, config: Optional[Config] = None,
                tuner: Optional[Autotuner] = None):
    """Autotuned w8a8 GEMM. x (M, K) int8; w (K, N) int8 (K-major on the
    card); x_scale (M, 1) or one value; w_scale (1, N) or one value.
    Returns (M, N) float32 with the scales fused into the kernel. The
    granularity is the weight scale's size, as the reference decides it
    (a per-token activation scale of one row is one value too)."""
    gran = "per_tensor" if w_scale.numel() == 1 else "per_channel"
    if config is None and x.is_cuda:
        tuner = tuner or default_tuner()
        M, K = x.shape
        N = w.shape[1]
        config = tuner.dispatch_config(
            MATMUL_W8A8, (M, K, N, gran, x.device.index),
            lambda: matmul_w8a8_context(device_chip(x.device.index), M, K,
                                        N, gran))
    cfg = dict(config or {})
    cfg.setdefault("scale_gran", gran)
    return mm8_kernel.matmul_w8a8(x, w, x_scale, w_scale, **cfg)


# ===========================================================================
# Flash attention (prefill forward): causal and/or windowed GQA over
# (B, H, S, D) operands, o and the log-sum-exp
# ===========================================================================

def _flash_smem(cfg: Config, ctx: TuningContext) -> int:
    return fa_kernel.smem_bytes(ctx.shape("q")[3], dtype_bytes(ctx.dtype),
                                cfg["block_q"], cfg["block_kv"],
                                cfg["num_stages"])


def _stages_fit(cfg: Config, ctx: TuningContext) -> bool:
    """bf16 rings take 2 to 4 stages; the f32 kernels double-buffer."""
    return dtype_bytes(ctx.dtype) == 2 or cfg["num_stages"] == 2


def flash_attention_space() -> ConfigSpace:
    """The reference's tunables (``block_q``, ``block_kv``) at the sizes a
    Hopper block takes, with ``num_warps`` and ``num_stages`` beside them
    and ``smem_fits`` in place of ``vmem_fits``. bf16 (wgmma): a
    warpgroup of 4 warps per 64 rows (``block_q`` 64 or 128, ``num_warps``
    block_q / 16), ``block_kv`` 64 or 128, a ring of 2-4 K/V stages. f32
    (IEEE FMAs): each warp owns 16 or 32 of the block's rows, two stages.
    The TPU's ``pad_head_dim`` is a lane-padding rule that does not carry
    over: the kernels mask D themselves."""
    sp = ConfigSpace(
        "flash_attention",
        [
            Param("block_q", fa_kernel.BLOCK_Q),
            Param("block_kv", fa_kernel.BLOCK_KV),
            Param("num_warps", fa_kernel.NUM_WARPS),
            Param("num_stages", fa_kernel.NUM_STAGES),
        ],
        version=2,
    )
    sp.constrain("smem", smem_fits(_flash_smem))
    sp.constrain("registers",
                 lambda c, x: fa_kernel.regs_fit(x.shape("q")[3],
                                                 c["block_q"], c["block_kv"],
                                                 c["num_warps"],
                                                 dtype_bytes(x.dtype)))
    sp.constrain("stages", _stages_fit)
    # Tiles past the sequences (rounded up to the smallest tile the dtype
    # takes) only add masked rows and keys, as the reference's block<=seq
    # constraints say.
    sp.constrain("block_q<=seq_q",
                 lambda c, x: c["block_q"] <= max(
                     64 if dtype_bytes(x.dtype) == 2 else 16,
                     _rup(x.shape("q")[2], 16)))
    sp.constrain("block_kv<=seq_kv",
                 lambda c, x: c["block_kv"] <= max(
                     64 if dtype_bytes(x.dtype) == 2 else 32,
                     _rup(x.shape("k")[2], 32)))
    return sp


def attention_pairs(Sq: int, Skv: int, causal: bool,
                    window: Optional[int] = None, q_offset: int = 0) -> int:
    """The (query, key) pairs the mask admits, counted exactly: row i (at
    position p = i + q_offset) sees keys max(0, p - window + 1) through
    min(p, Skv - 1) (Skv - 1 when not causal)."""
    pos = torch.arange(Sq, dtype=torch.int64) + q_offset
    hi = torch.clamp(pos, max=Skv - 1) if causal else \
        torch.full_like(pos, Skv - 1)
    lo = torch.clamp(pos - window + 1, min=0) if window else \
        torch.zeros_like(pos)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def flash_attention_bytes(B: int, Hq: int, Hkv: int, Sq: int, Skv: int,
                          D: int, itemsize: int) -> float:
    """HBM bytes of one call: q read and o written (B·Hq·Sq·D each), k and
    v read once (B·Hkv·Skv·D each), in ``itemsize``, and the f32 lse
    written."""
    return (2.0 * B * Hq * Sq * D * itemsize
            + 2.0 * B * Hkv * Skv * D * itemsize + 4.0 * B * Hq * Sq)


def flash_attention_flops(B: int, Hq: int, D: int, pairs: int) -> float:
    """q·k and p·v: 4 operations per admitted (query, key) pair, head and
    dim."""
    return 4.0 * B * Hq * D * pairs


def _flash_mask(ctx: TuningContext) -> Tuple[bool, Optional[int]]:
    return bool(ctx.extra.get("causal", True)), ctx.extra.get("window") or None


def _flash_workload(cfg: Config, ctx: TuningContext) -> KernelWorkload:
    """The bytes each operand needs once and the operations of the pairs
    the context's mask admits (``q_offset`` 0, as the runner calls it)."""
    B, Hq, Sq, D = ctx.shape("q")
    Hkv, Skv = ctx.shape("k")[1], ctx.shape("k")[2]
    causal, window = _flash_mask(ctx)
    return KernelWorkload(
        flops=flash_attention_flops(
            B, Hq, D, attention_pairs(Sq, Skv, causal, window)),
        hbm_bytes=flash_attention_bytes(B, Hq, Hkv, Sq, Skv, D,
                                        dtype_bytes(ctx.dtype)),
        dtype=ctx.dtype)


def _flash_heuristic(ctx: TuningContext) -> Config:
    """bf16: 128 rows over two warpgroups and 128 keys a tile in a
    two-stage ring (the fastest on the card at the prefill, the training
    step and ``train4k``), where D's accumulators leave room and the
    sequences are that long; else 64 and 64. f32: what a port of
    the flash_attn-v2 default tile would hard-code, 64 query rows over four
    warps, 64 keys a tile."""
    if dtype_bytes(ctx.dtype) == 2:
        for bq, bkv in ((128, 128), (128, 64), (64, 128)):
            cfg = {"block_q": bq, "block_kv": bkv, "num_warps": bq // 16,
                   "num_stages": 2}
            if FLASH_ATTENTION.space.is_valid(cfg, ctx):
                return cfg
    return {"block_q": 64, "block_kv": 64, "num_warps": 4, "num_stages": 2}


def _attention_operands(ctx: TuningContext, cfg: Optional[Config] = None,
                        device="cuda"):
    """q, k, v as (B, H, S, D) views of (B, S, H, D) activations, the
    layout the prefill hands the kernel, with the context's mask:
    ((q, k, v), {"causal", "window"})."""
    B, Hq, Sq, D = ctx.shape("q")
    Hkv, Skv = ctx.shape("k")[1], ctx.shape("k")[2]
    dtype = getattr(torch, ctx.dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn((B, Sq, Hq, D), dtype, gen).transpose(1, 2)
    k = _randn((B, Skv, Hkv, D), dtype, gen).transpose(1, 2)
    v = _randn((B, Skv, Hkv, D), dtype, gen).transpose(1, 2)
    causal, window = _flash_mask(ctx)
    return (q, k, v), {"causal": causal, "window": window}


def _flash_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    args, kw = _memo_operands(("flash_attention", ctx.signature()),
                              lambda: _attention_operands(ctx))
    return KernelRunner(fa_kernel.flash_attention, *args, **kw, **cfg)


FLASH_ATTENTION = TunableKernel(
    name="flash_attention",
    space=flash_attention_space(),
    version=2,
    workload_fn=_flash_workload,
    make_runner=_flash_runner,
    heuristic=_flash_heuristic,
)


def attention_context(chip, B: int, Hq: int, Hkv: int, Sq: int, Skv: int,
                      D: int, dtype: str, causal: bool = True,
                      window: Optional[int] = None) -> TuningContext:
    """Tuning scenario of an attention over q (B, Hq, Sq, D) and k, v
    (B, Hkv, Skv, D), the reference's shapes and ``extra`` ({"causal",
    "window": window or 0})."""
    return TuningContext(chip=chip, shapes={"q": (B, Hq, Sq, D),
                                            "k": (B, Hkv, Skv, D)},
                         dtype=dtype, extra={"causal": bool(causal),
                                             "window": window or 0})


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, config: Optional[Config] = None,
              tuner: Optional[Autotuner] = None, return_lse: bool = False):
    """Autotuned flash attention. q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D),
    any strides with D contiguous. Returns o (and lse with
    ``return_lse``)."""
    if config is None and q.is_cuda:
        tuner = tuner or default_tuner()
        B, Hq, Sq, D = q.shape
        Hkv, Skv = k.shape[1], k.shape[2]
        dt = dtype_name(q.dtype)
        config = tuner.dispatch_config(
            FLASH_ATTENTION, (B, Hq, Hkv, Sq, Skv, D, dt, bool(causal),
                              window or 0, q.device.index),
            lambda: attention_context(device_chip(q.device.index), B, Hq,
                                      Hkv, Sq, Skv, D, dt, causal, window))
    return fa_kernel.flash_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset,
                                     return_lse=return_lse, **(config or {}))


# ===========================================================================
# Flash attention backward (training): dq, dk, dv recomputed from the lse
# ===========================================================================

def _flash_bwd_smem(cfg: Config, ctx: TuningContext) -> int:
    return fab_kernel.smem_bytes(ctx.shape("q")[3], dtype_bytes(ctx.dtype),
                                 cfg["block_q"], cfg["block_kv"],
                                 cfg["num_stages"])


def flash_attention_bwd_space() -> ConfigSpace:
    """The reference's tunables (``block_q``, ``block_kv``) at the sizes a
    Hopper block takes, with ``num_warps`` and ``num_stages`` beside them,
    ``smem_fits`` in place of ``vmem_fits`` and the register fit of both
    kernels. bf16 (wgmma): ``block_q`` and ``block_kv`` 64 or 128 (a
    warpgroup of 4 warps per 64 keys in the dkv kernel and per 64
    rows in the dq kernel), a ring of 2-4 stages. f32 (IEEE FMAs): a warp
    owns 16 or 32 keys in the dkv kernel and 16 or 32 query rows in the dq
    kernel, two stages. Kept apart from the forward's space, as the
    reference keeps it: the dkv kernel inverts the forward's reuse."""
    sp = ConfigSpace(
        "flash_attention_bwd",
        [
            Param("block_q", fab_kernel.BLOCK_Q),
            Param("block_kv", fab_kernel.BLOCK_KV),
            Param("num_warps", fab_kernel.NUM_WARPS),
            Param("num_stages", fab_kernel.NUM_STAGES),
        ],
        version=2,
    )
    sp.constrain("smem", smem_fits(_flash_bwd_smem))
    sp.constrain("registers",
                 lambda c, x: fab_kernel.regs_fit(x.shape("q")[3],
                                                  c["block_q"], c["block_kv"],
                                                  c["num_warps"],
                                                  dtype_bytes(x.dtype)))
    sp.constrain("stages", _stages_fit)
    sp.constrain("block_q<=seq_q",
                 lambda c, x: c["block_q"] <= max(
                     64 if dtype_bytes(x.dtype) == 2 else 16,
                     _rup(x.shape("q")[2], 16)))
    sp.constrain("block_kv<=seq_kv",
                 lambda c, x: c["block_kv"] <= max(
                     64 if dtype_bytes(x.dtype) == 2 else 16,
                     _rup(x.shape("k")[2], 16)))
    return sp


def flash_attention_bwd_bytes(B: int, Hq: int, Hkv: int, Sq: int, Skv: int,
                              D: int, itemsize: int) -> float:
    """HBM bytes of one call: q and do read and dq written (B·Hq·Sq·D
    each), k and v read and dk and dv written (B·Hkv·Skv·D each), in
    ``itemsize``, and the f32 lse and delta read."""
    return (3.0 * B * Hq * Sq * D * itemsize
            + 4.0 * B * Hkv * Skv * D * itemsize + 8.0 * B * Hq * Sq)


def flash_attention_bwd_flops(B: int, Hq: int, D: int, pairs: int) -> float:
    """The least work: five products (s, dp, dv, dk, dq) of 2 operations
    per admitted (query, key) pair, head and dim."""
    return 10.0 * B * Hq * D * pairs


def _flash_bwd_workload(cfg: Config, ctx: TuningContext) -> KernelWorkload:
    B, Hq, Sq, D = ctx.shape("q")
    Hkv, Skv = ctx.shape("k")[1], ctx.shape("k")[2]
    causal, window = _flash_mask(ctx)
    return KernelWorkload(
        flops=flash_attention_bwd_flops(
            B, Hq, D, attention_pairs(Sq, Skv, causal, window)),
        hbm_bytes=flash_attention_bwd_bytes(B, Hq, Hkv, Sq, Skv, D,
                                            dtype_bytes(ctx.dtype)),
        dtype=ctx.dtype)


def _flash_bwd_heuristic(ctx: TuningContext) -> Config:
    """bf16: 64 query rows and 64 keys (one warpgroup in each kernel, two
    blocks an SM), two stages, the fastest on the card at the training
    step and ``train4k``. f32: 64 and 64 over four warps (one 16-row tile
    a warp in each kernel); 32 and 32 over two warps where D's
    accumulators leave no room for that or the sequences are shorter."""
    cands = ({"block_q": 64, "block_kv": 64, "num_warps": 4},
             {"block_q": 32, "block_kv": 32, "num_warps": 2})
    for cfg in cands:
        cfg = dict(cfg, num_stages=2)
        if FLASH_ATTENTION_BWD.space.is_valid(cfg, ctx):
            return cfg
    return {"block_q": 16, "block_kv": 16, "num_warps": 1, "num_stages": 2}


def _attention_bwd_operands(ctx: TuningContext,
                            cfg: Optional[Config] = None, device="cuda"):
    """q, k, v and do as (B, H, S, D) views of (B, S, H, D) tensors made
    from seed 0, with o and lse from one forward call (the kernel on the
    card, its plain version on the CPU) and the context's mask:
    ((q, k, v, o, lse, do), {"causal", "window"})."""
    (q, k, v), kw = _attention_operands(ctx, cfg, device)
    B, Hq, Sq, D = ctx.shape("q")
    gen = torch.Generator(device=device).manual_seed(1)
    do = _randn((B, Sq, Hq, D), q.dtype, gen).transpose(1, 2)
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
    return (q, k, v, o, lse, do), kw


def _flash_bwd_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    args, kw = _memo_operands(("flash_attention_bwd", ctx.signature()),
                              lambda: _attention_bwd_operands(ctx))
    return KernelRunner(fab_kernel.flash_attention_bwd, *args, **kw, **cfg)


FLASH_ATTENTION_BWD = TunableKernel(
    name="flash_attention_bwd",
    space=flash_attention_bwd_space(),
    version=2,
    workload_fn=_flash_bwd_workload,
    make_runner=_flash_bwd_runner,
    heuristic=_flash_bwd_heuristic,
)


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                  window: Optional[int] = None,
                  config: Optional[Config] = None,
                  tuner: Optional[Autotuner] = None):
    """Autotuned flash-attention gradients (dq, dk, dv). Layout (B, H, S,
    D) as ``attention``'s, any strides with D contiguous; lse (B, Hq, Sq)
    the forward's."""
    if config is None and q.is_cuda:
        tuner = tuner or default_tuner()
        B, Hq, Sq, D = q.shape
        Hkv, Skv = k.shape[1], k.shape[2]
        dt = dtype_name(q.dtype)
        config = tuner.dispatch_config(
            FLASH_ATTENTION_BWD, (B, Hq, Hkv, Sq, Skv, D, dt, bool(causal),
                                  window or 0, q.device.index),
            lambda: attention_context(device_chip(q.device.index), B, Hq,
                                      Hkv, Sq, Skv, D, dt, causal, window))
    return fab_kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                          window=window, **(config or {}))


# ===========================================================================
# MLA decode (absorbed latent attention over the compressed KV cache)
# ===========================================================================

def _mla_smem(cfg: Config, ctx: TuningContext) -> int:
    width = ctx.shape("q_abs")[2] + ctx.shape("q_rope")[2]
    return mla_kernel.smem_bytes(
        width, dtype_bytes(ctx.dtype),
        mla_kernel.clamp_block_kv(cfg["block_kv"], ctx.shape("ckv")[1]),
        cfg["num_warps"])


def mla_decode_space() -> ConfigSpace:
    """The reference's tunables (``block_kv``, ``k_splits``) at the sizes a
    Hopper block stages, with ``num_warps`` beside them and ``smem_fits``
    (two stages of block_kv rows of C + R) in place of ``vmem_fits``; the
    reference's ``splits<=blocks``."""
    sp = ConfigSpace(
        "mla_decode",
        [
            Param("block_kv", mla_kernel.BLOCK_KV),
            Param("k_splits", mla_kernel.K_SPLITS),
            Param("num_warps", mla_kernel.NUM_WARPS),
        ],
        version=1,
    )
    sp.constrain("smem", smem_fits(_mla_smem))
    sp.constrain(
        "splits<=blocks",
        lambda c, x: c["k_splits"] <= max(1, _cdiv(x.shape("ckv")[1],
                                                   c["block_kv"])))
    return sp


def mla_decode_bytes(B: int, H: int, C: int, R: int, kv_tokens: float,
                     itemsize: int) -> float:
    """HBM bytes of one call reading each cache row once: the ckv and
    krope rows of ``kv_tokens`` valid positions and q_abs, q_rope in
    ``itemsize``, the f32 context (B, H, C) out, the lengths."""
    return ((kv_tokens + B * H) * (C + R) * itemsize + 4.0 * B * H * C
            + 4.0 * B)


def mla_decode_flops(H: int, C: int, R: int, kv_tokens: float) -> float:
    """The C- and R-contractions of the scores and p·ckv: 2·(2C + R)
    operations per valid position and head."""
    return 2.0 * H * kv_tokens * (2 * C + R)


def _mla_workload(cfg: Config, ctx: TuningContext) -> KernelWorkload:
    """What the timed call moves under ``cfg`` (the runner attends all T,
    as the reference's does): the cache rows, q, the context, and the
    f32 partials the port writes: with one split an lse a row beside the
    context, with more each split's (context, lse) written by the kernel
    and read back by the combine."""
    B, H, C = ctx.shape("q_abs")
    T, R = ctx.shape("ckv")[1], ctx.shape("q_rope")[2]
    ks = cfg["k_splits"]
    partials = 4.0 * B * H if ks == 1 else 2.0 * 4 * B * ks * H * (C + 1)
    kv_tokens = float(B * T)
    return KernelWorkload(
        flops=mla_decode_flops(H, C, R, kv_tokens),
        hbm_bytes=mla_decode_bytes(B, H, C, R, kv_tokens,
                                   dtype_bytes(ctx.dtype)) + partials,
        dtype=ctx.dtype)


def _mla_heuristic(ctx: TuningContext) -> Config:
    """The reference's one split, at the largest block whose two stages
    the card holds with four warps."""
    base = {"k_splits": 1, "num_warps": 4}
    for block_kv in reversed(mla_kernel.BLOCK_KV):
        cfg = dict(base, block_kv=block_kv)
        if _mla_smem(cfg, ctx) <= ctx.chip.smem_per_block:
            return cfg
    return dict(base, block_kv=mla_kernel.BLOCK_KV[0])


def _mla_canonical(cfg: Config, ctx: TuningContext) -> Config:
    """The kernel clamps its block to the smallest one that holds the
    cache; larger blocks launch the same program."""
    c = dict(cfg)
    c["block_kv"] = mla_kernel.clamp_block_kv(c["block_kv"],
                                              ctx.shape("ckv")[1])
    return c


def _mla_operands(ctx: TuningContext, cfg: Optional[Config] = None,
                  device="cuda"):
    """q_abs, q_rope, ckv, krope drawn in the context's dtype (the
    reference's runner passes no lengths: every request attends all T),
    with the context's scale (1.0 unless ``extra`` names one)."""
    dtype = getattr(torch, ctx.dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    args = tuple(_randn(ctx.shape(name), dtype, gen)
                 for name in ("q_abs", "q_rope", "ckv", "krope"))
    return args, {"scale": float(ctx.extra.get("scale", 1.0))}


def _mla_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    args, kw = _memo_operands(("mla_decode", ctx.signature()),
                              lambda: _mla_operands(ctx))
    return KernelRunner(mla_kernel.mla_decode, *args, **kw, **cfg)


MLA_DECODE = TunableKernel(
    name="mla_decode",
    space=mla_decode_space(),
    version=1,
    workload_fn=_mla_workload,
    make_runner=_mla_runner,
    heuristic=_mla_heuristic,
    canonicalize=_mla_canonical,
)


def mla_decode_context(chip, B: int, H: int, C: int, R: int, T: int,
                       dtype: str) -> TuningContext:
    """Tuning scenario of an absorbed-MLA decode: B requests of H heads
    over a latent cache of T rows of rank C with RoPE keys of R, the
    reference's shapes."""
    return TuningContext(chip=chip, shapes={"q_abs": (B, H, C),
                                            "q_rope": (B, H, R),
                                            "ckv": (B, T, C),
                                            "krope": (B, T, R)},
                         dtype=dtype)


def latent_decode(q_abs, q_rope, ckv, krope, *, kv_len=None,
                  scale: Optional[float] = None,
                  config: Optional[Config] = None,
                  tuner: Optional[Autotuner] = None):
    """Autotuned absorbed-MLA decode. q_abs (B, H, C); q_rope (B, H, R);
    ckv (B, T, C); krope (B, T, R). Returns attended latents (B, H, C)
    f32."""
    if config is None and q_abs.is_cuda:
        tuner = tuner or default_tuner()
        B, H, C = q_abs.shape
        T, R = ckv.shape[1], q_rope.shape[2]
        dt = dtype_name(ckv.dtype)
        config = tuner.dispatch_config(
            MLA_DECODE, (B, H, C, R, T, dt, q_abs.device.index),
            lambda: mla_decode_context(device_chip(q_abs.device.index), B,
                                       H, C, R, T, dt))
    return mla_kernel.mla_decode(q_abs, q_rope, ckv, krope, kv_len=kv_len,
                                 scale=scale, **(config or {}))


# ===========================================================================
# RMS norm
# ===========================================================================

def _rms_regs_fit(cfg: Config, ctx: TuningContext) -> bool:
    """A program holds block_rows padded rows in fp32 registers; keep it
    within 128 values per thread (spilling past that)."""
    width = rms_kernel.padded_width(ctx.shape("x")[-1])
    return cfg["block_rows"] * width <= 128 * 32 * cfg["num_warps"]


def rms_norm_space() -> ConfigSpace:
    sp = ConfigSpace(
        "rms_norm",
        [Param("block_rows", (1, 2, 4, 8)), Param("num_warps", (4, 8))],
        version=1,
    )
    sp.constrain("registers", _rms_regs_fit)
    return sp


def rms_norm_bytes(N: int, D: int, itemsize: int) -> float:
    """x read once, y written once, the weight read once."""
    return 2.0 * N * D * itemsize + D * itemsize


def _rms_workload(cfg: Config, ctx: TuningContext) -> KernelWorkload:
    shape = ctx.shape("x")
    D = shape[-1]
    N = int(math.prod(shape[:-1]))
    return KernelWorkload(flops=4.0 * N * D,
                          hbm_bytes=rms_norm_bytes(N, D,
                                                   dtype_bytes(ctx.dtype)),
                          dtype=ctx.dtype)


def _rms_operands(ctx: TuningContext, cfg: Optional[Config] = None,
                  device="cuda"):
    x_s = ctx.shape("x")
    dtype = getattr(torch, ctx.dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    return (_randn(x_s, dtype, gen), _randn((x_s[-1],), dtype, gen)), {}


def _rms_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    x, w = _memo_operands(("rms_norm", ctx.signature()),
                          lambda: _rms_operands(ctx)[0])
    return KernelRunner(rms_kernel.rms_norm, x, w, **cfg)


RMS_NORM = TunableKernel(
    name="rms_norm",
    space=rms_norm_space(),
    version=1,
    workload_fn=_rms_workload,
    make_runner=_rms_runner,
    heuristic=lambda ctx: {"block_rows": 1, "num_warps": 4},
)


def rmsnorm_context(chip, x_shape, dtype: str) -> TuningContext:
    return TuningContext(chip=chip, shapes={"x": tuple(x_shape)},
                         dtype=dtype)


def rmsnorm(x, weight, *, eps: float = 1e-6,
            config: Optional[Config] = None,
            tuner: Optional[Autotuner] = None):
    if config is None and x.is_cuda:
        tuner = tuner or default_tuner()
        dt = dtype_name(x.dtype)
        key = (tuple(x.shape), dt, x.device.index)
        config = tuner.dispatch_config(
            RMS_NORM, key,
            lambda: rmsnorm_context(device_chip(x.device.index), x.shape, dt))
    return rms_kernel.rms_norm(x, weight, eps=eps, **(config or {}))


# ===========================================================================
# Registry: the reference's names, scenarios, descriptions and bench cases
# ===========================================================================

def _register_builtin_kernels() -> None:
    from repro_torch.kernels.registry import BenchCase, KernelSpec, register

    register(KernelSpec(
        tunable=FLASH_ATTENTION,
        scenarios=("prefill", "training", "gqa"),
        reference=ref.flash_attention,
        entry_point=attention,
        operands=_attention_operands,
        description="Flash attention forward (prefill / training)",
        bench_cases=(
            BenchCase("s512", {"q": (1, 4, 512, 128), "k": (1, 1, 512, 128)},
                      extra={"causal": True, "window": 0}),
            BenchCase("train4k",
                      {"q": (8, 32, 4096, 128), "k": (8, 8, 4096, 128)},
                      dtype="bfloat16",
                      extra={"causal": True, "window": 0}, scale="paper"),
            BenchCase("prefill32k",
                      {"q": (1, 32, 32768, 128), "k": (1, 8, 32768, 128)},
                      dtype="bfloat16",
                      extra={"causal": True, "window": 0}, scale="paper"),
        ),
    ))
    register(KernelSpec(
        tunable=FLASH_ATTENTION_BWD,
        scenarios=("training",),
        reference=ref.flash_attention_bwd,
        entry_point=attention_bwd,
        operands=_attention_bwd_operands,
        description="Flash attention backward (dq/dk/dv recompute)",
        bench_cases=(
            BenchCase("train4k",
                      {"q": (8, 32, 4096, 128), "k": (8, 8, 4096, 128)},
                      dtype="bfloat16",
                      extra={"causal": True, "window": 0}, scale="paper"),
        ),
    ))
    register(KernelSpec(
        tunable=DECODE_ATTENTION,
        scenarios=("decode", "gqa"),
        reference=ref.decode_attention,
        entry_point=decode,
        operands=lambda ctx, cfg=None, device="cuda": _dense_operands(
            ctx, device, with_lens=False),
        description="Flash-decode attention (one token vs KV cache)",
        bench_cases=(
            BenchCase("d1024", {"q": (2, 4, 128), "k": (2, 1, 1024, 128)}),
            BenchCase("decode32k",
                      {"q": (16, 32, 128), "k": (16, 8, 32768, 128)},
                      dtype="bfloat16", scale="paper"),
        ),
    ))
    register(KernelSpec(
        tunable=GQA_DECODE_RAGGED,
        scenarios=("decode", "gqa", "ragged", "serving"),
        reference=ref.gqa_decode,
        entry_point=ragged_decode,
        operands=lambda ctx, cfg=None, device="cuda": _dense_operands(
            ctx, device, with_lens=True),
        description="Ragged batched GQA decode (per-request KV lengths)",
        bench_cases=(
            BenchCase("r1024", {"q": (2, 8, 128), "k": (2, 2, 1024, 128)},
                      extra={"fill": 0.5}),
            BenchCase("serve32k",
                      {"q": (16, 32, 128), "k": (16, 8, 32768, 128)},
                      dtype="bfloat16", extra={"fill": 0.5}, scale="paper"),
        ),
    ))
    register(KernelSpec(
        tunable=GQA_DECODE_KV8,
        scenarios=("decode", "gqa", "ragged", "serving", "quant"),
        precision="int8",
        reference=ref.gqa_decode_kv8,
        entry_point=ragged_decode_kv8,
        operands=lambda ctx, cfg=None, device="cuda": _kv8_operands(
            ctx, device),
        description="Ragged GQA decode over an int8 KV cache "
                    "(per-token scales, in-kernel dequant)",
        bench_cases=(
            BenchCase("r1024", {"q": (2, 8, 128), "k": (2, 2, 1024, 128)},
                      dtype="int8", extra={"fill": 0.5}),
            BenchCase("serve32k",
                      {"q": (16, 32, 128), "k": (16, 8, 32768, 128)},
                      dtype="int8", extra={"fill": 0.5}, scale="paper"),
        ),
    ))
    register(KernelSpec(
        tunable=PAGED_DECODE,
        scenarios=("decode", "gqa", "ragged", "serving", "paged", "quant"),
        reference=ref.paged_decode,
        entry_point=paged_decode,
        operands=_paged_operands,
        description="Paged-KV decode over block tables (continuous "
                    "batching page pool; int8 pages under the kv8 policy)",
        bench_cases=(
            BenchCase("p1024", {"q": (2, 8, 128), "k": (2, 2, 1024, 128)},
                      extra={"fill": 0.5}),
            BenchCase("p1024_kv8",
                      {"q": (2, 8, 128), "k": (2, 2, 1024, 128)},
                      dtype="int8", extra={"fill": 0.5}),
            BenchCase("pool32k",
                      {"q": (16, 32, 128), "k": (16, 8, 32768, 128)},
                      dtype="bfloat16", extra={"fill": 0.5}, scale="paper"),
            BenchCase("pool32k_kv8",
                      {"q": (16, 32, 128), "k": (16, 8, 32768, 128)},
                      dtype="int8", extra={"fill": 0.5}, scale="paper"),
        ),
    ))
    register(KernelSpec(
        tunable=PAGED_VERIFY,
        scenarios=("decode", "gqa", "ragged", "serving", "paged", "quant",
                   "speculative"),
        reference=ref.paged_verify,
        entry_point=paged_verify,
        operands=_paged_verify_operands,
        description="Speculative batched verify: K draft positions per "
                    "sequence in one launch over the paged-KV pool "
                    "(ragged kv_len+K causal tails; int8 pages under kv8)",
        bench_cases=(
            BenchCase("v1024", {"q": (2, 8, 128), "k": (2, 2, 1024, 128)},
                      extra={"fill": 0.5, "draft_k": 4}),
            BenchCase("v1024_kv8",
                      {"q": (2, 8, 128), "k": (2, 2, 1024, 128)},
                      dtype="int8", extra={"fill": 0.5, "draft_k": 4}),
            BenchCase("vpool32k",
                      {"q": (16, 32, 128), "k": (16, 8, 32768, 128)},
                      dtype="bfloat16", extra={"fill": 0.5, "draft_k": 4},
                      scale="paper"),
        ),
    ))
    register(KernelSpec(
        tunable=MATMUL,
        scenarios=("prefill", "training"),
        reference=ref.matmul,
        entry_point=matmul,
        operands=_mm_operands,
        description="Blocked matmul",
        bench_cases=(
            BenchCase("m256", {"x": (256, 256), "y": (256, 256)}),
            BenchCase("mm8k", {"x": (8192, 8192), "y": (8192, 8192)},
                      dtype="bfloat16", scale="paper"),
        ),
    ))
    register(KernelSpec(
        tunable=MATMUL_W8A8,
        scenarios=("prefill", "training", "serving", "quant"),
        precision="int8",
        reference=ref.matmul_w8a8,
        entry_point=matmul_w8a8,
        operands=_w8a8_operands,
        description="w8a8 GEMM: int8×int8→int32 MXU accumulate with "
                    "fused per-channel/per-tensor dequant",
        bench_cases=(
            BenchCase("m256", {"x": (256, 256), "y": (256, 256)},
                      dtype="int8"),
            BenchCase("proj4k", {"x": (512, 4096), "y": (4096, 4096)},
                      dtype="int8", scale="paper"),
            BenchCase("mm8k", {"x": (8192, 8192), "y": (8192, 8192)},
                      dtype="int8", scale="paper"),
        ),
    ))
    register(KernelSpec(
        tunable=MLA_DECODE,
        scenarios=("decode", "mla", "serving"),
        reference=ref.mla_decode,
        entry_point=latent_decode,
        operands=_mla_operands,
        description="Absorbed-MLA decode over the compressed latent cache",
        bench_cases=(
            BenchCase("m1024", {"q_abs": (2, 4, 256), "q_rope": (2, 4, 64),
                                "ckv": (2, 1024, 256),
                                "krope": (2, 1024, 64)}),
            BenchCase("dsv2_32k",
                      {"q_abs": (8, 16, 512), "q_rope": (8, 16, 64),
                       "ckv": (8, 32768, 512), "krope": (8, 32768, 64)},
                      dtype="bfloat16", scale="paper"),
        ),
    ))
    register(KernelSpec(
        tunable=RMS_NORM,
        scenarios=("prefill", "decode", "training"),
        reference=ref.rms_norm,
        entry_point=rmsnorm,
        operands=_rms_operands,
        description="RMS layer norm",
        bench_cases=(
            BenchCase("r1024x2048", {"x": (1024, 2048)}),
            BenchCase("r8192x4096", {"x": (8192, 4096)}, dtype="bfloat16",
                      scale="paper"),
        ),
    ))


_register_builtin_kernels()
