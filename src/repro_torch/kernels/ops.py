"""Autotuned kernel entry points (subset of ``repro.kernels.ops``).

For each of the port's kernels this module declares

  * a **Hopper** ``ConfigSpace`` whose validity follows the card (shared
    memory per block, registers per thread) — the TPU spaces and the
    shipped TPU tuning DB do not carry over, every key there names a TPU;
  * a workload that counts the bytes (and operations) a call moves;
  * a runner factory that builds operands on the card for timing a config;
  * a heuristic default;

and the entry points ``paged_decode(...)``, ``paged_verify(...)`` and
``rmsnorm(...)`` that resolve their config through the tuner and
dispatch. Every entry point accepts ``config=`` to bypass tuning. Tensors
on the CPU need no config: the kernel wrappers run their plain versions
there.
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
from repro_torch.kernels import paged_decode as pd_kernel
from repro_torch.kernels import paged_verify as pv_kernel
from repro_torch.kernels import rms_norm as rms_kernel


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
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


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


def paged_decode_space() -> ConfigSpace:
    sp = ConfigSpace(
        "paged_decode",
        [
            Param("page_size", PAGE_SIZES),
            Param("block_kv", BLOCK_KV),
            Param("pack_gqa", (True, False)),
            Param("num_warps", (2, 4, 8)),
        ],
        version=1,
    )
    sp.constrain("smem", smem_fits(_paged_smem))
    sp.constrain("block_kv%page_size",
                 lambda c, x: c["block_kv"] % c["page_size"] == 0)
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
    return sp


def paged_decode_bytes(B: int, Hq: int, Hkv: int, D: int, kv_tokens: float,
                       max_pages: int, itemsize: int) -> float:
    """HBM bytes of one call reading each K/V row once: the K and V rows
    of ``kv_tokens`` resident tokens over Hkv heads, q in, o out, the
    block tables and lengths."""
    return (2.0 * kv_tokens * Hkv * D * itemsize + 2.0 * B * Hq * D * itemsize
            + 4.0 * B * max_pages + 4.0 * B)


def paged_decode_flops(Hq: int, D: int, kv_tokens: float) -> float:
    """q·k and p·v: 4 operations per resident token, query head and dim."""
    return 4.0 * kv_tokens * Hq * D


def _paged_lens(ctx: TuningContext) -> torch.Tensor:
    """The ragged lengths the runner times with (seeded, on the CPU)."""
    B = ctx.shape("q")[0]
    T = ctx.shape("k")[2]
    hi = max(2, int(T * float(ctx.extra.get("fill", 1.0)))) + 1
    gen = torch.Generator().manual_seed(7)
    return torch.randint(1, hi, (B,), generator=gen, dtype=torch.int32)


def _paged_workload(cfg: Config, ctx: TuningContext) -> KernelWorkload:
    """What the timed call moves under ``cfg``: unpacked heads each read
    their KV head's rows, so the group re-reads them."""
    B, Hq, D = ctx.shape("q")
    Hkv, T = ctx.shape("k")[1], ctx.shape("k")[2]
    ps = cfg["page_size"]
    kv_tokens = float(torch.clamp(_paged_lens(ctx), max=_rup(T, ps)).sum())
    reads = 1 if cfg["pack_gqa"] else _group(ctx)
    return KernelWorkload(
        flops=paged_decode_flops(Hq, D, kv_tokens),
        hbm_bytes=paged_decode_bytes(B, Hq, Hkv, D, kv_tokens * reads,
                                     _cdiv(T, ps), dtype_bytes(ctx.dtype)),
        dtype=ctx.dtype)


def _paged_heuristic(ctx: TuningContext) -> Config:
    """vLLM-style default: 16-token pages, 64 rows per step, packed heads."""
    ps = int(ctx.extra.get("page_size", 16))
    cap = _rup(ctx.shape("k")[2], ps)
    fits = [v for v in BLOCK_KV if v % ps == 0 and v <= max(64, ps)
            and v <= cap]
    return {"page_size": ps, "block_kv": max(fits) if fits else ps,
            "pack_gqa": 1 < _group(ctx) <= pd_kernel.MAX_PACKED_GROUP,
            "num_warps": 4}


def _paged_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    """A filled pool with the config's page size; page 0 is the scratch
    page and each sequence owns a contiguous run of pages."""
    B, Hq, D = ctx.shape("q")
    Hkv, T = ctx.shape("k")[1], ctx.shape("k")[2]
    ps = cfg["page_size"]
    dtype = getattr(torch, ctx.dtype)

    def build():
        gen = torch.Generator(device="cuda").manual_seed(0)
        pps = _cdiv(T, ps)
        n_pages = 1 + B * pps
        q = _randn((B, Hq, D), dtype, gen)
        kp = _randn((Hkv, n_pages, ps, D), dtype, gen)
        vp = _randn((Hkv, n_pages, ps, D), dtype, gen)
        tbl = torch.arange(1, n_pages, dtype=torch.int32,
                           device="cuda").reshape(B, pps)
        return q, kp, vp, tbl, _paged_lens(ctx).cuda()

    args = _memo_operands(("paged_decode", ctx.signature(), ps), build)
    return KernelRunner(pd_kernel.paged_decode, *args,
                        block_kv=cfg["block_kv"], pack_gqa=cfg["pack_gqa"],
                        num_warps=cfg["num_warps"])


PAGED_DECODE = TunableKernel(
    name="paged_decode",
    space=paged_decode_space(),
    version=1,
    workload_fn=_paged_workload,
    make_runner=_paged_runner,
    heuristic=_paged_heuristic,
)


def paged_decode_context(chip, B: int, Hq: int, Hkv: int, D: int,
                         capacity: int, dtype: str,
                         page_size: Optional[int] = None) -> TuningContext:
    """Tuning scenario of a decode over B sequences of ``capacity`` token
    slots; ``page_size`` pins the pool's layout (omit it for deployment
    tuning, where the winner sizes the pool)."""
    extra = {} if page_size is None else {"page_size": int(page_size)}
    return TuningContext(chip=chip, shapes={"q": (B, Hq, D),
                                            "k": (B, Hkv, capacity, D)},
                         dtype=dtype, extra=extra)


def paged_decode(q, k_pages, v_pages, block_tables, kv_len, *,
                 scale: Optional[float] = None,
                 config: Optional[Config] = None,
                 tuner: Optional[Autotuner] = None):
    """Autotuned paged decode. q (B, Hq, D); k/v_pages (Hkv, P, page_size,
    D); block_tables (B, max_pages); kv_len (B,). The pool pins
    ``page_size``, so the lookup context carries it and the remaining
    tunables dispatch to the kernel."""
    if config is None and q.is_cuda:
        tuner = tuner or default_tuner()
        B, Hq, D = q.shape
        Hkv, _, ps, _ = k_pages.shape
        max_pages = block_tables.shape[1]
        dt = dtype_name(k_pages.dtype)
        key = (B, Hq, Hkv, D, ps, max_pages, dt, q.device.index)
        config = tuner.dispatch_config(
            PAGED_DECODE, key,
            lambda: paged_decode_context(device_chip(q.device.index), B, Hq,
                                         Hkv, D, max_pages * ps, dt, ps))
    cfg = {k: v for k, v in (config or {}).items() if k != "page_size"}
    return pd_kernel.paged_decode(q, k_pages, v_pages, block_tables, kv_len,
                                  scale=scale, **cfg)


# ===========================================================================
# Paged verify (speculative decoding: K draft positions per sequence scored
# in one launch, each with its causal tail over the same page pool)
# ===========================================================================

def _verify_smem(cfg: Config, ctx: TuningContext) -> int:
    D = ctx.shape("q")[2]
    return pv_kernel.smem_bytes(D, dtype_bytes(ctx.dtype), cfg["block_kv"],
                                cfg["draft_k"], _group(ctx), cfg["pack_gqa"],
                                cfg["num_warps"])


def paged_verify_space() -> ConfigSpace:
    sp = ConfigSpace(
        "paged_verify",
        [
            Param("draft_k", pv_kernel.DRAFT_KS),
            Param("page_size", PAGE_SIZES),
            Param("block_kv", BLOCK_KV),
            Param("pack_gqa", (True, False)),
            # 16 warps give rows of the packed layouts two key splits
            Param("num_warps", (2, 4, 8, 16)),
        ],
        version=1,
    )
    sp.constrain("smem", smem_fits(_verify_smem))
    sp.constrain("block_kv%page_size",
                 lambda c, x: c["block_kv"] % c["page_size"] == 0)
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
    return sp


def verify_attended(kv_len: torch.Tensor, K: int, capacity: int) -> float:
    """Keys the K query rows of every sequence attend, summed: row t of a
    sequence of L = min(kv_len, capacity) tokens sees L - K + t + 1."""
    lens = torch.clamp(kv_len.long().cpu(), 0, capacity)
    t = torch.arange(K)
    return float(torch.clamp(lens[:, None] - K + t[None] + 1, min=0).sum())


def paged_verify_bytes(B: int, K: int, Hq: int, Hkv: int, D: int,
                       kv_tokens: float, max_pages: int,
                       itemsize: int) -> float:
    """HBM bytes of one call reading each K/V row once: the K and V rows
    of ``kv_tokens`` resident tokens (drafts included) over Hkv heads, the
    K query rows in, the K output rows out, the block tables and
    lengths — paged_decode's bytes with K query positions."""
    return (2.0 * kv_tokens * Hkv * D * itemsize
            + 2.0 * B * K * Hq * D * itemsize + 4.0 * B * max_pages
            + 4.0 * B)


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
    their KV head's rows, so the group re-reads them."""
    B, Hq, D = ctx.shape("q")
    Hkv, T = ctx.shape("k")[1], ctx.shape("k")[2]
    ps, K = cfg["page_size"], cfg["draft_k"]
    cap = _rup(T, ps)
    lens = _verify_lens(ctx, K)
    kv_tokens = float(torch.clamp(lens, max=cap).sum())
    reads = 1 if cfg["pack_gqa"] else _group(ctx)
    return KernelWorkload(
        flops=paged_verify_flops(Hq, D, verify_attended(lens, K, cap)),
        hbm_bytes=paged_verify_bytes(B, K, Hq, Hkv, D, kv_tokens * reads,
                                     _cdiv(T, ps), dtype_bytes(ctx.dtype)),
        dtype=ctx.dtype)


def _paged_verify_heuristic(ctx: TuningContext) -> Config:
    """The reference's default: depth 4, one page per step, packed heads."""
    ps = int(ctx.extra.get("page_size", 16))
    return {"draft_k": int(ctx.extra.get("draft_k", 4)), "page_size": ps,
            "block_kv": ps, "pack_gqa": _group(ctx) > 1, "num_warps": 4}


def _paged_verify_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    """The decode runner's pool with the config's page size, a K-position
    query block and lengths >= K."""
    B, Hq, D = ctx.shape("q")
    Hkv, T = ctx.shape("k")[1], ctx.shape("k")[2]
    ps, K = cfg["page_size"], cfg["draft_k"]
    dtype = getattr(torch, ctx.dtype)

    def build():
        gen = torch.Generator(device="cuda").manual_seed(0)
        pps = _cdiv(T, ps)
        n_pages = 1 + B * pps
        q = _randn((B, K, Hq, D), dtype, gen)
        kp = _randn((Hkv, n_pages, ps, D), dtype, gen)
        vp = _randn((Hkv, n_pages, ps, D), dtype, gen)
        tbl = torch.arange(1, n_pages, dtype=torch.int32,
                           device="cuda").reshape(B, pps)
        return q, kp, vp, tbl, _verify_lens(ctx, K).cuda()

    args = _memo_operands(("paged_verify", ctx.signature(), ps, K), build)
    return KernelRunner(pv_kernel.paged_verify, *args,
                        block_kv=cfg["block_kv"], pack_gqa=cfg["pack_gqa"],
                        num_warps=cfg["num_warps"])


PAGED_VERIFY = TunableKernel(
    name="paged_verify",
    space=paged_verify_space(),
    version=1,
    workload_fn=_paged_verify_workload,
    make_runner=_paged_verify_runner,
    heuristic=_paged_verify_heuristic,
)


def paged_verify_context(chip, B: int, Hq: int, Hkv: int, D: int,
                         capacity: int, dtype: str,
                         page_size: Optional[int] = None,
                         draft_k: Optional[int] = None) -> TuningContext:
    """Tuning scenario of a verify over B sequences of ``capacity`` token
    slots. ``page_size`` pins the pool's layout and ``draft_k`` the
    engine's speculation depth, so each depth is its own scenario; omit
    both for deployment tuning, whose winner sizes the pool and
    recommends the depth."""
    extra = {}
    if page_size is not None:
        extra["page_size"] = int(page_size)
    if draft_k is not None:
        extra["draft_k"] = int(draft_k)
    return TuningContext(chip=chip, shapes={"q": (B, Hq, D),
                                            "k": (B, Hkv, capacity, D)},
                         dtype=dtype, extra=extra)


def paged_verify(q, k_pages, v_pages, block_tables, kv_len, *,
                 scale: Optional[float] = None,
                 config: Optional[Config] = None,
                 tuner: Optional[Autotuner] = None):
    """Autotuned speculative verify. q (B, K, Hq, D), K consecutive query
    positions per sequence; k/v_pages (Hkv, P, page_size, D);
    block_tables (B, max_pages); kv_len (B,) valid tokens *including*
    the K scattered draft positions. The pool pins ``page_size`` and q
    pins ``draft_k``, so the lookup context carries both and the
    remaining tunables dispatch to the kernel."""
    if config is None and q.is_cuda:
        tuner = tuner or default_tuner()
        B, K, Hq, D = q.shape
        Hkv, _, ps, _ = k_pages.shape
        max_pages = block_tables.shape[1]
        dt = dtype_name(k_pages.dtype)
        key = (B, K, Hq, Hkv, D, ps, max_pages, dt, q.device.index)
        config = tuner.dispatch_config(
            PAGED_VERIFY, key,
            lambda: paged_verify_context(device_chip(q.device.index), B, Hq,
                                         Hkv, D, max_pages * ps, dt, ps, K))
    cfg = {k: v for k, v in (config or {}).items()
           if k not in ("page_size", "draft_k")}
    return pv_kernel.paged_verify(q, k_pages, v_pages, block_tables, kv_len,
                                  scale=scale, **cfg)


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


def _rms_runner(cfg: Config, ctx: TuningContext) -> KernelRunner:
    x_s = ctx.shape("x")
    dtype = getattr(torch, ctx.dtype)

    def build():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return _randn(x_s, dtype, gen), _randn((x_s[-1],), dtype, gen)

    x, w = _memo_operands(("rms_norm", ctx.signature()), build)
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
