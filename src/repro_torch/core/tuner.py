"""The autotuner (subset of ``repro.core.tuner``).

A ``TunableKernel`` bundles a config space, a workload (what a call must
move), a runner factory for timing a config on the card, and a heuristic
default. ``Autotuner.best_config`` is what a kernel entry point calls:

  cache hit (same environment, config still valid)  → reuse
  miss, on_miss "tune"                              → time the space now
  miss, on_miss "heuristic"                         → the heuristic default
  miss, on_miss "error"                             → raise

``tune`` measures with the backend (CUDA events on the card by default),
searches the space (timing each of a kernel's canonical configs once),
and stores the winner; ``tune_many`` tunes a list of (kernel, context)
pairs one after the other on the one card. ``default_tuner()`` reads the
shipped H100 tuning DB (``SHIPPED_DB``, written by
``repro_torch.configs.gen_shipped_db``) as a read-only overlay, so a fresh
process starts warm on the scenarios it holds. Background tuning, the
reference's concurrent compile pool, config portfolios, quarantine and
drift retuning are not in the port.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import (Callable, Dict, Iterable, List, Optional, Tuple,
                    Union)

from repro_torch.core import cache as cache_lib
from repro_torch.core import measure as measure_lib
from repro_torch.core import search as search_lib
from repro_torch.core.config_space import Config, ConfigSpace, TuningContext
from repro_torch.core.costmodel import KernelWorkload

log = logging.getLogger("repro_torch.tuner")


@dataclasses.dataclass
class TunableKernel:
    name: str
    space: ConfigSpace
    version: int = 1
    workload_fn: Optional[
        Callable[[Config, TuningContext], KernelWorkload]] = None
    make_runner: Optional[measure_lib.RunnerFactory] = None
    heuristic: Optional[Callable[[TuningContext], Config]] = None
    # Maps a config to the one the kernel actually launches (e.g. a block
    # clamped to the sequence); configs with equal canonical forms are
    # timed once per search.
    canonicalize: Optional[Callable[[Config, TuningContext], Config]] = None

    def default_config(self, ctx: TuningContext) -> Config:
        if self.heuristic is not None:
            cfg = self.heuristic(ctx)
            if self.space.is_valid(cfg, ctx):
                return cfg
        return self.space.default(ctx)


class Autotuner:
    def __init__(self, cache: Optional[cache_lib.TuningCache] = None,
                 backend=None, on_miss: str = "tune"):
        if on_miss not in ("tune", "heuristic", "error"):
            raise ValueError(f"on_miss {on_miss!r}")
        self.cache = cache if cache is not None else cache_lib.TuningCache()
        self.backend = backend or measure_lib.CudaEventTimer()
        self.on_miss = on_miss
        self._stats = {"hits": 0, "misses": 0, "tunes": 0,
                       "heuristic_uses": 0}
        self._lock = threading.Lock()
        self._dispatch: Dict[Tuple, Config] = {}

    def _bump(self, key: str) -> None:
        with self._lock:
            self._stats[key] += 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def tune(self, kernel: TunableKernel,
             ctx: TuningContext) -> cache_lib.CacheEntry:
        """Search the space exhaustively now, store the winner, return its
        entry. A search in which no config ran stores a failed (inf) entry
        holding the default config, which lookups treat as a miss."""
        strat = search_lib.ExhaustiveSearch()
        t0 = time.perf_counter()
        result = strat.run(kernel.space, ctx,
                           _dedupe(self.backend.evaluator(kernel, ctx),
                                   kernel, ctx))
        seconds = time.perf_counter() - t0
        self._bump("tunes")
        if result.best is None:
            entry = cache_lib.make_entry(
                kernel.default_config(ctx), float("inf"), result.evaluations,
                f"{strat.name}(failed)", self.backend.name, seconds)
        else:
            entry = cache_lib.make_entry(
                result.best, result.best_metric, result.evaluations,
                strat.name, self.backend.name, seconds)
        self.cache.put(kernel.name, kernel.version, kernel.space, ctx, entry)
        with self._lock:
            self._dispatch.clear()
        log.info("tuned %s ctx=%s -> %s (%.3g s/call, %d configs, %.1f s)",
                 kernel.name, ctx.signature(), entry.config, entry.metric,
                 entry.n_evaluated, seconds)
        return entry

    def tune_many(self, items: Iterable[Tuple[TunableKernel, TuningContext]],
                  return_exceptions: bool = False
                  ) -> List[Union[cache_lib.CacheEntry, Exception]]:
        """``tune`` each (kernel, context) pair in turn: one card times one
        config at a time. Results align with the input; with
        ``return_exceptions`` a pair that raises gives its exception and
        the rest still run."""
        out: List[Union[cache_lib.CacheEntry, Exception]] = []
        for kernel, ctx in items:
            try:
                out.append(self.tune(kernel, ctx))
            except Exception as e:   # noqa: BLE001 — returned to the caller
                if not return_exceptions:
                    raise
                log.warning("tuning %s ctx=%s failed: %r", kernel.name,
                            ctx.signature(), e)
                out.append(e)
        return out

    def best_config(self, kernel: TunableKernel,
                    ctx: TuningContext) -> Config:
        entry = self.cache.get(
            kernel.name, kernel.version, kernel.space, ctx,
            require_fingerprint=cache_lib.env_fingerprint(self.backend.name))
        if entry is not None and not entry.failed():
            self._bump("hits")
            return dict(entry.config)
        self._bump("misses")
        if self.on_miss == "tune":
            return dict(self.tune(kernel, ctx).config)
        if self.on_miss == "heuristic":
            self._bump("heuristic_uses")
            return kernel.default_config(ctx)
        raise LookupError(f"no tuned config for kernel {kernel.name!r} ctx "
                          f"{ctx.signature()} and on_miss='error'")

    def dispatch_config(self, kernel: TunableKernel, key: Tuple,
                        make_ctx: Callable[[], TuningContext]) -> Config:
        """``best_config`` memoized on a hashable ``key`` the caller builds
        from its operands' shapes, dtype and device. Eager serving resolves
        a config on every kernel call (a hundred per decode step at full
        depth), so the context and cache key are built once per scenario;
        any ``tune`` clears the memo so a new winner is picked up."""
        memo_key = (kernel.name, key)
        with self._lock:
            cfg = self._dispatch.get(memo_key)
        if cfg is None:
            cfg = self.best_config(kernel, make_ctx())
            with self._lock:
                self._dispatch[memo_key] = cfg
        return dict(cfg)


def _dedupe(evaluate: Callable[[Config], float], kernel: TunableKernel,
            ctx: TuningContext) -> Callable[[Config], float]:
    """``evaluate`` timing each canonical form once: a config whose
    ``kernel.canonicalize`` form was timed already gets that time."""
    if kernel.canonicalize is None:
        return evaluate
    seen: Dict[Tuple, float] = {}

    def run(cfg: Config) -> float:
        key = tuple(sorted(kernel.canonicalize(cfg, ctx).items()))
        if key not in seen:
            seen[key] = evaluate(cfg)
        return seen[key]

    return run


_DEFAULT: Optional[Autotuner] = None
_DEFAULT_LOCK = threading.Lock()

SHIPPED_DB = os.path.abspath(os.path.join(
    os.path.dirname(__file__), os.pardir, "configs",
    "shipped_tuning_db.json"))


def default_tuner() -> Autotuner:
    """Process-wide tuner the kernel entry points use: CUDA-event timing,
    exhaustive search, an in-process cache over the shipped DB
    (``SHIPPED_DB``, read-only), ``on_miss`` from ``$REPRO_ON_MISS``
    (default "tune")."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Autotuner(
                cache=cache_lib.TuningCache(overlay_path=SHIPPED_DB),
                on_miss=os.environ.get("REPRO_ON_MISS", "tune"))
        return _DEFAULT


def set_default_tuner(tuner: Optional[Autotuner]) -> None:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = tuner
