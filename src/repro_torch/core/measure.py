"""Measuring kernel configs on the card (subset of ``repro.core.measure``).

``CudaEventTimer`` times a zero-arg runner with CUDA events: ``warmup``
untimed calls (the first one compiles a Triton config), then ``reps``
timed calls, and returns the median in seconds. Before each rep it
overwrites a buffer four times the L2's size, so every rep finds its
operands in HBM as the serving step does after the layers between two
calls, and then spins the card for a fixed number of cycles
(``torch.cuda._sleep``): the host enqueues the start event, the runner's
launches and the end event while the card is still busy, so the interval
is the kernels' device time and not the host's launch latency (which for
a Triton launch exceeds a small kernel's run time). A measurement with no
card fails: there is no CPU fallback.

``KernelRunner`` keeps (fn, args, kwargs) inspectable so runner factories
in ``kernels.ops`` return the same object the timer calls.
"""

from __future__ import annotations

import logging
import math
import statistics
from typing import Any, Callable, Optional

import torch

from repro_torch.core.config_space import Config, TuningContext

log = logging.getLogger("repro_torch.measure")

RunnerFactory = Callable[[Config, TuningContext], Callable[[], Any]]

# Cycles the card spins ahead of each timed rep (about 0.5 ms on an H100):
# longer than the host takes to enqueue a runner of a few launches.
LEAD_CYCLES = 1_000_000


class KernelRunner:
    """Zero-arg runner that keeps (fn, args) inspectable."""

    def __init__(self, fn: Callable[..., Any], *args: Any, **kwargs: Any):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs

    def __call__(self) -> Any:
        return self.fn(*self.args, **self.kwargs)


class CudaEventTimer:
    name = "cuda_events"

    def __init__(self, reps: int = 20, warmup: int = 3):
        self.reps = reps
        self.warmup = warmup
        self._flush: Optional[torch.Tensor] = None

    def _flush_buffer(self) -> torch.Tensor:
        if self._flush is None:
            l2 = torch.cuda.get_device_properties(None).L2_cache_size
            self._flush = torch.empty(4 * max(l2, 2**20), dtype=torch.uint8,
                                      device="cuda")
        return self._flush

    def time_runner(self, runner: Callable[[], Any]) -> float:
        """Median seconds per call of ``runner`` on the current stream."""
        if not torch.cuda.is_available():
            raise RuntimeError("CudaEventTimer needs a CUDA device")
        for _ in range(self.warmup):
            runner()
        flush = self._flush_buffer()
        samples = []
        for _ in range(self.reps):
            flush.zero_()
            torch.cuda._sleep(LEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runner()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) * 1e-3)
        return statistics.median(samples)

    def evaluator(self, kernel, ctx: TuningContext):
        """Config -> seconds per call; ``inf`` for a config that fails to
        build or launch, so the search moves on to the next one."""
        if kernel.make_runner is None:
            raise ValueError(f"kernel {kernel.name!r} has no runner factory")

        def evaluate(cfg: Config) -> float:
            try:
                return self.time_runner(kernel.make_runner(cfg, ctx))
            except Exception:   # noqa: BLE001 — a failing config scores inf
                log.warning("%s config %s failed to run", kernel.name, cfg,
                            exc_info=True)
                return math.inf

        return evaluate
