"""Fault-tolerant training loop (``repro.runtime.trainer``): checkpoint and
restart, the straggler watchdog, failure injection for tests.

  * every ``ckpt_every`` steps the full (params, opt_state, data-stream)
    state is checkpointed atomically; ``run()`` always resumes from the
    latest complete checkpoint, so a failed run restarts losslessly;
  * the step-time watchdog tracks an EWMA and flags stragglers (steps
    slower than ``straggler_factor``× the EWMA);
  * ``failure_at`` raises at a chosen step — the failure-injection hook the
    restart test uses.

Two differences from the reference. A step's time ends at
``torch.cuda.synchronize()`` where a metric lies on the card (in place of
``jax.block_until_ready``), and every step's time is kept in
``step_times``. A resume copies the checkpoint into the tensors of the
trainer's own tree in place, so a model whose parameters are that tree's
leaves sees the restored values. ``ckpt_every`` 0 turns checkpoints off,
the last one too: a full-width state (46 GB at phi4-mini's 3.8 B
parameters) is more than a smoke run wants to write.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt

log = logging.getLogger("repro_torch.trainer")


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50                 # 0: no checkpoints
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.1
    failure_at: Optional[int] = None     # raise InjectedFailure at this step


def _copy_into_(dst, src) -> None:
    for d, s in zip(ckpt._flatten(dst).values(), ckpt._flatten(src).values()):
        d.copy_(s)


class Trainer:
    def __init__(self, tcfg: TrainerConfig, step_fn: Callable,
                 params, opt_state, data_iter: Iterator,
                 data_state_fn: Optional[Callable[[], Dict]] = None,
                 data_restore_fn: Optional[Callable[[Dict], None]] = None):
        self.tcfg = tcfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data_iter = data_iter
        self.data_state_fn = data_state_fn or (lambda: {})
        self.data_restore_fn = data_restore_fn or (lambda s: None)
        self.step = 0
        self.metrics_history: list = []
        self.straggler_steps: list = []
        self.step_times: list = []
        self._ewma: Optional[float] = None

    # -- checkpoint/restart -------------------------------------------------
    def save(self) -> str:
        state = {"params": self.params, "opt_state": self.opt_state}
        path = ckpt.save(self.tcfg.ckpt_dir, self.step, state,
                         extra={"data": self.data_state_fn(),
                                "step": self.step})
        ckpt.prune_old(self.tcfg.ckpt_dir, self.tcfg.keep_ckpts)
        return path

    def maybe_resume(self) -> bool:
        if not self.tcfg.ckpt_every:
            return False
        latest = ckpt.latest_step(self.tcfg.ckpt_dir)
        if latest is None:
            return False
        state_like = {"params": self.params, "opt_state": self.opt_state}
        state, extra = ckpt.restore(self.tcfg.ckpt_dir, state_like, latest)
        with torch.no_grad():
            _copy_into_(state_like, state)
        self.step = int(extra["step"])
        self.data_restore_fn(extra.get("data", {}))
        log.info("resumed from step %d", self.step)
        return True

    # -- watchdog -------------------------------------------------------------
    def _watch(self, dt: float) -> None:
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.tcfg.straggler_factor * self._ewma:
            self.straggler_steps.append((self.step, dt, self._ewma))
            log.warning("straggler step %d: %.3fs vs EWMA %.3fs "
                        "(mitigation signal at fleet scale: mark host slow, "
                        "request reassignment)", self.step, dt, self._ewma)
        a = self.tcfg.ewma_alpha
        self._ewma = (1 - a) * self._ewma + a * dt

    # -- main loop --------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        self.maybe_resume()
        every = self.tcfg.ckpt_every
        while self.step < self.tcfg.total_steps:
            if self.tcfg.failure_at is not None and \
                    self.step == self.tcfg.failure_at:
                raise InjectedFailure(f"injected failure at step {self.step}")
            batch = next(self.data_iter)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            if any(torch.is_tensor(v) and v.is_cuda
                   for v in metrics.values()):
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            self._watch(dt)
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or \
                    self.step == self.tcfg.total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=self.step, dt=dt)
                self.metrics_history.append(m)
                log.info("step %d loss=%.4f dt=%.3fs", self.step,
                         m.get("loss", float("nan")), dt)
            if every and self.step % every == 0:
                self.save()
        if every:
            self.save()
        return {"step": self.step, "metrics": self.metrics_history,
                "stragglers": self.straggler_steps}
