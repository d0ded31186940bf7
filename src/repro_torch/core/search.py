"""Search over a config space (subset of ``repro.core.search``).

Strategies speak the reference's ask/tell protocol, so the random,
evolutionary and successive-halving strategies fit in unchanged:

    strategy.reset(space, ctx)
    while not strategy.finished():
        batch = strategy.suggest(n)
        strategy.observe([Trial(cfg, measure(cfg)) for cfg in batch])
    result = strategy.result()

``run()`` evaluates one config at a time. The port has
``ExhaustiveSearch``: every valid config, once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

from repro_torch.core.config_space import Config, ConfigSpace, TuningContext

Evaluator = Callable[[Config], float]


@dataclasses.dataclass
class Trial:
    config: Config
    metric: float            # seconds per call; inf == failed

    def ok(self) -> bool:
        return math.isfinite(self.metric)


@dataclasses.dataclass
class SearchResult:
    best: Optional[Config]
    best_metric: float
    trials: List[Trial]
    evaluations: int


def _cfg_key(cfg: Config) -> Tuple:
    return tuple(sorted((k, repr(v)) for k, v in cfg.items()))


def _finish(trials: List[Trial]) -> SearchResult:
    ok = [t for t in trials if t.ok()]
    if not ok:
        return SearchResult(None, math.inf, trials, len(trials))
    best = min(ok, key=lambda t: t.metric)
    return SearchResult(dict(best.config), best.metric, trials, len(trials))


class SearchStrategy:
    """Ask/tell bookkeeping; subclasses fill ``_pending`` in ``_start``."""

    name = "base"

    def reset(self, space: ConfigSpace, ctx: TuningContext) -> None:
        self.space = space
        self.ctx = ctx
        self.trials: List[Trial] = []
        self._pending: List[Config] = []
        self._outstanding = 0
        self._start()

    def suggest(self, n: int = 1) -> List[Config]:
        take, self._pending = self._pending[:n], self._pending[n:]
        self._outstanding += len(take)
        return [dict(c) for c in take]

    def observe(self, trials: List[Trial]) -> None:
        self.trials.extend(trials)
        self._outstanding -= len(trials)
        if self._outstanding < 0:
            raise RuntimeError(
                f"{self.name}: observed more trials than suggested")

    def finished(self) -> bool:
        return not self._pending and self._outstanding == 0

    def result(self) -> SearchResult:
        return _finish(self.trials)

    def _start(self) -> None:
        raise NotImplementedError

    def run(self, space: ConfigSpace, ctx: TuningContext,
            evaluate: Evaluator) -> SearchResult:
        self.reset(space, ctx)
        while not self.finished():
            self.observe([Trial(cfg, evaluate(cfg))
                          for cfg in self.suggest(1)])
        return self.result()


class ExhaustiveSearch(SearchStrategy):
    """Evaluate every valid config (the Triton autotuner's mode)."""

    name = "exhaustive"

    def _start(self) -> None:
        self._pending = self.space.valid_configs(self.ctx)
