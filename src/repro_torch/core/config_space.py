"""Kernel configuration spaces (subset of ``repro.core.config_space``).

  * ``Param`` — one named, finite-domain tunable.
  * ``ConfigSpace`` — a product of Params plus named *constraints*
    (predicates over a config and a tuning context) for parameter
    dependencies and for what the card can hold.
  * ``TuningContext`` — the shape/dtype/card situation being tuned for.
  * ``smem_fits`` — the card's validity rule, in place of the TPU's
    ``vmem_fits``: a config's shared memory must fit one block's opt-in
    limit.

``valid_configs`` is memoized per space, keyed on the identity of every
constraint function as well as the context: two spaces whose constraints
share a name but not a predicate never share an enumeration (the
reference keys its memo on names only and returns one space's valid set
for the other).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import threading
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

from repro_torch.core.hardware import ChipSpec

Config = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Param:
    """A single tunable with a finite ordered domain."""

    name: str
    values: Tuple[Any, ...]

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"Param {self.name!r} has an empty domain")
        if len(set(map(repr, self.values))) != len(self.values):
            raise ValueError(f"Param {self.name!r} has duplicate values")


@dataclasses.dataclass(frozen=True)
class TuningContext:
    """Everything a constraint may condition on besides the config."""

    chip: ChipSpec
    shapes: Mapping[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    dtype: str = "bfloat16"
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.shapes[name])

    def signature(self) -> str:
        """Stable string identifying the tuning scenario (cache key part)."""
        return json.dumps({
            "chip": self.chip.name,
            "shapes": {k: list(v) for k, v in sorted(self.shapes.items())},
            "dtype": self.dtype,
            "extra": {k: self.extra[k] for k in sorted(self.extra)},
        }, sort_keys=True)


Constraint = Callable[[Config, TuningContext], bool]

_VALID_MEMO_MAX = 128


class ConfigSpace:
    """Product space of Params filtered by named constraints."""

    def __init__(self, name: str, params: Sequence[Param], version: int = 1):
        self.name = name
        self.params: Tuple[Param, ...] = tuple(params)
        names = [p.name for p in self.params]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate param in space {name!r}: {names}")
        self.version = version
        self._constraints: List[Tuple[str, Constraint]] = []
        self._memo: Dict[Tuple, List[Config]] = {}
        self._memo_lock = threading.Lock()

    def constrain(self, name: str, fn: Constraint) -> "ConfigSpace":
        self._constraints.append((name, fn))
        return self

    def space_hash(self) -> str:
        """Identity of the space's definition for the persistent cache:
        name, version, domains and constraint names."""
        payload = {
            "name": self.name,
            "version": self.version,
            "params": [[p.name, [repr(v) for v in p.values]]
                       for p in self.params],
            "constraints": [n for n, _ in self._constraints],
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]

    def is_valid(self, config: Config, ctx: TuningContext) -> bool:
        return self.why_invalid(config, ctx) is None

    def why_invalid(self, config: Config,
                    ctx: TuningContext) -> Optional[str]:
        """Name of the first violated constraint, or None if valid. A
        constraint that raises on a config rejects it."""
        for p in self.params:
            if config.get(p.name) not in p.values:
                return f"param:{p.name}"
        for cname, fn in self._constraints:
            try:
                ok = bool(fn(config, ctx))
            except (ArithmeticError, KeyError, TypeError, ValueError):
                ok = False
            if not ok:
                return cname
        return None

    def iter_all(self) -> Iterator[Config]:
        names = [p.name for p in self.params]
        for combo in itertools.product(*[p.values for p in self.params]):
            yield dict(zip(names, combo))

    def iter_valid(self, ctx: TuningContext) -> Iterator[Config]:
        for cfg in self.iter_all():
            if self.is_valid(cfg, ctx):
                yield cfg

    def valid_configs(self, ctx: TuningContext) -> List[Config]:
        """Memoized enumeration of the valid configs (fresh copies)."""
        key = (tuple(id(fn) for _, fn in self._constraints), ctx.signature())
        with self._memo_lock:
            cached = self._memo.get(key)
        if cached is None:
            cached = list(self.iter_valid(ctx))
            with self._memo_lock:
                if len(self._memo) >= _VALID_MEMO_MAX:
                    self._memo.pop(next(iter(self._memo)))
                self._memo[key] = cached
        return [dict(c) for c in cached]

    def default(self, ctx: TuningContext) -> Config:
        """First valid config in enumeration order."""
        for cfg in self.iter_valid(ctx):
            return cfg
        raise ValueError(
            f"space {self.name!r} has no valid config for {ctx.signature()}")


def dtype_bytes(dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1,
            "int32": 4}[dtype]


def smem_fits(estimator: Callable[[Config, TuningContext], int]
              ) -> Constraint:
    """The shared memory ``estimator`` gives a config must fit the card's
    per-block opt-in limit — what makes a config valid on one card and
    not on another, as VMEM did across TPU generations."""

    def fn(cfg: Config, ctx: TuningContext) -> bool:
        return estimator(cfg, ctx) <= ctx.chip.smem_per_block

    return fn
