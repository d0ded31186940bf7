"""Kernel registry (the port's ``repro.kernels.registry``): the one place
every consumer discovers the tunable kernels from.

A kernel registers once, as a ``KernelSpec`` bundling

  * ``tunable``     — the ``TunableKernel`` (Hopper space, workload, runner,
                      heuristic) the autotuner consumes,
  * ``scenarios``   — tags ("decode", "serving", "paged", ...) so callers
                      can ask for "every decode kernel",
  * ``reference``   — the plain PyTorch version in ``kernels.ref``,
  * ``entry_point`` — the autotuned public function in ``kernels.ops``,
  * ``operands``    — ``(ctx, config, device) -> (args, kwargs)`` building
                      inputs that both ``entry_point`` and ``reference``
                      take, for the oracle sweep (``chip_smoke.py`` runs it
                      on the card over every valid config of every host
                      bench case),
  * ``bench_cases`` — canonical workloads at two scales, ``"host"`` (small)
                      and ``"paper"`` (production shapes),
  * ``precision``   — "float" or "int8", the numerics family.

Names, scenarios and bench cases are the reference's, so cache keys and the
registry read the same in both packages. Registration happens at import of
``repro_torch.kernels.ops``; this module imports it on first use. Duplicate
names are refused. ``tuning_pairs`` lists every (kernel, bench-case
context) for a chip and ``warm_start`` tunes them through
``Autotuner.tune_many``, as the reference's do.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.config_space import ConfigSpace, TuningContext
from repro_torch.core.hardware import ChipSpec
from repro_torch.core.tuner import TunableKernel


@dataclasses.dataclass(frozen=True)
class BenchCase:
    """One canonical workload of a kernel."""

    label: str
    shapes: Mapping[str, Tuple[int, ...]]
    dtype: str = "float32"
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    scale: str = "host"            # "host" | "paper"

    def context(self, chip: ChipSpec) -> TuningContext:
        return TuningContext(chip=chip, shapes=dict(self.shapes),
                             dtype=self.dtype, extra=dict(self.extra))


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Everything the rest of the system needs to know about one kernel."""

    tunable: TunableKernel
    scenarios: Tuple[str, ...]
    reference: Optional[Callable[..., Any]] = None
    entry_point: Optional[Callable[..., Any]] = None
    bench_cases: Tuple[BenchCase, ...] = ()
    description: str = ""
    precision: str = "float"
    operands: Optional[Callable[..., Tuple[tuple, dict]]] = None

    @property
    def name(self) -> str:
        return self.tunable.name

    @property
    def space(self) -> ConfigSpace:
        return self.tunable.space

    def cases(self, scale: Optional[str] = None) -> Tuple[BenchCase, ...]:
        if scale is None:
            return self.bench_cases
        return tuple(c for c in self.bench_cases if c.scale == scale)


_LOCK = threading.Lock()
_REGISTRY: Dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    """Add a kernel to the registry. Refuses duplicate names."""
    if not isinstance(spec, KernelSpec):
        raise TypeError(f"register() takes a KernelSpec, got {type(spec)!r}")
    if not spec.scenarios:
        raise ValueError(f"kernel {spec.name!r} declares no scenarios")
    with _LOCK:
        if spec.name in _REGISTRY:
            raise ValueError(
                f"kernel {spec.name!r} is already registered; "
                "unregister() it first or pick another name")
        _REGISTRY[spec.name] = spec
    return spec


def unregister(name: str) -> None:
    """Remove a kernel (tests register throwaway kernels)."""
    with _LOCK:
        _REGISTRY.pop(name, None)


def get_kernel(name: str) -> KernelSpec:
    _ensure_builtins()
    with _LOCK:
        try:
            return _REGISTRY[name]
        except KeyError:
            known = ", ".join(sorted(_REGISTRY)) or "<empty>"
            raise KeyError(
                f"no kernel {name!r} in the registry (known: {known})"
            ) from None


def list_kernels(scenario: Optional[str] = None,
                 precision: Optional[str] = None) -> List[KernelSpec]:
    """All registered kernels, name-sorted; optionally only those with a
    scenario tag and/or of a precision family."""
    _ensure_builtins()
    with _LOCK:
        specs = sorted(_REGISTRY.values(), key=lambda s: s.name)
    if scenario is not None:
        specs = [s for s in specs if scenario in s.scenarios]
    if precision is not None:
        specs = [s for s in specs if s.precision == precision]
    return specs


def kernel_names(scenario: Optional[str] = None,
                 precision: Optional[str] = None) -> List[str]:
    return [s.name for s in list_kernels(scenario, precision)]


def scenarios() -> List[str]:
    """Every scenario tag any kernel declares."""
    tags = set()
    for s in list_kernels():
        tags.update(s.scenarios)
    return sorted(tags)


def _ensure_builtins() -> None:
    """Importing ``kernels.ops`` registers the built-in kernels."""
    from repro_torch.kernels import ops  # noqa: F401  (import side effect)


# ---------------------------------------------------------------------------
# Registry-driven batch tuning (warm start)
# ---------------------------------------------------------------------------

def tuning_pairs(chip: ChipSpec, scale: Optional[str] = None,
                 scenario: Optional[str] = None
                 ) -> List[Tuple[str, TunableKernel, TuningContext]]:
    """Every labelled (kernel, context) pair the registry's bench cases
    define for a chip — the work-list for ``Autotuner.tune_many``. Labels
    are "<kernel>/<case label>", as the reference's."""
    pairs: List[Tuple[str, TunableKernel, TuningContext]] = []
    for spec in list_kernels(scenario):
        for case in spec.cases(scale):
            pairs.append((f"{spec.name}/{case.label}", spec.tunable,
                          case.context(chip)))
    return pairs


def warm_start(tuner, chip: ChipSpec, scale: Optional[str] = "host",
               scenario: Optional[str] = None) -> Dict[str, Any]:
    """Tune the registry's bench cases through ``tuner.tune_many`` so a
    deployment starts with a populated cache instead of tuning on the
    serving path. Returns ``{"<kernel>/<case label>": CacheEntry |
    Exception}``."""
    triples = tuning_pairs(chip, scale=scale, scenario=scenario)
    entries = tuner.tune_many([(k, ctx) for _, k, ctx in triples],
                              return_exceptions=True)
    return {label: e for (label, _, _), e in zip(triples, entries)}
