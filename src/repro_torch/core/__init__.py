"""Autotuning core of the port: spaces, measurement, search, cache, tuner."""

from repro_torch.core.cache import CacheEntry, TuningCache
from repro_torch.core.config_space import (
    Config, ConfigSpace, Param, TuningContext, smem_fits,
)
from repro_torch.core.costmodel import KernelWorkload, roofline_seconds
from repro_torch.core.hardware import (
    ChipSpec, cpu_host, current_chip, get_chip,
)
from repro_torch.core.measure import CudaEventTimer, KernelRunner
from repro_torch.core.search import ExhaustiveSearch, SearchResult, Trial
from repro_torch.core.tuner import (
    Autotuner, TunableKernel, default_tuner, set_default_tuner,
)

__all__ = [
    "Autotuner", "CacheEntry", "ChipSpec", "Config", "ConfigSpace",
    "CudaEventTimer", "ExhaustiveSearch", "KernelRunner", "KernelWorkload",
    "Param", "SearchResult", "Trial", "TunableKernel", "TuningCache",
    "TuningContext", "cpu_host", "current_chip", "default_tuner", "get_chip",
    "roofline_seconds", "set_default_tuner", "smem_fits",
]
