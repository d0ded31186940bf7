"""Paged continuous-batching serving of the port."""

from repro_torch.serving.drafter import NgramDrafter
from repro_torch.serving.page_pool import SCRATCH_PAGE, PagePool
from repro_torch.serving.scheduler import (
    Request, RequestState, Scheduler, ServingEngine, StepStats,
    latency_summary,
)

__all__ = ["NgramDrafter", "PagePool", "Request", "RequestState",
           "SCRATCH_PAGE", "Scheduler", "ServingEngine", "StepStats",
           "latency_summary"]
