"""What a kernel call must move and compute, and the least time it can take
(subset of ``repro.core.costmodel``).

A ``KernelWorkload`` counts a call's HBM bytes (each input read once, each
output written once, for the data this call actually has) and its
operations. ``roofline_seconds`` is the larger of bytes over the card's
memory rate and operations over its peak for the operand type; it is the
bound a measured kernel time is held against, never a substitute for one.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.hardware import ChipSpec


@dataclasses.dataclass(frozen=True)
class KernelWorkload:
    flops: float            # operations the call performs
    hbm_bytes: float        # bytes it must read and write
    dtype: str = "bfloat16"  # operand type, picks the peak rate


def roofline_seconds(w: KernelWorkload, chip: ChipSpec) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations" — whichever bounds it)."""
    t_bytes = w.hbm_bytes / chip.hbm_bandwidth
    t_ops = w.flops / chip.flops_for_dtype(w.dtype)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
