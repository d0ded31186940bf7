"""The card being tuned for, as the autotuner sees it.

``current_chip()`` builds a ``ChipSpec`` for the present CUDA card from
``torch.cuda.get_device_properties``: name, SM count, shared memory a block
can opt into, L2 size, device memory. The peak rates are not readable from
the card, so they come from NVIDIA's data sheets, picked by the part: an
H100 with 132 SMs is the SXM part, one with 114 the PCIe part. Those peaks
assume the card's full power limit; ``nvidia-smi`` reports the limit a
card is actually set to.

``get_chip(name)`` gives the data-sheet spec of a card by the name
``chip_from_properties`` builds ("<device name> (SXM)" or "(PCIe)"), the
name every tuning key carries: with it a CPU test rebuilds the context of
a shipped DB key, as the reference's ``get_chip`` does for its TPUs.

``cpu_host()`` is the spec the CPU tests use: the port never measures or
tunes on the CPU, but shapes and spaces are checked there.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    sm_count: int
    smem_per_block: int         # bytes a block may opt into
    l2_bytes: int
    hbm_bytes: int
    hbm_bandwidth: float        # B/s, data sheet
    peak_bf16_flops: float      # dense tensor-core FLOP/s, data sheet
    peak_fp32_flops: float      # CUDA-core FLOP/s, data sheet
    peak_int8_ops: float        # dense tensor-core int8 OP/s, data sheet

    def flops_for_dtype(self, dtype_name: str) -> float:
        """Peak rate for work on operands of ``dtype_name``: int8 operands
        (the w8a8 GEMM) at the int8 tensor-core rate, twice bf16's."""
        if dtype_name in ("bfloat16", "float16"):
            return self.peak_bf16_flops
        if dtype_name == "float32":
            return self.peak_fp32_flops
        if dtype_name == "int8":
            return self.peak_int8_ops
        raise KeyError(f"no peak rate for dtype {dtype_name!r}")


# NVIDIA H100 data sheet (dense rates, no sparsity), keyed by SM count.
_H100_PEAKS = {
    132: dict(part="SXM", hbm_bandwidth=3.35e12, peak_bf16_flops=989e12,
              peak_fp32_flops=67e12, peak_int8_ops=1979e12),
    114: dict(part="PCIe", hbm_bandwidth=2.0e12, peak_bf16_flops=756e12,
              peak_fp32_flops=51e12, peak_int8_ops=1513e12),
}


def chip_from_properties(name: str, sm_count: int, smem_per_block: int,
                         l2_bytes: int, hbm_bytes: int) -> ChipSpec:
    if "H100" not in name or sm_count not in _H100_PEAKS:
        raise KeyError(f"no data-sheet peaks for {name!r} with {sm_count} "
                       "SMs (known: H100 SXM 132, H100 PCIe 114)")
    peaks = dict(_H100_PEAKS[sm_count])
    part = peaks.pop("part")
    return ChipSpec(name=f"{name} ({part})", sm_count=sm_count,
                    smem_per_block=smem_per_block, l2_bytes=l2_bytes,
                    hbm_bytes=hbm_bytes, **peaks)


# What an H100 of either part lets one block and the card hold (data sheet):
# 227 KB of shared memory a block opts into, a 50 MB L2, 80 GB of HBM.
_H100_SMEM_PER_BLOCK = 232448
_H100_L2_BYTES = 50 * 2**20
_H100_HBM_BYTES = 80 * 10**9


def get_chip(name: str) -> ChipSpec:
    """The data-sheet spec of the card ``name`` names, as
    ``chip_from_properties`` names it. The name, the peaks and the
    shared-memory limit (what a key and a space's validity read) equal
    ``current_chip()``'s on that card; the L2 and device memory are the
    data sheet's, not the card's own readings."""
    for sm_count, peaks in _H100_PEAKS.items():
        suffix = f" ({peaks['part']})"
        if "H100" in name and name.endswith(suffix):
            return chip_from_properties(
                name[:-len(suffix)], sm_count, _H100_SMEM_PER_BLOCK,
                _H100_L2_BYTES, _H100_HBM_BYTES)
    raise KeyError(f"no data-sheet spec for chip {name!r} (known: H100 "
                   "\"... (SXM)\" and \"... (PCIe)\")")


def current_chip(device=None) -> ChipSpec:
    """Spec of the CUDA card ``device`` (default: the current one)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tuner measures on the card")
    props = torch.cuda.get_device_properties(device)
    smem = getattr(props, "shared_memory_per_block_optin", 232448)
    return chip_from_properties(props.name, props.multi_processor_count,
                                smem, props.L2_cache_size,
                                props.total_memory)


def cpu_host() -> ChipSpec:
    """Placeholder spec for CPU tests; not a measurement target."""
    return ChipSpec(name="cpu_host", sm_count=1, smem_per_block=232448,
                    l2_bytes=50 * 2**20, hbm_bytes=32 * 2**30,
                    hbm_bandwidth=20e9, peak_bf16_flops=5e10,
                    peak_fp32_flops=5e10, peak_int8_ops=1e11)
