"""Quantization dtype policies (the port of ``repro.quant.policy``): the
named numerics contracts of quantized serving.

A policy names which tensor classes drop to int8. Each named policy is its
own tuning family: the kernels it runs tune under their own context dtype
(``"int8"`` for the kv8 cache), so two policies never share a tuned entry.

    w8a8   — int8 weights and int8 activations for the MLP projections;
    w8a16  — int8 weights dequantized into the activation dtype;
    kv8    — int8 KV cache with per-token-per-head f32 scales, dequantized
             inside the decode kernel (``gqa_decode_kv8`` on dense caches,
             the int8 branches of ``paged_decode`` and ``paged_verify``
             on page pools).

The port serves ``kv8`` on the dense and the paged path, plain or
speculative; the weight policies are a later slice of the port (the
launcher refuses them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """One named quantization contract."""

    name: str
    weights: Optional[str] = None     # "int8" | None — MLP projection weights
    acts: Optional[str] = None        # "int8" | None — dynamic per-token
    kv: Optional[str] = None          # "int8" | None — KV cache entries
    method: str = "absmax"            # weight calibration: absmax | percentile
    percentile: float = 99.9          # used when method == "percentile"

    @property
    def quantizes_weights(self) -> bool:
        return self.weights is not None

    @property
    def quantizes_acts(self) -> bool:
        return self.acts is not None

    @property
    def quantizes_kv(self) -> bool:
        return self.kv is not None

    @property
    def kv_dtype(self) -> Optional[str]:
        return self.kv


POLICIES: Dict[str, QuantPolicy] = {
    "w8a8": QuantPolicy(name="w8a8", weights="int8", acts="int8"),
    "w8a16": QuantPolicy(name="w8a16", weights="int8"),
    "kv8": QuantPolicy(name="kv8", kv="int8"),
}


def get_policy(name: Optional[str]) -> Optional[QuantPolicy]:
    """Resolve a policy name; ``None``/``"none"`` mean full precision."""
    if name is None or name == "none":
        return None
    if isinstance(name, QuantPolicy):
        return name
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown quant policy {name!r}; known: {sorted(POLICIES)} "
            "(or 'none')") from None
