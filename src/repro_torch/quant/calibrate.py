"""Symmetric int8 quantization and the kv8 cache wire format (the port of
``repro.quant.calibrate``).

x -> round(x / scale) clipped to [-127, 127], with the scale the absmax of
the reduced axes over 127 (``absmax_scale``), or for weights calibrated
offline the P-th percentile of |x| over 127 (``percentile_scale``). All
math is float32 whatever the input dtype (a
bfloat16 input is cast first); ``round`` is half to even, as ``jnp.round``
is, so the port writes the reference's bytes. Scales are clamped to a tiny
positive floor so an all-zero row quantizes to zeros, not NaNs.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

QMAX = 127.0          # symmetric int8 range (-127..127; -128 unused)
_SCALE_FLOOR = 1e-8

Axis = Union[None, int, Tuple[int, ...]]


def absmax_scale(x: torch.Tensor, axis: Axis = None) -> torch.Tensor:
    """Symmetric absmax scale over ``axis`` (kept dims, float32)."""
    a = x.float().abs()
    a = a.amax(dim=axis, keepdim=True) if axis is not None else \
        a.amax().reshape((1,) * x.dim())
    return torch.clamp(a, min=_SCALE_FLOOR) / QMAX


def _reduced_last(x: torch.Tensor, axis: Axis) -> Tuple[torch.Tensor,
                                                        Tuple[int, ...]]:
    """``x`` with the kept axes first and the reduced ones flattened into
    the last, and the kept-dims shape of a reduction over ``axis``."""
    if axis is None:
        return x.reshape(-1), (1,) * x.dim()
    axes = sorted({a % x.dim() for a in
                   ((axis,) if isinstance(axis, int) else axis)})
    keep = [d for d in range(x.dim()) if d not in axes]
    moved = x.permute(*keep, *axes)
    flat = moved.reshape(*[x.shape[d] for d in keep], -1)
    return flat, tuple(1 if d in axes else x.shape[d]
                       for d in range(x.dim()))


def percentile_scale(x: torch.Tensor, pct: float = 99.9,
                     axis: Axis = None) -> torch.Tensor:
    """P-th percentile of |x| over ``axis`` (kept dims, float32), linearly
    interpolated between the two nearest order statistics in float32 as
    ``jnp.percentile`` computes it (low * (1 - w) + high * w)."""
    if not 0.0 < pct <= 100.0:
        raise ValueError(f"percentile must be in (0, 100], got {pct}")
    flat, shape = _reduced_last(x.float().abs(), axis)
    s = torch.sort(flat, dim=-1).values
    n = s.shape[-1]
    q = (torch.tensor(pct, dtype=torch.float32) / 100.0) * float(n - 1)
    low = torch.floor(q)
    high_w = q - low
    lo, hi = (int(torch.clamp(v, 0, n - 1)) for v in (low, torch.ceil(q)))
    a = s[..., lo] * (1.0 - high_w) + s[..., hi] * high_w
    return torch.clamp(a.reshape(shape), min=_SCALE_FLOOR) / QMAX


def compute_scale(x: torch.Tensor, *, method: str = "absmax",
                  axis: Axis = None, percentile: float = 99.9
                  ) -> torch.Tensor:
    if method == "absmax":
        return absmax_scale(x, axis=axis)
    if method == "percentile":
        return percentile_scale(x, percentile, axis=axis)
    raise ValueError(f"unknown calibration method {method!r} "
                     "(absmax | percentile)")


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x -> int8 on the symmetric grid defined by ``scale`` (broadcast)."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_dynamic(x: torch.Tensor, axis: Optional[Axis] = -1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass dynamic quantization (KV tokens at runtime): absmax over
    ``axis``, then quantize. Returns (int8 values, f32 scale with kept
    dims)."""
    scale = absmax_scale(x, axis=axis)
    return quantize(x, scale), scale


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """The kv8 cache wire format: per-token-per-head symmetric int8 with
    the channel axis reduced and the kept dim stripped. k, v (..., D) ->
    (k int8, k_scale (...,), v int8, v_scale (...,)). The cache-append
    paths (``models.attention``) and the tuner's operands
    (``kernels.ops``) both quantize through here, so what the tuner times
    is byte for byte what serving reads."""
    kq, ks = quantize_dynamic(k, axis=-1)
    vq, vs = quantize_dynamic(v, axis=-1)
    return kq, ks[..., 0], vq, vs[..., 0]
