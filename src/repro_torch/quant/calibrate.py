"""Symmetric int8 quantization and the kv8 cache wire format (the port of
``repro.quant.calibrate``, the part the kv8 cache uses).

x -> round(x / scale) clipped to [-127, 127], with the scale the absmax of
the reduced axes over 127. All math is float32 whatever the input dtype (a
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
