"""Int8 error-feedback gradient compression (``repro.runtime.compression``).

Gradients are quantized to int8 with one per-tensor scale, and the
quantization error is carried into the next step's gradients (error
feedback keeps SGD/Adam convergence — Karimireddy et al. 2019).
``ef_compress`` is the quantize/dequantize transform the train step
applies, which models the numerics of the int8 wire format on one card.
The reference's ``compressed_psum_mean``, the collective that carries the
int8 payload across data-parallel devices, waits for the port's
multi-device path and is refused by name.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress(grads: Tree, ef_state: Tree) -> Tuple[Tree, Tree]:
    """Quantize(g + e) with error feedback. Returns (g_hat, new_ef_state):
    g_hat in each gradient's dtype, the new error in f32."""
    out, new_ef = {}, {}
    for name, g in grads.items():
        gf = g.float() + ef_state[name]
        q, scale = _quantize(gf)
        deq = q.float() * scale
        out[name] = deq.to(g.dtype)
        new_ef[name] = gf - deq
    return out, new_ef


def init_ef_state(params: Tree) -> Tree:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compressed_psum_mean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    raise NotImplementedError(
        "compressed_psum_mean: the int8 all-reduce across data-parallel "
        "devices waits for the port's multi-device path")
