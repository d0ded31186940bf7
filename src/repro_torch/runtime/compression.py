"""Int8 error-feedback gradient compression (``repro.runtime.compression``).

Gradients are quantized to int8 with one per-tensor scale (per leaf of
the reference's stacked tree), and the quantization error is carried
into the next step's gradients (error feedback keeps SGD/Adam
convergence — Karimireddy et al. 2019).
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


def _quantize(x: torch.Tensor,
              absmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = absmax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress(grads: Tree, ef_state: Tree,
                groups: Dict[str, str]) -> Tuple[Tree, Tree]:
    """Quantize(g + e) with error feedback. Returns (g_hat, new_ef_state):
    g_hat in each gradient's dtype, the new error in f32. ``groups`` maps
    each name to the tensor its scale spans: the reference scales each
    leaf of its stacked tree once, over all the layers stacked in it
    (``models.param.reference_leaves``)."""
    absmax: Dict[str, torch.Tensor] = {}
    for name, g in grads.items():
        m = torch.max(torch.abs(g.float() + ef_state[name]))
        key = groups[name]
        absmax[key] = m if key not in absmax else torch.maximum(absmax[key],
                                                                m)
    out, new_ef = {}, {}
    for name, g in grads.items():
        gf = g.float() + ef_state[name]
        q, scale = _quantize(gf, absmax[groups[name]])
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
