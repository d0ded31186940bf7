"""Shared model layers: RMS norm, RoPE, the swiglu MLP, embeddings.

All math runs in the input dtype with fp32 reductions; norm weights are
fp32. ``impl="kernel"`` routes the RMS norm through the autotuned Triton
kernel (``kernels.ops.rmsnorm``) with the weight cast to ``x.dtype`` first,
as the reference does on its Pallas path; ``impl="plain"`` is the PyTorch
version, which is what the kernel's wrapper also runs on CPU tensors.
The MLP's projections may be ``QTensor``s (the w8a8 policy,
``quant.quantize_params``): ``_proj`` dispatches them to ``qmatmul``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec, empty_parameter, torch_dtype
from repro_torch.quant.qtensor import QTensor, qmatmul


class _Params(nn.Module):
    """A module whose parameters are declared by ``param_specs``."""

    def __init__(self, specs, device):
        super().__init__()
        self.param_specs = dict(specs)
        for name, spec in self.param_specs.items():
            setattr(self, name, empty_parameter(spec, device))


# --- norms ------------------------------------------------------------------

class Norm(_Params):
    def __init__(self, cfg: ModelConfig, device):
        if cfg.norm != "rms":
            raise NotImplementedError(f"norm {cfg.norm!r}: the port has rms")
        super().__init__({"w": ParamSpec((cfg.d_model,), torch.float32,
                                         "ones")}, device)


def apply_norm(p: Norm, x: torch.Tensor, cfg: ModelConfig, *,
               eps: float = 1e-6, impl: str = "plain") -> torch.Tensor:
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        return kops.rmsnorm(x, p.w.to(x.dtype), eps=eps)
    if impl != "plain":
        raise ValueError(f"norm impl {impl!r}")
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p.w).to(x.dtype)


# --- rotary position embeddings ----------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, D) rotated by positions (S,) or (B, S)."""
    D = x.shape[-1]
    half = D // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq             # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                    # head axis
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- feed-forward --------------------------------------------------------------

class MLP(_Params):
    def __init__(self, cfg: ModelConfig, device, d_ff: Optional[int] = None):
        if cfg.act != "swiglu":
            raise NotImplementedError(f"act {cfg.act!r}: the port has swiglu")
        d, f = cfg.d_model, d_ff or cfg.d_ff
        dt = torch_dtype(cfg.dtype)
        super().__init__({"wi": ParamSpec((d, 2 * f), dt),
                          "wo": ParamSpec((f, d), dt)}, device)


def _proj(x: torch.Tensor, w, quant_impl: str = "sim") -> torch.Tensor:
    """x @ w, where w may be a quantized ``QTensor``: dispatch keys off the
    weight's type, so every MLP call site quantizes alike."""
    if isinstance(w, QTensor):
        return qmatmul(x, w, impl=quant_impl)
    return x @ w


def apply_mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig, *,
              quant_impl: str = "sim") -> torch.Tensor:
    g, u = torch.chunk(_proj(x, p.wi, quant_impl), 2, dim=-1)
    h = F.silu(g.float()).to(x.dtype) * u
    return _proj(h, p.wo, quant_impl)


# --- embeddings ----------------------------------------------------------------

class Embed(_Params):
    def __init__(self, cfg: ModelConfig, device):
        if cfg.learned_pos or cfg.logit_softcap:
            raise NotImplementedError(
                "learned positions and logit softcaps: not in the port")
        dt = torch_dtype(cfg.dtype)
        specs = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), dt,
                                  "normal", 1.0)}
        if not cfg.tie_embeddings:
            specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size), dt)
        super().__init__(specs, device)


def embed_tokens(p: Embed, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return p.tok[tokens]


def logits_out(p: Embed, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits; tied embeddings reuse ``tok`` transposed."""
    out = h @ (p.tok.T.to(h.dtype) if cfg.tie_embeddings else p.unembed)
    return out.float()
