"""Mixture-of-Experts layer (olmoe / deepseek-v2): the reference's
``index`` dispatch (``repro.models.moe.apply_moe``) in plain torch ops.

Capacity-bounded dispatch: each (token, choice) pair of a batch row is
ranked within its expert's bucket in token order; pairs ranked past the
expert's capacity C (per batch row: max(4, ⌈S·k·capacity_factor/E⌉ to a
multiple of 4)) are dropped and contribute 0. Each expert runs its swiglu
FFN over a dense (B, C, d) buffer, so every expert's weights are read on
every call, as in the reference. Shared experts (deepseek) run as one MLP
of width ``d_ff_expert · n_shared_experts`` over every token.

The reference's other dispatches (``apply_moe_einsum``, the one-hot
oracle, and ``apply_moe_shmap``, expert parallelism) are not ported. The
Switch load-balance loss is returned, as the reference returns it;
serving does not use it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, _Params, apply_mlp
from repro_torch.models.param import ParamSpec, torch_dtype


class MoE(_Params):
    """The router (f32), the experts' stacked ``wi`` (E, d, 2f) and ``wo``
    (E, f, d), and the shared experts' MLP (``shared``), named as the
    reference's tree."""

    def __init__(self, cfg: ModelConfig, device):
        if cfg.act != "swiglu":
            raise NotImplementedError(f"act {cfg.act!r}: the port has swiglu")
        m = cfg.moe
        d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
        dt = torch_dtype(cfg.dtype)
        super().__init__({"router": ParamSpec((d, E), torch.float32),
                          "wi": ParamSpec((E, d, 2 * f), dt),
                          "wo": ParamSpec((E, f, d), dt)}, device)
        if m.n_shared_experts:
            self.shared = MLP(cfg, device, f * m.n_shared_experts)


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots an expert has per batch row: S·k·capacity_factor/E, rounded
    up to a multiple of 4, at least 4."""
    m = cfg.moe
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.n_experts)
    return max(4, -(-c // 4) * 4)


def route(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x (..., d) → (weights (..., k), expert ids (..., k), probs (..., E)):
    the top-k of the router's f32 softmax, renormalised to sum to 1 under
    ``norm_topk``."""
    m = cfg.moe
    probs = torch.softmax(x.float() @ p.router, dim=-1)
    vals, idx = torch.topk(probs, m.top_k, dim=-1)
    if m.norm_topk:
        vals = vals / torch.sum(vals, dim=-1, keepdim=True)
    return vals, idx, probs


def aux_loss(probs: torch.Tensor, idx: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """Switch load-balance loss: E · Σ_e f_e · P_e, f_e the share of
    tokens whose first choice is e."""
    E = cfg.moe.n_experts
    assign = F.one_hot(idx[..., 0], E).float()
    f_e = assign.reshape(-1, E).mean(0)
    p_e = probs.reshape(-1, E).mean(0)
    return E * torch.sum(f_e * p_e)


def rank_in_expert(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Rank of each (token, choice) pair within its expert's bucket, per
    batch row, in pair order: the number of earlier pairs of the row that
    chose the same expert (the reference's stable-sort rank)."""
    onehot = F.one_hot(flat_e, E)                            # (B, Sk, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    return torch.gather(before, 2, flat_e[..., None])[..., 0]


def apply_moe(p: MoE, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index-dispatch MoE. x (B, S, d) → (out (B, S, d), aux loss)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    C = capacity(cfg, S)
    w, idx, probs = route(p, x, cfg)                         # (B, S, k)
    flat_e = idx.reshape(B, S * k)
    rank = rank_in_expert(flat_e, E)
    keep = rank < C
    dest = torch.where(keep, flat_e * C + rank, E * C)       # E·C: dropped
    xk = torch.repeat_interleave(x, k, dim=1)                # (B, S·k, d)
    # kept pairs land on distinct slots; dropped ones share the extra slot,
    # which is cut off
    buf = x.new_zeros(B, E * C + 1, d)
    buf.scatter_(1, dest[..., None].expand(-1, -1, d), xk)
    buf = buf[:, :E * C].reshape(B, E, C, d)
    h = torch.einsum("becd,edf->becf", buf, p.wi)
    g, u = torch.chunk(h, 2, dim=-1)
    h = F.silu(g.float()).to(x.dtype) * u
    out_buf = torch.einsum("becf,efd->becd", h, p.wo).reshape(B, E * C, d)
    gathered = torch.gather(
        out_buf, 1,
        torch.clamp(dest, max=E * C - 1)[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered, 0.0)
    out = torch.sum(gathered.reshape(B, S, k, d)
                    * w[..., None].to(x.dtype), dim=2)
    if m.n_shared_experts:
        out = out + apply_mlp(p.shared, x, cfg)
    return out, aux_loss(probs, idx, cfg)
