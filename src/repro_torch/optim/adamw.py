"""AdamW (``repro.optim.adamw``): the reference's f32 update, bias
correction, global-norm clip and schedules, on the port's tensors.

Parameters, gradients and moments are dictionaries of tensors by name
(``dict(model.named_parameters())`` for a model). ``apply_updates``
writes the parameters and the moments in place, leaf by leaf and in
chunks of a leaf: a full-width model's f32 moments take 31 GB, and the
reference's functional update would hold a second copy; the arithmetic
per element is the reference's.

Weight decay follows the reference's rule, a leaf of rank 2 or more, on
the reference's *stacked* tree: a norm weight of a scanned unit is
(reps, d) there and decayed, while the port holds it per layer as (d,).
So the caller passes each leaf's rank in that tree
(``models.param.stacked_ndims``); without it the leaf's own rank decides.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

Tree = Dict[str, torch.Tensor]
_CHUNK = 1 << 26        # elements a step of the update: 256 MB of f32


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: Tree
    v: Tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    state_dtype: str = "float32"     # bf16 halves optimizer memory for ≥70B
    schedule: str = "cosine"         # constant | cosine | linear_warmup
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor), in f32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "linear_warmup":
        decay = 1.0 - (1.0 - cfg.min_lr_frac) * frac
    else:  # cosine
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def init_state(cfg: AdamWConfig, params: Tree) -> AdamWState:
    dt = getattr(torch, cfg.state_dtype)
    device = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m={k: torch.zeros(p.shape, dtype=dt, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=dt, device=p.device)
           for k, p in params.items()})


def _chunks(t: torch.Tensor):
    return t.reshape(-1).split(_CHUNK)


def _global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = sum(torch.sum(torch.square(c.float()))
                for x in tree.values() for c in _chunks(x))
    return torch.sqrt(total)


def apply_updates(cfg: AdamWConfig, params: Tree, grads: Tree,
                  state: AdamWState,
                  ndims: Optional[Dict[str, int]] = None):
    """One AdamW step: the parameters and the moments written in place.
    ``ndims`` gives each leaf's rank in the reference's tree (decay where
    it is 2 or more). Returns (params, new state, {"grad_norm", "lr"})."""
    step = state.step + 1
    gnorm = _global_norm(grads)
    scale = None
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    lr = schedule_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    dt = getattr(torch, cfg.state_dtype)
    with torch.no_grad():
        for name, p in params.items():
            decayed = (ndims[name] if ndims is not None else p.dim()) >= 2
            for pc, mc, vc, gc in zip(
                    *(x.view(-1).split(_CHUNK)
                      for x in (p, state.m[name], state.v[name])),
                    _chunks(grads[name])):
                # the clipped gradient is f32, as the reference's (a bf16
                # leaf times its f32 scale)
                gf = gc.float() if scale is None else gc.float() * scale
                m_new = cfg.b1 * mc.float() + (1 - cfg.b1) * gf
                v_new = cfg.b2 * vc.float() + (1 - cfg.b2) * gf * gf
                delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
                pf = pc.float()
                if decayed:
                    delta = delta + cfg.weight_decay * pf
                pc.copy_(pf - lr * delta)
                mc.copy_(m_new.to(dt))
                vc.copy_(v_new.to(dt))
    return params, AdamWState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
