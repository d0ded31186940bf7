"""The train step (the train subset of ``repro.launch.steps``): gradient
accumulation over micro-batches, optional int8 error-feedback
compression, AdamW.

``StepConfig`` keeps the reference's fields. The sharding ``policy``,
``opt_policy`` and ``kv_layout`` have a meaning only on a device mesh,
which the port does not have yet: any value but the default is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import ForwardOpts
from repro_torch.models.param import reference_leaves, stacked_ndims
from repro_torch.optim import adamw
from repro_torch.runtime import compression


@dataclasses.dataclass(frozen=True)
class StepConfig:
    policy: str = "train_tp"            # mesh sharding rules: default only
    opt_policy: str = "train_fsdp_tp"   # ZeRO-1 moment sharding: default only
    opts: ForwardOpts = ForwardOpts()
    micro_batches: int = 1
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()
    grad_compression: bool = False
    # Gradient-accumulation buffer dtype (float32, or bfloat16 to halve it)
    accum_dtype: str = "float32"
    kv_layout: str = "heads"            # serving cache layout: default only


def _check_mesh_fields(scfg: StepConfig) -> None:
    default = StepConfig()
    for field in ("policy", "opt_policy", "kv_layout"):
        if getattr(scfg, field) != getattr(default, field):
            raise NotImplementedError(
                f"StepConfig.{field}={getattr(scfg, field)!r}: sharding "
                f"over a device mesh is not ported (one card; the default "
                f"{getattr(default, field)!r} only)")


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device, torch.long)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, scfg: StepConfig, model: lm.LM):
    """Returns step(params, opt_state, batch) → (params, opt_state,
    metrics). ``params`` are ``model``'s parameters by name
    (``dict(model.named_parameters())``), updated in place; ``batch``
    holds tokens and labels (B, S), numpy or tensors. With ``micro_batches``
    > 1 the batch is cut into that many along B, the gradients summed in
    ``accum_dtype`` and divided by their number, the metrics averaged."""
    _check_mesh_fields(scfg)
    ocfg = scfg.adamw
    named = dict(model.named_parameters())
    ndims = stacked_ndims(model, cfg)
    leaves = reference_leaves(model, cfg)
    device = next(iter(named.values())).device

    def grads_of(batch):
        for p in named.values():
            p.grad = None
        loss, metrics = lm.loss_fn(model, cfg, batch, scfg.opts)
        loss.backward()
        grads = {k: p.grad for k, p in named.items()}
        for p in named.values():
            p.grad = None
        return grads, dict(metrics, loss=loss.detach())

    def step(params, opt_state, batch):
        batch = _to_device(batch, device)
        nm = scfg.micro_batches
        if nm > 1:
            accum_dt = getattr(torch, scfg.accum_dtype)
            grads = {k: torch.zeros(p.shape, dtype=accum_dt, device=device)
                     for k, p in named.items()}
            ms = []
            for i in range(nm):
                mb = {k: v.reshape((nm, v.shape[0] // nm) + v.shape[1:])[i]
                      for k, v in batch.items()}
                g, m = grads_of(mb)
                for k in grads:
                    grads[k] = (grads[k] + g[k].to(accum_dt)).to(accum_dt)
                ms.append(m)
                del g
            grads = {k: a / nm for k, a in grads.items()}
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}
        else:
            grads, metrics = grads_of(batch)
        if scfg.grad_compression:
            grads, new_ef = compression.ef_compress(grads, opt_state["ef"],
                                                    leaves)
        params, new_adamw, om = adamw.apply_updates(
            ocfg, params, grads, opt_state["adamw"], ndims)
        metrics.update(om)
        new_state = {"adamw": new_adamw}
        if scfg.grad_compression:
            new_state["ef"] = new_ef
        return params, new_state, metrics

    return step


def init_opt_state(cfg: ModelConfig, scfg: StepConfig, params):
    state = {"adamw": adamw.init_state(scfg.adamw, params)}
    if scfg.grad_compression:
        state["ef"] = compression.init_ef_state(params)
    return state
