"""Parameter specifications, random init, and the reference-tree converter.

Every module of the port declares its parameters once as ``ParamSpec``s
(shape in the reference's ``(in, out)`` layout, dtype, init rule) and
creates them with ``empty_parameter``. From that single source:

  * ``init_params(cfg, generator, device)`` — random weights made on the
    device with the reference's rules (normal × 1/√fan_in, zeros, ones);
  * ``from_numpy_tree(params_np, cfg)`` — the reference's parameter tree,
    handed over as numpy arrays nested as ``lm_specs`` nests them, loaded
    into the port's modules (stacked scan units are unstacked per layer);
    the reference's quantized weights (QTensor leaves: values and scale)
    become the port's ``QTensor``s, sliced per layer as well.

Parameters are created with ``requires_grad=False``: the port serves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"           # normal | zeros | ones
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)


def empty_parameter(spec: ParamSpec, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(spec.shape, dtype=spec.dtype,
                                    device=device), requires_grad=False)


def _init_leaf_(p: torch.Tensor, spec: ParamSpec,
                generator: torch.Generator) -> None:
    if spec.init == "zeros":
        p.zero_()
        return
    if spec.init == "ones":
        p.fill_(1.0)
        return
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    noise = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=p.device)
    p.copy_(noise.mul_(scale))      # one f32 temporary a leaf


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda"):
    """Random weights for ``cfg`` made on ``device`` from ``generator``
    (default: seed 0 on that device). Returns the port's ``lm.LM``."""
    from repro_torch.models.lm import LM
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = LM(cfg, device=device)
    with torch.no_grad():
        for mod in model.modules():
            for name, spec in getattr(mod, "param_specs", {}).items():
                _init_leaf_(getattr(mod, name), spec, generator)
    return model


def _to_tensor(a: Any) -> torch.Tensor:
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _qtensor(leaf: Any, index: Optional[int]):
    """The port's QTensor from a reference QTensor leaf (``values`` int8
    or integer-grid float32, ``scale`` with kept dims), layer ``index`` of
    a stacked unit: (reps, K, N) values and (reps, 1, N) scales."""
    from repro_torch.quant.qtensor import QTensor, k_major
    values, scale = (_to_tensor(a if index is None else a[index])
                     for a in (leaf.values, leaf.scale))
    return QTensor(k_major(values.to(torch.int8)), scale,
                   bool(leaf.act_quant))


def _load_module_(mod: nn.Module, tree: Dict[str, Any], index: Optional[int]):
    for name, spec in getattr(mod, "param_specs", {}).items():
        leaf = tree[name]
        if hasattr(leaf, "values") and hasattr(leaf, "scale"):
            qt = _qtensor(leaf, index)
            if qt.shape != tuple(spec.shape):
                raise ValueError(f"{type(mod).__name__}.{name}: reference "
                                 f"shape {qt.shape} != {tuple(spec.shape)}")
            delattr(mod, name)
            setattr(mod, name, qt)
            continue
        src = _to_tensor(leaf if index is None else leaf[index])
        if tuple(src.shape) != tuple(spec.shape):
            raise ValueError(f"{type(mod).__name__}.{name}: reference shape "
                             f"{tuple(src.shape)} != {tuple(spec.shape)}")
        getattr(mod, name).copy_(src.to(spec.dtype))
    for name, child in mod.named_children():   # a MoE's shared experts
        _load_module_(child, tree[name], index)


def from_numpy_tree(params_np: Dict[str, Any], cfg: ModelConfig,
                    device="cuda"):
    """Load the reference's parameter tree (numpy leaves, nested as
    ``repro.models.lm.lm_specs``: ``embed.tok``, ``final_ln.w``,
    ``u{i}.l{j}.{ln1,mix,ln2,ffn}``) into a new ``lm.LM``. A unit scanned
    ``reps > 1`` times carries a leading stack axis that is unstacked
    into consecutive layers (deepseek-v2-lite: a unit ``u0`` of its dense
    first layer and 15 MoE layers, then its last 11 MoE layers stacked in
    ``u1``); a MoE layer's ``ffn`` holds the router, the stacked experts
    and, under ``shared``, the shared experts' MLP. Quantized MLP weights
    (the reference's ``quantize_params``: QTensor leaves with numpy values
    and scale) load as the port's ``QTensor``s."""
    from repro_torch.models.lm import LM
    model = LM(cfg, device=torch.device(device))
    with torch.no_grad():
        _load_module_(model.embed, params_np["embed"], None)
        _load_module_(model.final_ln, params_np["final_ln"], None)
        layer = 0
        for ui, (unit, reps) in enumerate(cfg.scan_plan()):
            unit_tree = params_np[f"u{ui}"]
            for r in range(reps):
                index = r if reps > 1 else None
                for li in range(len(unit)):
                    lt = unit_tree[f"l{li}"]
                    block = model.layers[layer]
                    for part in ("ln1", "mix", "ln2", "ffn"):
                        _load_module_(getattr(block, part), lt[part], index)
                    layer += 1
    return model
