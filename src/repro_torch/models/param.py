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
    become the port's ``QTensor``s, sliced per layer as well;
  * ``to_numpy_tree(model, cfg)`` — the inverse: the model's parameters
    (or any tensors by parameter name, gradients say) restacked into the
    reference's tree, so that they compare leaf by leaf with it;
  * ``stacked_ndims(model, cfg)`` — each parameter's rank in the
    reference's stacked tree, which AdamW's decay rule reads;
  * ``reference_leaves(model, cfg)`` — the reference leaf each parameter
    sits in, which gradient compression's per-tensor scale spans.

Parameters are created with ``requires_grad=False`` for serving;
``trainable=True`` makes them leaves that take gradients, for training.
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
                device="cuda", trainable: bool = False):
    """Random weights for ``cfg`` made on ``device`` from ``generator``
    (default: seed 0 on that device). Returns the port's ``lm.LM``, its
    parameters requiring gradients when ``trainable``."""
    from repro_torch.models.lm import LM
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = LM(cfg, device=device)
    with torch.no_grad():
        for mod in model.modules():
            for name, spec in getattr(mod, "param_specs", {}).items():
                _init_leaf_(getattr(mod, name), spec, generator)
    return model.requires_grad_(trainable)


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
                    device="cuda", trainable: bool = False):
    """Load the reference's parameter tree (numpy leaves, nested as
    ``repro.models.lm.lm_specs``: ``embed.tok``, ``final_ln.w``,
    ``u{i}.l{j}.{ln1,mix,ln2,ffn}``) into a new ``lm.LM``. A unit scanned
    ``reps > 1`` times carries a leading stack axis that is unstacked
    into consecutive layers (deepseek-v2-lite: a unit ``u0`` of its dense
    first layer and 15 MoE layers, then its last 11 MoE layers stacked in
    ``u1``); a MoE layer's ``ffn`` holds the router, the stacked experts
    and, under ``shared``, the shared experts' MLP. Quantized MLP weights
    (the reference's ``quantize_params``: QTensor leaves with numpy values
    and scale) load as the port's ``QTensor``s. The parameters require
    gradients when ``trainable``."""
    from repro_torch.models.lm import LM
    model = LM(cfg, device=torch.device(device))
    with torch.no_grad():
        _load_module_(model.embed, params_np["embed"], None)
        _load_module_(model.final_ln, params_np["final_ln"], None)
        for block, (ui, reps, r, li) in zip(model.layers, _unit_layers(cfg)):
            lt = params_np[f"u{ui}"][f"l{li}"]
            for part in ("ln1", "mix", "ln2", "ffn"):
                _load_module_(getattr(block, part), lt[part],
                              r if reps > 1 else None)
    return model.requires_grad_(trainable)


def _unit_layers(cfg: ModelConfig):
    """(unit index, reps, repetition, index in the unit) of each layer in
    order: the reference's ``u{i}.l{j}`` leaf a layer's parameters sit in
    (at ``[r]`` of its stack when the unit repeats)."""
    for ui, (unit, reps) in enumerate(cfg.scan_plan()):
        for r in range(reps):
            for li in range(len(unit)):
                yield ui, reps, r, li


def stacked_ndims(model: nn.Module, cfg: ModelConfig) -> Dict[str, int]:
    """Each parameter's rank in the reference's tree, by the port's
    parameter name: one more than its own in a unit scanned ``reps > 1``
    times, whose leaves carry the stack axis (phi4-mini's per-layer norm
    weights are (32, 3072) there), its own elsewhere."""
    stacked = [reps > 1 for _, reps, _, _ in _unit_layers(cfg)]
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        extra = parts[0] == "layers" and stacked[int(parts[1])]
        out[name] = p.dim() + int(extra)
    return out


def reference_leaves(model: nn.Module, cfg: ModelConfig) -> Dict[str, str]:
    """Each parameter's leaf in the reference's tree, by the port's
    parameter name: ``u{i}.l{j}.<path>`` for a layer's (the layers of a
    unit scanned ``reps > 1`` times share one stacked leaf), its own name
    elsewhere."""
    units = list(_unit_layers(cfg))
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            ui, _, _, li = units[int(parts[1])]
            out[name] = ".".join([f"u{ui}", f"l{li}"] + parts[2:])
        else:
            out[name] = name
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """float32 for bf16 and f16 (exact: numpy has no bfloat16)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def to_numpy_tree(model: nn.Module, cfg: ModelConfig,
                  tensors: Optional[Dict[str, torch.Tensor]] = None):
    """The inverse of ``from_numpy_tree``: the reference's tree (nested as
    ``lm_specs``) of numpy arrays, a scanned unit's layers stacked on a
    leading axis. ``tensors`` maps the port's parameter names
    (``model.named_parameters()``) to the tensors to convert — gradients,
    optimizer moments — and defaults to the parameters. bf16 leaves come
    as float32."""
    if tensors is None:
        tensors = dict(model.named_parameters())

    def tree(mod: nn.Module, prefix: str) -> Dict[str, Any]:
        out = {name: _numpy(tensors[prefix + name])
               for name in getattr(mod, "param_specs", {})}
        for name, child in mod.named_children():
            out[name] = tree(child, f"{prefix}{name}.")
        return out

    params = {"embed": tree(model.embed, "embed."),
              "final_ln": tree(model.final_ln, "final_ln.")}
    units: Dict[str, Any] = {}
    for layer, (ui, reps, r, li) in enumerate(_unit_layers(cfg)):
        block = model.layers[layer]
        lt = {part: tree(getattr(block, part), f"layers.{layer}.{part}.")
              for part in ("ln1", "mix", "ln2", "ffn")}
        units.setdefault(f"u{ui}", {}).setdefault(f"l{li}", []).append(lt)
    for ui, layers in units.items():
        params[ui] = {
            li: (trees[0] if len(trees) == 1 else _stack(trees))
            for li, trees in layers.items()}
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
