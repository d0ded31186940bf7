"""Checkpoints with atomic manifests (``repro.checkpoint.checkpoint``'s
layout) for the port's tensors.

Layout:  <dir>/step_<N>/
             manifest.json     per-leaf shape/dtype, step, the caller's
                               ``extra`` (data-stream state, step)
             shard_<host>.pt   the leaf tensors, in torch's own format

Atomicity: writes go to ``step_<N>.tmp`` and are renamed only after the
manifest is fsynced — a crashed writer never corrupts the latest
checkpoint (``latest_step`` scans only completed directories).

A tree is nested dictionaries, lists, tuples and named tuples (the
optimizer's state) of tensors; leaf keys are their paths joined by "/",
as the reference's. Leaves are stored on the CPU in their own dtype, so
a round trip is bit-exact, bf16 included; ``restore`` places each leaf on
the device and in the dtype of the leaf it replaces, and raises on a
shape that differs.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):                       # a named tuple
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    flat = {}
    for key, sub in items:
        flat.update(_flatten(sub, f"{prefix}{key}/"))
    return flat


def _unflatten(tree, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves, f"{prefix}{k}/")
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return leaves[prefix[:-1]]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         host_id: int = 0) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    # a copy of each leaf alone: torch.save writes a view's whole storage
    tensors = {k: torch.as_tensor(v).detach().to("cpu", copy=True)
               for k, v in _flatten(tree).items()}
    torch.save(tensors, os.path.join(tmp, f"shard_{host_id}.pt"))
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(t.shape), "dtype": _dtype_name(t)}
                   for k, t in tensors.items()},
        "extra": extra or {},
        "hosts": 1,
        "format": 1,
    }
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)            # atomic publish
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like, step: Optional[int] = None
            ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (its values give each
    leaf's device and dtype). Returns (tree, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = {}
    for name in os.listdir(d):
        if name.startswith("shard_") and name.endswith(".pt"):
            data.update(torch.load(os.path.join(d, name),
                                   weights_only=True))
    flat_like = _flatten(tree_like)
    missing = set(flat_like) - set(data)
    if missing:
        raise KeyError(f"checkpoint step {step} missing leaves: "
                       f"{sorted(missing)[:5]}...")
    restored = {}
    for k, like in flat_like.items():
        like = torch.as_tensor(like)
        arr = data[k]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"leaf {k}: checkpoint shape {tuple(arr.shape)} != model "
                f"{tuple(like.shape)} (did the config change?)")
        restored[k] = arr.to(device=like.device, dtype=like.dtype)
    return _unflatten(tree_like, restored), manifest["extra"]


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
