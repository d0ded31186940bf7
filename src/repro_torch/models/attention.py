"""GQA attention over a paged KV pool (the continuous-batching subset).

Layouts follow the reference: activations q (B, S, Hq, D), k/v
(B, S, Hkv, D); the per-layer pool is (Hkv, P, page_size, D) and each
sequence's block table (B, max_pages) maps its logical blocks to pages.

Unlike the reference's functional updates, the port writes new KV into the
pool in place (``_scatter_pages``): the pool is the largest buffer in
serving, and the previous version is dead after every step.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref as kref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _Params, rope
from repro_torch.models.param import ParamSpec, torch_dtype

NEG_INF = -1e30


class Attention(_Params):
    def __init__(self, cfg: ModelConfig, device):
        if cfg.mla is not None:
            raise NotImplementedError("MLA attention: not in the port")
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = torch_dtype(cfg.dtype)
        super().__init__({"wq": ParamSpec((d, hq * dh), dt),
                          "wk": ParamSpec((d, hkv * dh), dt),
                          "wv": ParamSpec((d, hkv * dh), dt),
                          "wo": ParamSpec((hq * dh, d), dt)}, device)


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    B, S, Hq, D = q.shape
    return q.reshape(B, S, n_kv, Hq // n_kv, D)


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    B, S, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p.wq).reshape(B, S, hq, dh)
    k = (x @ p.wk).reshape(B, S, hkv, dh)
    v = (x @ p.wv).reshape(B, S, hkv, dh)
    if cfg.rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _proj_out(p: Attention, o: torch.Tensor, cfg: ModelConfig):
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ p.wo


# --- paged KV cache ------------------------------------------------------------

def paged_cache_spec(cfg: ModelConfig, num_pages: int, page_size: int):
    """(shape, dtype) of this layer's two page pools, layout
    (Hkv, P, page_size, D)."""
    shape = (cfg.n_kv_heads, num_pages, page_size, cfg.head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"k_pages": (shape, dt), "v_pages": (shape, dt)}


def _scatter_pages(pages: torch.Tensor, vals: torch.Tensor,
                   block_tables: torch.Tensor, start: torch.Tensor) -> None:
    """Write vals (B, S, Hkv, D) at token positions start[b] + s into the
    pool (Hkv, P, page_size, D) through each sequence's block table
    (B, max_pages), in place. Blocks past the table are clipped to its
    last entry, as in the reference. Inactive rows must be routed to the
    scratch page by the caller; only scratch-page or padded positions may
    then receive two writes, and which one lands is unspecified."""
    B, S = vals.shape[:2]
    page_size = pages.shape[2]
    pos = start[:, None].long() + torch.arange(S, device=vals.device)[None]
    blocks = torch.clamp(pos // page_size, 0, block_tables.shape[1] - 1)
    page_ids = torch.gather(block_tables.long(), 1, blocks)      # (B, S)
    slots = pos % page_size
    pages[:, page_ids, slots] = vals.permute(2, 0, 1, 3).to(pages.dtype)


def _gather_pages_bthd(pages: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """Densify the pool for the prefill path: (B, capacity, Hkv, D)."""
    return kref.gather_pages(pages, block_tables).transpose(1, 2)


def attn_prefill_paged(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                       cache: Dict[str, torch.Tensor],
                       block_tables: torch.Tensor, start: torch.Tensor):
    """One chunked-prefill step: write the chunk's KV into the pool, then
    attend the chunk's queries over each sequence's gathered prefix,
    causally from position ``start[b]``. Plain PyTorch ops, as the
    reference computes this step in jnp. x (B, S, d); start (B,) int."""
    B, S, _ = x.shape
    positions = start[:, None].long() + torch.arange(S, device=x.device)[None]
    q, k, v = _qkv(p, x, cfg, positions)
    _scatter_pages(cache["k_pages"], k, block_tables, start)
    _scatter_pages(cache["v_pages"], v, block_tables, start)
    kd = _gather_pages_bthd(cache["k_pages"], block_tables)
    vd = _gather_pages_bthd(cache["v_pages"], block_tables)
    T = kd.shape[1]
    k_pos = torch.arange(T, device=x.device)[None, None, :]
    valid = k_pos <= positions[:, :, None]                     # (B, S, T)
    qg = _group(q, cfg.n_kv_heads)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), kd.float())
    s = s * cfg.head_dim ** -0.5
    s = torch.where(valid[:, None, None], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkv->bskgv", prob.to(vd.dtype).float(),
                     vd.float())
    o = o.reshape(B, S, cfg.n_heads, cfg.head_dim).to(x.dtype)
    return _proj_out(p, o, cfg), cache


def attn_decode_paged(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                      cache: Dict[str, torch.Tensor],
                      block_tables: torch.Tensor, lens: torch.Tensor, *,
                      impl: str = "kernel"):
    """One-token paged decode. x (B, 1, d); lens (B,) tokens already
    resident (the new token lands at position lens[b]; inactive slots have
    lens 0 and a scratch-only table). ``impl="kernel"`` dispatches the
    autotuned ``paged_decode`` kernel, ``"plain"`` its PyTorch version."""
    positions = lens[:, None].long()
    q, k, v = _qkv(p, x, cfg, positions)
    _scatter_pages(cache["k_pages"], k, block_tables, lens)
    _scatter_pages(cache["v_pages"], v, block_tables, lens)
    args = (q[:, 0], cache["k_pages"], cache["v_pages"], block_tables,
            lens + 1)
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        o = kops.paged_decode(*args)
    elif impl == "plain":
        o = kref.paged_decode(*args)
    else:
        raise ValueError(f"decode impl {impl!r}")
    return _proj_out(p, o[:, None], cfg), cache


def attn_verify_paged(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                      cache: Dict[str, torch.Tensor],
                      block_tables: torch.Tensor, lens: torch.Tensor, *,
                      impl: str = "kernel"):
    """Speculative verify: score K consecutive positions in one pass.

    x (B, K, d), the last committed token plus K-1 drafts; lens (B,) tokens
    already resident (the K inputs land at positions lens[b]..lens[b]+K-1).
    All K positions' KV are written into the pool in place; rejected
    drafts leave stale entries past the accepted prefix, which the next
    scatter overwrites and attention never reads (it stops at kv_len).
    Query t attends the resident prefix plus drafts 0..t (kv_len = lens +
    K, causal tails in the kernel), so each accepted output is what
    sequential ``attn_decode_paged`` calls would give. ``impl="kernel"``
    dispatches the autotuned ``paged_verify`` kernel, ``"plain"`` its
    PyTorch version."""
    K = x.shape[1]
    positions = lens[:, None].long() + torch.arange(K, device=x.device)[None]
    q, k, v = _qkv(p, x, cfg, positions)
    _scatter_pages(cache["k_pages"], k, block_tables, lens)
    _scatter_pages(cache["v_pages"], v, block_tables, lens)
    args = (q, cache["k_pages"], cache["v_pages"], block_tables, lens + K)
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        o = kops.paged_verify(*args)
    elif impl == "plain":
        o = kref.paged_verify(*args)
    else:
        raise ValueError(f"verify impl {impl!r}")
    return _proj_out(p, o, cfg), cache
