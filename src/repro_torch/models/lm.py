"""Language model for paged serving: embeddings → decoder layers → logits.

The reference stacks repeating layer units and drives them with
``lax.scan``; eager PyTorch needs no stacking, so ``LM`` holds one
``Block`` per layer in order (``param.from_numpy_tree`` unstacks the
reference's scan units into it).

Entry points (paged subset of ``repro.models.lm``):
    init_paged_cache     — zero-filled page pools, one pair per layer
    prefill_paged        — one chunked-prefill step through block tables
    decode_step_paged    — one-token decode across the continuous batch
    verify_step_paged    — K positions per sequence (speculative verify)
The steps write the pools in place and return them with f32 logits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch import nn

from repro_torch.models import attention as ATT
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP, Embed, Norm, apply_mlp, apply_norm, embed_tokens, logits_out,
)

Cache = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ForwardOpts:
    # kernel (paged_decode, paged_verify) | plain
    decode_impl: str = "kernel"
    norm_impl: str = "plain"         # plain | kernel (rms_norm)


class Block(nn.Module):
    """One ``attn_mlp`` decoder layer, named as the reference's tree."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.mix = ATT.Attention(cfg, device)
        self.ln2 = Norm(cfg, device)
        self.ffn = MLP(cfg, device, cfg.d_ff_dense or cfg.d_ff)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _check_paged(cfg)
        kinds = set(cfg.layer_kinds())
        if kinds != {"attn_mlp"}:
            raise NotImplementedError(
                f"{cfg.name!r} has layer kinds {sorted(kinds)}; the port "
                "serves attn_mlp decoders")
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_ln = Norm(cfg, device)


def _check_paged(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.mla is not None or cfg.window is not None \
            or cfg.learned_pos or cfg.n_prefix:
        raise NotImplementedError(
            f"paged serving supports dense RoPE attention archs; "
            f"{cfg.name!r} needs MLA/SWA/enc-dec/prefix paging")


def _run_layers(model: LM, h, cfg, opts, cache, tables, start, *, mode):
    for block, layer_cache in zip(model.layers, cache):
        hn = apply_norm(block.ln1, h, cfg, impl=opts.norm_impl)
        if mode == "prefill":
            mix, _ = ATT.attn_prefill_paged(block.mix, hn, cfg, layer_cache,
                                            tables, start)
        elif mode == "decode":
            mix, _ = ATT.attn_decode_paged(block.mix, hn, cfg, layer_cache,
                                           tables, start,
                                           impl=opts.decode_impl)
        else:
            mix, _ = ATT.attn_verify_paged(block.mix, hn, cfg, layer_cache,
                                           tables, start,
                                           impl=opts.decode_impl)
        h = h + mix
        h = h + apply_mlp(block.ffn, apply_norm(block.ln2, h, cfg,
                                                impl=opts.norm_impl), cfg)
    return h


@torch.no_grad()
def prefill_paged(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Cache, block_tables: torch.Tensor,
                  start: torch.Tensor, opts: ForwardOpts = ForwardOpts()):
    """One chunked-prefill step: tokens (B, S) land at positions
    start[b]..start[b]+S-1, KV written through the block tables. Returns
    (all-position logits (B, S, vocab) f32, cache) — chunks are padded to
    a fixed width by the scheduler, so the caller picks the logit at its
    last valid position."""
    _check_paged(cfg)
    h = embed_tokens(model.embed, tokens, cfg)
    h = _run_layers(model, h, cfg, opts, cache, block_tables, start,
                    mode="prefill")
    h = apply_norm(model.final_ln, h, cfg, impl=opts.norm_impl)
    return logits_out(model.embed, h, cfg), cache


@torch.no_grad()
def decode_step_paged(model: LM, cfg: ModelConfig, token: torch.Tensor,
                      cache: Cache, block_tables: torch.Tensor,
                      lens: torch.Tensor, opts: ForwardOpts = ForwardOpts()):
    """One-token paged decode across the continuous batch. token (B, 1);
    lens (B,) resident lengths (0 = inactive slot). Returns
    (logits (B, vocab) f32, cache)."""
    _check_paged(cfg)
    h = embed_tokens(model.embed, token, cfg)
    h = _run_layers(model, h, cfg, opts, cache, block_tables, lens,
                    mode="decode")
    h = apply_norm(model.final_ln, h, cfg, impl=opts.norm_impl)
    return logits_out(model.embed, h, cfg)[:, 0], cache


@torch.no_grad()
def verify_step_paged(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: Cache, block_tables: torch.Tensor,
                      lens: torch.Tensor, opts: ForwardOpts = ForwardOpts()):
    """Speculative verify across the continuous batch: K consecutive
    positions per sequence in one pass. tokens (B, K), the last committed
    token plus K-1 drafts, land at positions lens[b]..lens[b]+K-1; lens
    (B,) resident lengths (0 = inactive slot). Returns (logits (B, K,
    vocab) f32, cache): logits[:, t] predicts the token after position t,
    what t+1 sequential ``decode_step_paged`` calls would give when the
    drafts before it match."""
    _check_paged(cfg)
    h = embed_tokens(model.embed, tokens, cfg)
    h = _run_layers(model, h, cfg, opts, cache, block_tables, lens,
                    mode="verify")
    h = apply_norm(model.final_ln, h, cfg, impl=opts.norm_impl)
    return logits_out(model.embed, h, cfg), cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device="cuda") -> Cache:
    """Zero-filled page pools for every layer."""
    _check_paged(cfg)
    specs = ATT.paged_cache_spec(cfg, num_pages, page_size)
    return [{name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in specs.items()}
            for _ in range(cfg.n_layers)]
