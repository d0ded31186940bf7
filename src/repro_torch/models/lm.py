"""Language model: embeddings → decoder layers → logits, for serving and
training.

The reference stacks repeating layer units and drives them with
``lax.scan``; eager PyTorch needs no stacking, so ``LM`` holds one
``Block`` per layer in order (``param.from_numpy_tree`` unstacks the
reference's scan units into it).

Entry points (serving subset of ``repro.models.lm``), dense caches (the
static batch):
    init_cache           — zero-filled (B, max_len, Hkv, D) caches per layer
    prefill              — the prompt, returns last-position logits + caches
    decode_step          — one token at position ``pos`` for the batch
and paged pools (continuous batching):
    init_paged_cache     — zero-filled page pools per layer (and scale
                           pools under kv8)
    prefill_paged        — one chunked-prefill step through block tables
    decode_step_paged    — one-token decode across the continuous batch
    verify_step_paged    — K positions per sequence (speculative verify)
The steps write the caches in place and return them with f32 logits. The
dense caches and the paged pools (the speculative verify's too) are int8
with f32 scales under ``ForwardOpts(quant="kv8")``; a model whose MLP
weights ``quant.quantize_params`` made QTensors (w8a8) runs their GEMMs by
``ForwardOpts.quant_impl``. Both paths serve RoPE attention archs with
no window, learned positions or prefix embeddings (``_check_dense``); the
paged path takes the dense GQA family only (``_check_paged``, as the
reference's), while the dense path also serves MoE layers (``attn_moe``:
``models.moe``, the reference's index dispatch) and MLA attention.

The training path (``repro.models.lm``'s ``forward`` and ``loss_fn``):
    forward   — all-position f32 logits (B, S, vocab) and the aux loss,
                differentiable; attention by ``ForwardOpts.attn_impl``
                (``pallas``: flash_attention forward, flash_attention_bwd
                backward), each layer recomputed in the backward under
                ``remat="full"``
    loss_fn   — masked cross entropy (labels −1 ignored) with the
                reference's metrics ``ce``, ``aux``, ``acc`` and ``tokens``
It trains what ``_check_train`` admits: the dense GQA archs, with the
plain norm (the rms_norm kernel has no gradient, as the reference's Pallas
norm has none), no quantization, no MoE (its training is not ported) and
no MLA.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import attention as ATT
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP, Embed, Norm, apply_mlp, apply_norm, embed_tokens, logits_out,
)
from repro_torch.models.moe import MoE, apply_moe
from repro_torch.quant import get_policy

Cache = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ForwardOpts:
    # dense prefill: full | chunked (plain torch) | pallas (flash_attention)
    attn_impl: str = "chunked"
    # kernel (gqa_decode_ragged, gqa_decode_kv8, paged_decode,
    # paged_verify) | plain
    decode_impl: str = "kernel"
    attn_chunk: int = 512            # KV chunk of chunked prefill
    norm_impl: str = "plain"         # plain | kernel (rms_norm)
    # Quantization policy (repro_torch.quant): None | w8a8 | kv8 (w8a16 is
    # a later slice). kv8 makes the dense caches and the page pools int8
    # with per-token f32 scales; w8a8 takes effect through
    # quant.quantize_params (QTensor weights dispatch the quantized GEMM
    # wherever they appear). quant_impl picks that GEMM: "sim" = the exact
    # integer-grid float32 product, "pallas" = the autotuned matmul_w8a8
    # kernel (CUDA on the card), the reference's names.
    quant: Optional[str] = None
    quant_impl: str = "sim"          # sim | pallas
    # Training: activation recompute per layer, none | full (dots, the
    # reference's dots_with_no_batch_dims_saveable policy, is not ported)
    remat: str = "none"

    def kv_dtype(self) -> Optional[str]:
        pol = get_policy(self.quant)
        return pol.kv_dtype if pol is not None else None


class Block(nn.Module):
    """One decoder layer of ``kind`` (``attn_mlp`` or ``attn_moe``), named
    as the reference's tree: the MLP is ``d_ff_dense`` wide where a MoE
    model keeps a layer dense."""

    def __init__(self, cfg: ModelConfig, device, kind: str):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.mix = ATT.Attention(cfg, device)
        self.ln2 = Norm(cfg, device)
        self.ffn = (MoE(cfg, device) if kind == "attn_moe"
                    else MLP(cfg, device, cfg.d_ff_dense or cfg.d_ff))


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _check_dense(cfg)
        kinds = cfg.layer_kinds()
        if not set(kinds) <= {"attn_mlp", "attn_moe"}:
            raise NotImplementedError(
                f"{cfg.name!r} has layer kinds {sorted(set(kinds))}; the "
                "port serves attn_mlp and attn_moe decoders")
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.layers = nn.ModuleList(Block(cfg, device, kind)
                                    for kind in kinds)
        self.final_ln = Norm(cfg, device)


def _check_dense(cfg: ModelConfig) -> None:
    """What the port's dense serving supports, and its paged serving too
    where ``_check_paged`` agrees: a RoPE attention arch of the dense or
    MoE family, GQA or MLA, with no window, learned positions or prefix
    embeddings."""
    if cfg.family not in ("dense", "moe") or cfg.window is not None \
            or cfg.learned_pos or cfg.n_prefix:
        raise NotImplementedError(
            f"the port's paged serving and dense serving support RoPE "
            f"attention archs; {cfg.name!r} needs SWA ring caches, learned "
            f"positions, enc-dec, SSM or prefix embeddings, which are not "
            f"ported")


def _check_train(cfg: ModelConfig, opts: ForwardOpts) -> None:
    """What the port trains: a dense GQA arch ``_check_dense`` admits, with
    the plain norm, unquantized, remat ``none`` or ``full``. The rest is
    refused by name."""
    _check_dense(cfg)
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"training {cfg.name!r}: MoE training (the router's aux loss and "
            f"the experts' gradients) is not ported")
    if cfg.mla is not None:
        raise NotImplementedError(
            f"training {cfg.name!r}: MLA attention has no training path in "
            f"the port")
    if opts.remat == "dots":
        raise NotImplementedError(
            "remat 'dots' (the reference's dots_with_no_batch_dims_saveable "
            "policy) is not ported; remat 'none' and 'full' are")
    if opts.remat not in ("none", "full"):
        raise ValueError(f"remat {opts.remat!r} (none, full or dots)")
    if opts.norm_impl != "plain":
        raise ValueError("training runs the plain norm: the rms_norm kernel "
                         "has no gradient")
    if opts.quant is not None:
        raise NotImplementedError(
            f"training under quant {opts.quant!r} is not ported")


def _check_paged(cfg: ModelConfig) -> None:
    """Paged serving takes dense GQA archs only, as the reference's
    ``_check_paged``: no MoE family, no MLA (whose latent cache has no
    paged form in the reference)."""
    _check_dense(cfg)
    if cfg.family != "dense" or cfg.mla is not None:
        raise NotImplementedError(
            f"paged serving supports dense RoPE attention archs; "
            f"{cfg.name!r} needs MLA or MoE paging, which the reference "
            f"does not have and the port does not either")


def _run_layers(model: LM, h, cfg, opts, cache, tables, start, *, mode):
    if ("k_scales" in cache[0]) != (opts.kv_dtype() == "int8"):
        raise ValueError(f"the page pools do not hold opts.quant="
                         f"{opts.quant!r}'s kv dtype (init_paged_cache with "
                         f"kv_dtype=opts.kv_dtype())")
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
        h = _ffn_residual(block, h + mix, cfg, opts)
    return h


def _ffn_residual(block: Block, h, cfg, opts):
    """h plus the layer's MLP or MoE (its aux loss unused in serving) over
    the second norm."""
    hn = apply_norm(block.ln2, h, cfg, impl=opts.norm_impl)
    if isinstance(block.ffn, MoE):
        return h + apply_moe(block.ffn, hn, cfg)[0]
    return h + apply_mlp(block.ffn, hn, cfg, quant_impl=opts.quant_impl)


def _block_train(block: Block, h: torch.Tensor, cfg: ModelConfig,
                 opts: ForwardOpts) -> torch.Tensor:
    hn = apply_norm(block.ln1, h, cfg)
    h = h + ATT.attn_forward(block.mix, hn, cfg, impl=opts.attn_impl,
                             chunk=opts.attn_chunk)
    return _ffn_residual(block, h, cfg, opts)


def _maybe_remat(fn, opts: ForwardOpts):
    """``fn`` as it is (``remat="none"``) or recomputed in the backward
    from its inputs (``"full"``, the reference's ``jax.checkpoint``:
    ``torch.utils.checkpoint`` without reentrance)."""
    if opts.remat == "none":
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False)


def forward(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
            opts: ForwardOpts = ForwardOpts()):
    """tokens (B, S) → (logits (B, S, vocab) f32, aux loss f32), the
    training path: every position, differentiable, each layer through
    ``_maybe_remat``. The aux loss is 0: the port trains no MoE layer."""
    _check_train(cfg, opts)
    h = embed_tokens(model.embed, tokens, cfg)
    layer = _maybe_remat(_block_train, opts)
    for block in model.layers:
        h = layer(block, h, cfg, opts)
    h = apply_norm(model.final_ln, h, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return logits_out(model.embed, h, cfg), aux


def loss_fn(model: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            opts: ForwardOpts = ForwardOpts()):
    """batch: tokens (B, S) and labels (B, S) integer (−1 = masked).
    Returns (loss, metrics): the mean cross entropy over the valid labels
    plus the aux loss times the MoE coefficient, and ``ce``, ``aux``,
    ``acc`` (argmax accuracy over the valid labels) and ``tokens`` (their
    count), as the reference's. The label's logit is gathered where the
    reference contracts a one-hot (equal in f32; the one-hot exists there
    to keep a vocab-sharded axis sharded)."""
    logits, aux = forward(model, cfg, batch["tokens"], opts)
    labels = batch["labels"]
    valid = labels >= 0
    labels_safe = torch.clamp(labels, min=0)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    ce = torch.where(valid, lse - ll, 0.0)
    n_valid = torch.clamp(valid.sum(), min=1)
    ce_mean = ce.sum() / n_valid
    aux_coef = cfg.moe.aux_loss_coef if cfg.moe is not None else 0.0
    loss = ce_mean + aux_coef * aux
    with torch.no_grad():
        acc = torch.where(valid, torch.argmax(logits, -1) == labels_safe,
                          False).sum() / n_valid
    return loss, {"ce": ce_mean.detach(), "aux": aux.detach(), "acc": acc,
                  "tokens": n_valid.float()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
               kv_dtype: Optional[str] = None) -> Cache:
    """Zero-filled dense caches (B, max_len, Hkv, D) for every layer;
    ``kv_dtype="int8"`` (kv8) adds the (B, max_len, Hkv) f32 scales. An
    MLA arch's caches are its latents and RoPE keys (``ckv``, ``krope``)."""
    _check_dense(cfg)
    specs = ATT.attn_cache_spec(cfg, batch, max_len, kv_dtype)
    return [{name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in specs.items()}
            for _ in range(cfg.n_layers)]


@torch.no_grad()
def prefill(model: LM, cfg: ModelConfig, tokens: torch.Tensor, *,
            max_len: int, opts: ForwardOpts = ForwardOpts()):
    """Run the prompts tokens (B, S) at positions 0..S-1 into caches of
    ``max_len`` slots (``init_cache``, int8 under ``opts.quant="kv8"``).
    Attention over the prompt is ``opts.attn_impl``: ``full`` and
    ``chunked`` (KV chunks of ``opts.attn_chunk``) are plain torch ops, as
    the reference's are jnp; ``pallas`` is the autotuned flash_attention
    kernel (CUDA on the card, its plain version on the CPU), as the
    reference's is its Pallas kernel. Returns (last-position logits
    (B, vocab) f32, caches)."""
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device,
                       kv_dtype=opts.kv_dtype())
    h = embed_tokens(model.embed, tokens, cfg)
    for block, layer_cache in zip(model.layers, cache):
        hn = apply_norm(block.ln1, h, cfg, impl=opts.norm_impl)
        mix, _ = ATT.attn_prefill(block.mix, hn, cfg, layer_cache,
                                  impl=opts.attn_impl, chunk=opts.attn_chunk)
        h = _ffn_residual(block, h + mix, cfg, opts)
    h = apply_norm(model.final_ln, h[:, -1:], cfg, impl=opts.norm_impl)
    return logits_out(model.embed, h, cfg)[:, 0], cache


@torch.no_grad()
def decode_step(model: LM, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache, pos: int, opts: ForwardOpts = ForwardOpts()):
    """token (B, 1) at position ``pos`` for every request; the caches are
    written in place and must be of ``opts``' kv dtype (int8 under kv8).
    Returns (logits (B, vocab) f32, caches)."""
    if ("k_scale" in cache[0]) != (opts.kv_dtype() == "int8"):
        raise ValueError(f"the caches do not hold opts.quant={opts.quant!r}'s "
                         f"kv dtype (prefill with the same opts)")
    h = embed_tokens(model.embed, token, cfg)
    for block, layer_cache in zip(model.layers, cache):
        hn = apply_norm(block.ln1, h, cfg, impl=opts.norm_impl)
        mix, _ = ATT.attn_decode(block.mix, hn, cfg, layer_cache, pos,
                                 impl=opts.decode_impl)
        h = _ffn_residual(block, h + mix, cfg, opts)
    h = apply_norm(model.final_ln, h, cfg, impl=opts.norm_impl)
    return logits_out(model.embed, h, cfg)[:, 0], cache


@torch.no_grad()
def prefill_paged(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Cache, block_tables: torch.Tensor,
                  start: torch.Tensor, opts: ForwardOpts = ForwardOpts()):
    """One chunked-prefill step: tokens (B, S) land at positions
    start[b]..start[b]+S-1, KV written through the block tables into
    pools of ``opts``' kv dtype (``init_paged_cache``). Returns
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
    lens (B,) resident lengths (0 = inactive slot); the pools must be of
    ``opts``' kv dtype (int8 under kv8). Returns
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
                     device="cuda", kv_dtype: Optional[str] = None) -> Cache:
    """Zero-filled page pools for every layer; ``kv_dtype="int8"`` (kv8)
    makes them int8 and adds the (Hkv, P, page_size) f32 scale pools."""
    _check_paged(cfg)
    specs = ATT.paged_cache_spec(cfg, num_pages, page_size, kv_dtype)
    return [{name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in specs.items()}
            for _ in range(cfg.n_layers)]
