"""GQA attention for serving — dense per-request caches (the static batch)
and a paged KV pool (continuous batching) — and for training
(``attn_forward``, no cache).

Layouts follow the reference: activations q (B, S, Hq, D), k/v
(B, S, Hkv, D). A dense cache is (B, max_len, Hkv, D) per layer; a pool is
(Hkv, P, page_size, D) and each sequence's block table (B, max_pages) maps
its logical blocks to pages.

Unlike the reference's functional updates, the port writes new KV into the
cache or pool in place (``attn_prefill``, ``attn_decode``,
``_scatter_pages``): the cache is the largest buffer in serving, and the
previous version is dead after every step.

Both paths cover window-free GQA, with float caches or int8 ones (the
kv8 policy: per-token-per-head int8 entries with f32 scales, the wire
format of ``repro_torch.quant.quantize_kv``, in parallel
``k_scale``/``v_scale`` buffers of a dense cache or
``k_scales``/``v_scales`` pools of a paged one). The dense path also
serves MLA (deepseek-v2's multi-head latent attention): its cache holds
the compressed latents ``ckv`` (B, max_len, C) and the RoPE keys
``krope`` (B, max_len, R), written in place; the prompt attends through
the decompressed K/V (``full`` or ``chunked``), a decode step through the
absorbed query, by the ``mla_decode`` kernel or the reference's einsum.
Training differentiates through every attention impl; ``pallas`` through
``_FlashAttention``, the ``flash_attention`` forward and the
``flash_attention_bwd`` backward. SWA ring caches, int8 latent caches,
paged MLA, MLA training and tensor parallelism are not ported and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ref as kref
from repro_torch.quant import quantize_kv
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _Params, rope
from repro_torch.models.param import ParamSpec, torch_dtype

NEG_INF = -1e30


class Attention(_Params):
    """GQA projections, or under ``cfg.mla`` the MLA ones: ``wq`` (d, H·(n
    + r)), the KV down-projection ``wdkv`` (d, C + r), the latents' f32
    norm weight ``kvnorm`` (C,), the per-head up-projections ``wuk`` (H,
    C, n) and ``wuv`` (H, C, v), and ``wo`` (H·v, d), as the reference's
    ``attn_specs``."""

    def __init__(self, cfg: ModelConfig, device):
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = torch_dtype(cfg.dtype)
        if cfg.mla is not None:
            m = cfg.mla
            specs = {
                "wq": ParamSpec((d, hq * (m.qk_nope_dim + m.qk_rope_dim)),
                                dt),
                "wdkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_dim), dt),
                "kvnorm": ParamSpec((m.kv_lora_rank,), torch.float32,
                                    "ones"),
                "wuk": ParamSpec((hq, m.kv_lora_rank, m.qk_nope_dim), dt),
                "wuv": ParamSpec((hq, m.kv_lora_rank, m.v_head_dim), dt),
                "wo": ParamSpec((hq * m.v_head_dim, d), dt)}
        else:
            specs = {"wq": ParamSpec((d, hq * dh), dt),
                     "wk": ParamSpec((d, hkv * dh), dt),
                     "wv": ParamSpec((d, hkv * dh), dt),
                     "wo": ParamSpec((hq * dh, d), dt)}
        super().__init__(specs, device)


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


# --- core attention math (q (B, S, Hq, D); k, v (B, T, Hkv, D)) -------------

def _causal_mask(sq: int, skv: int, *, kv_off: int, kv_valid: int,
                 device) -> torch.Tensor:
    """Query i (at position i) sees keys kv_off + j <= i below kv_valid."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = kv_off + torch.arange(skv, device=device)[None, :]
    return (q_pos >= k_pos) & (k_pos < kv_valid)


def full_attention(q, k, v) -> torch.Tensor:
    """Causal attention as one einsum over every (query, key) pair with a
    mask; f32 scores and sums, probabilities cast to v's dtype for the
    product, as the reference."""
    B, S, Hq, Dq = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", _group(q, Hkv).float(),
                     k.float()) * Dq ** -0.5
    m = _causal_mask(S, T, kv_off=0, kv_valid=T, device=q.device)
    p = torch.softmax(torch.where(m, s, NEG_INF), dim=-1)
    o = torch.einsum("bkgst,btkv->bskgv", p.to(v.dtype).float(), v.float())
    return o.reshape(B, S, Hq, v.shape[-1]).to(q.dtype)


def chunked_attention(q, k, v, *, chunk_kv: int = 512) -> torch.Tensor:
    """Causal attention with an online softmax over KV chunks of
    ``chunk_kv`` (the reference's ``lax.scan`` as a loop): O(S) score
    memory, the reference's arithmetic order."""
    B, S, Hq, Dq = q.shape
    T, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    ck = min(chunk_kv, T)
    qh = q.transpose(1, 2).float()                              # (B,Hq,S,D)
    m_run = torch.full((B, Hq, S, 1), NEG_INF, device=q.device)
    l_run = torch.zeros((B, Hq, S, 1), device=q.device)
    acc = torch.zeros((B, Hq, S, Dv), device=q.device)
    for j0 in range(0, T, ck):
        kj = k[:, j0:j0 + ck]
        vj = v[:, j0:j0 + ck]
        n = kj.shape[1]
        if n < ck:      # the reference pads the last chunk with zeros
            pad = (0, 0, 0, 0, 0, ck - n)
            kj = torch.nn.functional.pad(kj, pad)
            vj = torch.nn.functional.pad(vj, pad)
        if G > 1:
            kj = torch.repeat_interleave(kj, G, dim=2)
            vj = torch.repeat_interleave(vj, G, dim=2)
        s = torch.einsum("bhsd,bthd->bhst", qh, kj.float()) * Dq ** -0.5
        msk = _causal_mask(S, ck, kv_off=j0, kv_valid=T, device=q.device)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m_run, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhst,bthv->bhsv",
                                        p.to(vj.dtype).float(), vj.float())
        m_run = m_new
    o = acc / torch.clamp(l_run, min=1e-30)
    return o.transpose(1, 2).to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    """Causal (or windowed) attention through the autotuned kernels, the
    reference's ``custom_vjp`` around its Pallas pair: the forward is
    ``flash_attention`` (``kernels.ops.attention`` with the lse), the
    backward ``flash_attention_bwd`` (``kernels.ops.attention_bwd``),
    which recomputes p from the saved lse; CUDA on the card, their plain
    versions on the CPU. q (B, S, Hq, D), k and v (B, S, Hkv, D) go to the
    kernels as (B, H, S, D) views, no copy; o and the gradients come back
    in the callers' (B, S, H, D) layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        from repro_torch.kernels import ops as kops
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        o, lse = kops.attention(qt, kt, vt, causal=causal, window=window,
                                return_lse=True)
        ctx.save_for_backward(qt, kt, vt, o, lse)
        ctx.causal, ctx.window = causal, window
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, grad):
        from repro_torch.kernels import ops as kops
        qt, kt, vt, o, lse = ctx.saved_tensors
        do = grad.contiguous().transpose(1, 2)
        dq, dk, dv = kops.attention_bwd(qt, kt, vt, o, lse, do,
                                        causal=ctx.causal, window=ctx.window)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2), \
            None, None


def _pallas_attention(q, k, v) -> torch.Tensor:
    """Causal attention through the autotuned ``flash_attention`` kernel,
    differentiable through ``flash_attention_bwd`` (``_FlashAttention``):
    the serving prefill (under ``no_grad``, the forward alone) and the
    training forward."""
    return _FlashAttention.apply(q, k, v, True, None)


def run_attention(q, k, v, *, impl: str = "chunked",
                  chunk: int = 512) -> torch.Tensor:
    """Causal self-attention over the prompt by ``impl``: ``full`` and
    ``chunked`` in plain torch ops, ``pallas`` through the flash_attention
    kernel."""
    if impl == "full":
        return full_attention(q, k, v)
    if impl == "chunked":
        return chunked_attention(q, k, v, chunk_kv=chunk)
    if impl == "pallas":
        return _pallas_attention(q, k, v)
    if impl == "triangular":
        raise NotImplementedError(
            "attention impl 'triangular': the reference's triangular "
            "prefill is not ported (full, chunked and pallas are)")
    raise ValueError(f"attention impl {impl!r} (full, chunked or pallas)")


def attn_forward(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                 impl: str = "chunked", chunk: int = 512) -> torch.Tensor:
    """Training / no-cache forward over x (B, S, d) at positions 0..S-1,
    causal, the reference's ``attn_forward`` for GQA: attention by
    ``impl`` (``full``, ``chunked``, or ``pallas`` through
    ``_FlashAttention``). MLA is refused: its q.k and v head widths
    differ, so ``flash_attention`` cannot take it, and its training path
    is not ported."""
    if cfg.mla is not None:
        raise NotImplementedError(
            f"training {cfg.name!r}: MLA attention has no training path in "
            f"the port (its q.k and v head widths differ, so "
            f"flash_attention cannot take it)")
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    return _proj_out(p, run_attention(q, k, v, impl=impl, chunk=chunk), cfg)


# --- dense KV cache (static-batch serving) ---------------------------------

def attn_cache_spec(cfg: ModelConfig, batch: int, max_len: int,
                    kv_dtype: Optional[str] = None):
    """(shape, dtype) of this layer's dense cache, layout (B, max_len,
    Hkv, D) as the reference's; window-free only. ``kv_dtype="int8"`` (the
    kv8 policy) stores int8 entries plus per-token-per-head f32 scales
    (B, max_len, Hkv) in parallel ``k_scale``/``v_scale`` buffers. An MLA
    layer's cache is the latents ``ckv`` (B, max_len, C) and the RoPE keys
    ``krope`` (B, max_len, R) in the model's dtype; it has no int8 form."""
    if cfg.mla is not None:
        if kv_dtype is not None:
            _check_kv8(cfg)
        m, dt = cfg.mla, torch_dtype(cfg.dtype)
        return {"ckv": ((batch, max_len, m.kv_lora_rank), dt),
                "krope": ((batch, max_len, m.qk_rope_dim), dt)}
    if cfg.window is not None:
        raise NotImplementedError(
            f"{cfg.name!r}: SWA ring caches are not ported")
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if kv_dtype is None:
        dt = torch_dtype(cfg.dtype)
        return {"k": (shape, dt), "v": (shape, dt)}
    if kv_dtype != "int8":
        raise ValueError(f"kv_dtype {kv_dtype!r} (None or 'int8')")
    sshape = shape[:3]
    return {"k": (shape, torch.int8), "v": (shape, torch.int8),
            "k_scale": (sshape, torch.float32),
            "v_scale": (sshape, torch.float32)}


def _check_kv8(cfg: ModelConfig) -> None:
    if cfg.mla is not None:
        raise NotImplementedError(
            f"kv8 int8 caching needs the latent-cache quant path; "
            f"{cfg.name!r} uses MLA")


def _write_kv(cache: Dict[str, torch.Tensor], k, v, pos: slice) -> None:
    """Write k, v (B, S, Hkv, D) into the cache slots ``pos`` in place; an
    int8 cache (it holds ``k_scale``) takes them quantized, each token and
    head with its own absmax scale."""
    if "k_scale" in cache:
        k, ks, v, vs = quantize_kv(k, v)
        cache["k_scale"][:, pos] = ks
        cache["v_scale"][:, pos] = vs
    cache["k"][:, pos] = k
    cache["v"][:, pos] = v


def attn_prefill(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 cache: Dict[str, torch.Tensor], *, impl: str = "chunked",
                 chunk: int = 512):
    """Forward over the prompt x (B, S, d) at positions 0..S-1, writing its
    K/V into slots 0..S-1 of ``cache`` (``lm.init_cache`` sizes it at
    max_len slots), in place. Under kv8 the attention over the prompt
    still runs in full precision: only what persists is quantized.
    Returns (out, cache)."""
    if cfg.mla is not None:
        return _mla_prefill(p, x, cfg, cache, impl=impl, chunk=chunk)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    o = run_attention(q, k, v, impl=impl, chunk=chunk)
    _write_kv(cache, k, v, slice(0, S))
    return _proj_out(p, o, cfg), cache


def attn_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                cache: Dict[str, torch.Tensor], pos: int, *,
                impl: str = "plain"):
    """One-token decode at position ``pos`` (the same for every request of
    the static batch). x (B, 1, d). The new token's K/V land in slot
    ``pos`` in place (quantized with their scales first in an int8
    cache); then ``impl="kernel"`` attends through the autotuned kernel,
    ``gqa_decode_ragged`` (``kernels.ops.ragged_decode``) or for an int8
    cache ``gqa_decode_kv8`` (``kernels.ops.ragged_decode_kv8``), kv_len =
    pos + 1, the cache and its scales handed over as (B, Hkv, T, D) and
    (B, Hkv, T) views; ``impl="plain"`` attends through the reference's
    einsum path, over the int8 cache dequantized in f32. An MLA layer
    decodes through ``_mla_decode``. Returns (out, cache)."""
    if cfg.mla is not None:
        return _mla_decode(p, x, cfg, cache, pos, impl=impl)
    B = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    _write_kv(cache, k, v, slice(pos, pos + 1))
    ck, cv = cache["k"], cache["v"]
    quantized = "k_scale" in cache
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        kv_len = torch.full((B,), pos + 1, dtype=torch.int32,
                            device=x.device)
        if quantized:
            o = kops.ragged_decode_kv8(
                q[:, 0], ck.transpose(1, 2), cv.transpose(1, 2),
                cache["k_scale"].transpose(1, 2),
                cache["v_scale"].transpose(1, 2), kv_len=kv_len)
        else:
            o = kops.ragged_decode(q[:, 0], ck.transpose(1, 2),
                                   cv.transpose(1, 2), kv_len=kv_len)
        return _proj_out(p, o[:, None], cfg), cache
    if impl != "plain":
        raise ValueError(f"decode impl {impl!r}")
    ckf, cvf = ck.float(), cv.float()
    if quantized:                          # dequant for the einsum path
        ckf = ckf * cache["k_scale"][..., None]
        cvf = cvf * cache["v_scale"][..., None]
    s = torch.einsum("bskgd,btkd->bkgst", _group(q, hkv).float(),
                     ckf) * dh ** -0.5
    valid = torch.arange(ck.shape[1], device=x.device) <= pos
    prob = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    o = torch.einsum("bkgst,btkv->bskgv", prob, cvf)
    o = o.reshape(B, 1, hq, dh).to(x.dtype)
    return _proj_out(p, o, cfg), cache


# --- MLA (DeepSeek multi-head latent attention), dense caches ---------------

def _mla_scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return (m.qk_nope_dim + m.qk_rope_dim) ** -0.5


def _mla_project_q(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor):
    """(q_nope (B, S, H, n), q_rope (B, S, H, r) rotated)."""
    B, S, _ = x.shape
    m = cfg.mla
    q = (x @ p.wq).reshape(B, S, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_compress(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor):
    """(ckv (B, S, C): the latents RMS-normed in f32 with ``kvnorm`` at eps
    1e-6, in x's dtype; krope (B, S, r): the shared RoPE key, rotated)."""
    m = cfg.mla
    dkv = x @ p.wdkv
    ckv, krope = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    xf = ckv.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    ckv = (xf * torch.rsqrt(var + 1e-6) * p.kvnorm).to(x.dtype)
    krope = rope(krope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return ckv, krope


def _mla_prefill(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 cache: Dict[str, torch.Tensor], *, impl: str, chunk: int):
    """The prompt through the decompressed form (the reference's
    ``_mla_forward``): per-head K = [ckv W_uk | krope] and V = ckv W_uv,
    causal attention by ``impl`` (``full`` or ``chunked``; q and k are n + r
    wide and v is v_head_dim wide, which ``flash_attention``, one head dim,
    does not take); the latents and RoPE keys land in slots 0..S-1 of the
    cache in place. Returns (out, cache)."""
    if impl == "pallas":
        raise NotImplementedError(
            "MLA prefill under attn_impl='pallas': q and k are "
            "qk_nope + qk_rope wide and v is v_head_dim wide, and "
            "flash_attention takes one head dim (MLA prefills by chunked "
            "or full)")
    B, S, _ = x.shape
    m = cfg.mla
    positions = torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_project_q(p, x, cfg, positions)
    ckv, krope = _mla_compress(p, x, cfg, positions)
    k_nope = torch.einsum("btc,hcn->bthn", ckv, p.wuk.to(x.dtype))
    v = torch.einsum("btc,hcv->bthv", ckv, p.wuv.to(x.dtype))
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        B, S, cfg.n_heads, m.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = run_attention(q, k, v, impl=impl, chunk=chunk)
    cache["ckv"][:, :S] = ckv
    cache["krope"][:, :S] = krope
    return _proj_out(p, o, cfg), cache


def _mla_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                cache: Dict[str, torch.Tensor], pos: int, *, impl: str):
    """Absorbed-MLA decode at position ``pos``: the new latent and RoPE key
    land in slot ``pos`` in place; W_uk folds into the query (q_abs, B×H×C)
    so attention runs against the latent cache itself. ``impl="kernel"``
    attends through the autotuned ``mla_decode`` kernel
    (``kernels.ops.latent_decode``, kv_len = pos + 1) and applies W_uv in
    f32; ``impl="plain"`` through the reference's einsum and softmax.
    Returns (out, cache)."""
    B = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope = _mla_project_q(p, x, cfg, positions)
    ckv_t, krope_t = _mla_compress(p, x, cfg, positions)
    cache["ckv"][:, pos:pos + 1] = ckv_t
    cache["krope"][:, pos:pos + 1] = krope_t
    ckv, krope = cache["ckv"], cache["krope"]
    q_abs = torch.einsum("bshn,hcn->bshc", q_nope, p.wuk.to(x.dtype))
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        kv_len = torch.full((B,), pos + 1, dtype=torch.int32,
                            device=x.device)
        ctx = kops.latent_decode(q_abs[:, 0], q_rope[:, 0], ckv, krope,
                                 kv_len=kv_len, scale=_mla_scale(cfg))
        o = torch.einsum("bhc,hcv->bhv", ctx, p.wuv.float())
        return _proj_out(p, o[:, None].to(x.dtype), cfg), cache
    if impl != "plain":
        raise ValueError(f"decode impl {impl!r}")
    s = torch.einsum("bshc,btc->bhst", q_abs.float(), ckv.float())
    s = s + torch.einsum("bshr,btr->bhst", q_rope.float(), krope.float())
    s = s * _mla_scale(cfg)
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    prob = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    ctx = torch.einsum("bhst,btc->bshc", prob, ckv.float())
    o = torch.einsum("bshc,hcv->bshv", ctx, p.wuv.float()).to(x.dtype)
    return _proj_out(p, o, cfg), cache


# --- paged KV cache ------------------------------------------------------------

def paged_cache_spec(cfg: ModelConfig, num_pages: int, page_size: int,
                     kv_dtype: Optional[str] = None):
    """(shape, dtype) of this layer's page pools, layout
    (Hkv, P, page_size, D). ``kv_dtype="int8"`` (the kv8 policy) makes the
    pools int8 and adds per-token f32 scale pools (Hkv, P, page_size)
    ``k_scales``/``v_scales``, chased through the same block tables."""
    shape = (cfg.n_kv_heads, num_pages, page_size, cfg.head_dim)
    if kv_dtype is None:
        dt = torch_dtype(cfg.dtype)
        return {"k_pages": (shape, dt), "v_pages": (shape, dt)}
    if kv_dtype != "int8":
        raise ValueError(f"kv_dtype {kv_dtype!r} (None or 'int8')")
    sshape = shape[:3]
    return {"k_pages": (shape, torch.int8), "v_pages": (shape, torch.int8),
            "k_scales": (sshape, torch.float32),
            "v_scales": (sshape, torch.float32)}


def _scatter_pages(pages: torch.Tensor, vals: torch.Tensor,
                   block_tables: torch.Tensor, start: torch.Tensor) -> None:
    """Write vals (B, S, Hkv, D) at token positions start[b] + s into the
    pool (Hkv, P, page_size, D) through each sequence's block table
    (B, max_pages), in place; per-token scales (B, S, Hkv) go into a scale
    pool (Hkv, P, page_size) by the same index arithmetic. Blocks past the
    table are clipped to its last entry, as in the reference. Inactive
    rows must be routed to the scratch page by the caller; only
    scratch-page or padded positions may then receive two writes, and
    which one lands is unspecified."""
    B, S = vals.shape[:2]
    page_size = pages.shape[2]
    pos = start[:, None].long() + torch.arange(S, device=vals.device)[None]
    blocks = torch.clamp(pos // page_size, 0, block_tables.shape[1] - 1)
    page_ids = torch.gather(block_tables.long(), 1, blocks)      # (B, S)
    slots = pos % page_size
    pages[:, page_ids, slots] = vals.movedim(2, 0).to(pages.dtype)


def _write_pages(cache: Dict[str, torch.Tensor], k, v,
                 block_tables: torch.Tensor, start: torch.Tensor) -> None:
    """Scatter k, v (B, S, Hkv, D) into the layer's pools from positions
    ``start``; int8 pools (they come with ``k_scales``) take them
    quantized, each token and head with its own absmax scale."""
    if "k_scales" in cache:
        k, ks, v, vs = quantize_kv(k, v)
        _scatter_pages(cache["k_scales"], ks, block_tables, start)
        _scatter_pages(cache["v_scales"], vs, block_tables, start)
    _scatter_pages(cache["k_pages"], k, block_tables, start)
    _scatter_pages(cache["v_pages"], v, block_tables, start)


def _scale_pools(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The scale pools an int8 layer cache hands the paged kernels
    (``k_scales``/``v_scales``); none for float pools."""
    if "k_scales" not in cache:
        return {}
    return {"k_scales": cache["k_scales"], "v_scales": cache["v_scales"]}


def _gather_pages_bthd(pages: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """Densify the pool for the prefill path: (B, capacity, Hkv, D)."""
    return kref.gather_pages(pages, block_tables).transpose(1, 2)


def _gather_scales_bth(scales: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """Densify a per-token scale pool (Hkv, P, page_size) through the
    block tables: (B, capacity, Hkv)."""
    return _gather_pages_bthd(scales[..., None], block_tables)[..., 0]


def attn_prefill_paged(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                       cache: Dict[str, torch.Tensor],
                       block_tables: torch.Tensor, start: torch.Tensor):
    """One chunked-prefill step: write the chunk's KV into the pool, then
    attend the chunk's queries over each sequence's gathered prefix,
    causally from position ``start[b]``. Plain PyTorch ops, as the
    reference computes this step in jnp. x (B, S, d); start (B,) int.
    Int8 pools (kv8) are dequantized in f32 after the gather, so the
    chunk attends the quantized cache, its own keys included, with f32
    probabilities, as the reference's paged prefill does (the dense kv8
    prefill attends in full precision instead)."""
    B, S, _ = x.shape
    positions = start[:, None].long() + torch.arange(S, device=x.device)[None]
    q, k, v = _qkv(p, x, cfg, positions)
    _write_pages(cache, k, v, block_tables, start)
    kd = _gather_pages_bthd(cache["k_pages"], block_tables)
    vd = _gather_pages_bthd(cache["v_pages"], block_tables)
    if "k_scales" in cache:
        kd = kd.float() * _gather_scales_bth(cache["k_scales"],
                                             block_tables)[..., None]
        vd = vd.float() * _gather_scales_bth(cache["v_scales"],
                                             block_tables)[..., None]
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
    lens 0 and a scratch-only table). The new token's K/V are written
    first (quantized with their scales into int8 pools); then
    ``impl="kernel"`` dispatches the autotuned ``paged_decode`` kernel
    (its int8 branch for int8 pools, handed the scale pools),
    ``"plain"`` its PyTorch version."""
    positions = lens[:, None].long()
    q, k, v = _qkv(p, x, cfg, positions)
    _write_pages(cache, k, v, block_tables, lens)
    args = (q[:, 0], cache["k_pages"], cache["v_pages"], block_tables,
            lens + 1)
    scales = _scale_pools(cache)
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        o = kops.paged_decode(*args, **scales)
    elif impl == "plain":
        o = kref.paged_decode(*args, **scales)
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
    dispatches the autotuned ``paged_verify`` kernel (its int8 branch for
    int8 pools, handed the scale pools), ``"plain"`` its PyTorch version.
    Under kv8 the K positions are quantized as they are written, with
    their scales; rejected drafts leave int8 entries and scales past the
    accepted prefix, which the next write overwrites."""
    K = x.shape[1]
    positions = lens[:, None].long() + torch.arange(K, device=x.device)[None]
    q, k, v = _qkv(p, x, cfg, positions)
    _write_pages(cache, k, v, block_tables, lens)
    args = (q, cache["k_pages"], cache["v_pages"], block_tables, lens + K)
    scales = _scale_pools(cache)
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        o = kops.paged_verify(*args, **scales)
    elif impl == "plain":
        o = kref.paged_verify(*args, **scales)
    else:
        raise ValueError(f"verify impl {impl!r}")
    return _proj_out(p, o, cfg), cache
