"""Plain PyTorch versions of the port's kernels (subset of
``repro.kernels.ref``).

They are the ground truth the tests hold the kernels to, and what each
kernel's wrapper runs for tensors on the CPU. On the card ``chip_smoke.py``
compares every kernel with its version here on the same inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: no NaNs on masked rows


def _attn_mask(seq_q: int, seq_kv: int, *, causal: bool,
               window: Optional[int], q_offset: int,
               kv_len: Optional[torch.Tensor], device) -> torch.Tensor:
    """Boolean mask (seq_q, seq_kv), or (B, seq_q, seq_kv) with ``kv_len``;
    True = attend. Query i sits at position i + q_offset."""
    q_pos = torch.arange(seq_q, device=device)[:, None] + q_offset
    k_pos = torch.arange(seq_kv, device=device)[None, :]
    mask = torch.ones((seq_q, seq_kv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    if kv_len is not None:  # (B,) valid kv lengths (ragged batches)
        mask = mask[None] & (k_pos[None] < kv_len.to(device)[:, None, None])
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, q_offset: int = 0,
              kv_len: Optional[torch.Tensor] = None,
              return_lse: bool = False):
    """Multi-head attention with GQA in f32: q (B, Hq, Sq, D); k, v
    (B, Hkv, Skv, D) with Hq % Hkv == 0. Masked scores are -1e30, so a
    row with no visible key averages V, as the reference's oracle does.
    Returns o in q's dtype, and (o, lse (B, Hq, Sq) f32) with
    ``return_lse``."""
    B, Hq, Sq, D = q.shape
    group = Hq // k.shape[1]
    if scale is None:
        scale = D ** -0.5
    kq = torch.repeat_interleave(k, group, dim=1).float()
    vq = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    mask = _attn_mask(Sq, k.shape[2], causal=causal, window=window,
                      q_offset=q_offset, kv_len=kv_len, device=q.device)
    if mask.dim() == 3:   # per-batch mask
        mask = mask[:, None]
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l, vq).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    return_lse: bool = False):
    """The flash-attention kernel's function: ``attention`` with what the
    kernel does at the edges, a row with no visible key giving zeros and
    lse -1e30 (where the all-masked softmax of ``attention`` averages V),
    as the reference's kernel gives them when no key tile of the row's
    block is visible. Shapes as ``attention``'s."""
    o, lse = attention(q, k, v, causal=causal, window=window, scale=scale,
                       q_offset=q_offset, return_lse=True)
    empty = ~_attn_mask(q.shape[2], k.shape[2], causal=causal,
                        window=window, q_offset=q_offset, kv_len=None,
                        device=q.device).any(-1)              # (Sq,)
    o = torch.where(empty[:, None], 0.0, o.float()).to(q.dtype)
    lse = torch.where(empty, NEG_INF, lse)
    return (o, lse) if return_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset: int = 0):
    """The flash-attention backward kernels' function, the reference's
    recompute in f32: q, o, do (B, Hq, Sq, D); k, v (B, Hkv, Skv, D); lse
    (B, Hq, Sq) the forward's. p = exp(s - lse) over the pairs the mask
    admits (the mask applied before the exp, so a row that sees no key
    gives dq = 0 and adds nothing to dk and dv), delta = rowsum(do * o),
    ds = p (do.v - delta) scale; dk and dv are summed over each KV head's
    group. One batch row at a time, so the (Hq, Sq, Skv) f32 scores stay
    one row's. Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    mask = _attn_mask(Sq, Skv, causal=causal, window=window,
                      q_offset=q_offset, kv_len=None, device=q.device)
    delta = torch.sum(do.float() * o.float(), dim=-1, keepdim=True)
    dq, dk, dv = [], [], []
    for b in range(B):
        qf, dof = q[b].float(), do[b].float()                # (Hq, Sq, D)
        kq = torch.repeat_interleave(k[b], group, dim=0).float()
        vq = torch.repeat_interleave(v[b], group, dim=0).float()
        s = torch.einsum("hqd,hkd->hqk", qf, kq) * scale
        p = torch.exp(torch.where(mask, s - lse[b, ..., None], NEG_INF))
        dp = torch.einsum("hqd,hkd->hqk", dof, vq)
        ds = p * (dp - delta[b]) * scale
        dq.append(torch.einsum("hqk,hkd->hqd", ds, kq))
        dk.append(torch.einsum("hqk,hqd->hkd", ds, qf)
                  .reshape(Hkv, group, Skv, D).sum(1))
        dv.append(torch.einsum("hqk,hqd->hkd", p, dof)
                  .reshape(Hkv, group, Skv, D).sum(1))
    return (torch.stack(dq).to(q.dtype), torch.stack(dk).to(k.dtype),
            torch.stack(dv).to(v.dtype))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token GQA decode in f32: q (B, Hq, D); kv cache
    (B, Hkv, T, D); ``kv_len`` (B,) masks positions >= kv_len[b]."""
    B, Hq, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kq = torch.repeat_interleave(k, group, dim=1).float()
    vq = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kq) * scale
    if kv_len is not None:
        mask = torch.arange(T, device=q.device)[None, :] < kv_len[:, None]
        s = torch.where(mask[:, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhk,bhkd->bhd", p / l, vq)
    return o.to(q.dtype)


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               kv_len: Optional[torch.Tensor] = None,
               scale: Optional[float] = None) -> torch.Tensor:
    """Ragged batched GQA decode over a dense cache (B, Hkv, T, D): the
    same function as ``decode_attention`` (the kernel's k_splits and
    pack_gqa are pure layout), with what the kernel does at the edges:
    ``kv_len`` is clamped to T and requests with kv_len == 0 return zeros
    (where the all-masked softmax of ``decode_attention`` averages V)."""
    B, T = q.shape[0], k.shape[2]
    if kv_len is None:
        kv_len = torch.full((B,), T, dtype=torch.long, device=q.device)
    lens = torch.clamp(kv_len.long(), 0, T)
    o = decode_attention(q, k, v, kv_len=torch.clamp(lens, min=1),
                         scale=scale)
    return torch.where((lens > 0)[:, None, None], o.float(),
                       0.0).to(q.dtype)


def gqa_decode_kv8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                   kv_len: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Ragged decode over an int8 cache: dequantize it in f32 with its
    per-token-per-head scales, then run the dense ragged decode
    (``gqa_decode``: kv_len clamped to T, zero rows at kv_len 0). q
    (B, Hq, D) float; k, v (B, Hkv, T, D) int8; k_scale, v_scale
    (B, Hkv, T) f32. Returns (B, Hq, D) in q's dtype."""
    kf = k.float() * k_scale.float()[..., None]
    vf = v.float() * v_scale.float()[..., None]
    return gqa_decode(q, kf, vf, kv_len=kv_len, scale=scale)


def gather_pages(pages: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """Densify a paged pool: pages (Hkv, P, page_size, D) + block tables
    (B, max_pages) -> contiguous (B, Hkv, max_pages * page_size, D)."""
    Hkv, _, page_size, D = pages.shape
    B, n_blocks = block_tables.shape
    dense = pages[:, block_tables.long()]     # (Hkv, B, n_blocks, ps, D)
    return dense.transpose(0, 1).reshape(B, Hkv, n_blocks * page_size, D)


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 kv_len: torch.Tensor, *,
                 k_scales: Optional[torch.Tensor] = None,
                 v_scales: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode: gather each sequence's pages into a dense cache and run
    the dense ragged decode. ``kv_len`` is clamped to the table capacity;
    rows with kv_len == 0 (inactive batch slots) return zeros. Int8 pools
    (the kv8 policy) come with per-token ``k_scales``/``v_scales``
    (Hkv, P, page_size) and are dequantized in f32, gathered with their
    scales through the same tables (the reference dequantizes the pool
    before the gather: the same values, elementwise)."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    if k_scales is not None:
        k = k.float() * gather_pages(k_scales[..., None], block_tables)
        v = v.float() * gather_pages(v_scales[..., None], block_tables)
    return gqa_decode(q, k, v, kv_len=kv_len, scale=scale)


def paged_verify(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 kv_len: torch.Tensor, *,
                 k_scales: Optional[torch.Tensor] = None,
                 v_scales: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Speculative verify: gather each sequence's pages dense, then score
    K consecutive query positions with a per-sequence causal tail.

    q (B, K, Hq, D); ``kv_len`` (B,) counts valid tokens *including* the K
    scattered draft positions and is clamped to the table capacity, so
    query t (absolute position ``kv_len - K + t``) attends
    ``k_pos <= kv_len - K + t``. Probabilities outside that window are
    zeroed, so query rows with an empty window (inactive slots,
    ``kv_len < K`` tails) return exact zeros. Int8 pools (the kv8 policy)
    come with per-token ``k_scales``/``v_scales`` (Hkv, P, page_size) and
    are dequantized in f32 after the gather, as ``paged_decode``'s. Returns
    (B, K, Hq, D) in q's dtype."""
    B, K, Hq, D = q.shape
    k = gather_pages(k_pages, block_tables)     # (B, Hkv, T, D)
    v = gather_pages(v_pages, block_tables)
    if k_scales is not None:
        k = k.float() * gather_pages(k_scales[..., None], block_tables)
        v = v.float() * gather_pages(v_scales[..., None], block_tables)
    Hkv, T = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kq = torch.repeat_interleave(k, group, dim=1).float()
    vq = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bqhd,bhkd->bhqk", q.float(), kq) * scale
    lens = torch.clamp(kv_len.long(), 0, T)
    q_pos = (lens[:, None] - K
             + torch.arange(K, device=q.device)[None, :])      # (B, K)
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= q_pos[:, :, None])[:, None]                     # (B,1,K,T)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bhkd->bqhd", p, vq)
    return o.to(q.dtype)


def mla_decode(q_abs: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor,
               krope: torch.Tensor, *, kv_len: Optional[torch.Tensor] = None,
               scale: float = 1.0) -> torch.Tensor:
    """Absorbed-MLA decode in f32, the reference's oracle: q_abs (B, H, C)
    queries with W_uk absorbed; q_rope (B, H, R); ckv (B, T, C) latent
    cache; krope (B, T, R). ``kv_len`` (B,) masks positions >= kv_len[b]
    (a row with kv_len 0 averages ckv, as the oracle's softmax does).
    Returns the attended latent context (B, H, C) f32; W_uv applies
    downstream."""
    s = torch.einsum("bhc,btc->bht", q_abs.float(), ckv.float())
    s = s + torch.einsum("bhr,btr->bht", q_rope.float(), krope.float())
    s = s * scale
    if kv_len is not None:
        T = ckv.shape[1]
        s = torch.where(torch.arange(T, device=s.device)[None, None, :]
                        < kv_len.to(s.device)[:, None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bht,btc->bhc", p, ckv.float())


def mla_decode_ragged(q_abs: torch.Tensor, q_rope: torch.Tensor,
                      ckv: torch.Tensor, krope: torch.Tensor, *,
                      kv_len: Optional[torch.Tensor] = None,
                      scale: float = 1.0) -> torch.Tensor:
    """The mla_decode kernel's function: ``mla_decode`` with what the
    kernel does at the edges, ``kv_len`` clamped to T (past T means the
    whole cache) and a row with kv_len 0 giving zeros (where the oracle's
    all-masked softmax averages ckv). Shapes as ``mla_decode``'s; returns
    (B, H, C) f32."""
    B, T = ckv.shape[0], ckv.shape[1]
    if kv_len is None:
        kv_len = torch.full((B,), T, dtype=torch.long, device=ckv.device)
    lens = torch.clamp(kv_len.long().to(ckv.device), 0, T)
    o = mla_decode(q_abs, q_rope, ckv, krope,
                   kv_len=torch.clamp(lens, min=1), scale=scale)
    return torch.where((lens > 0)[:, None, None], o, 0.0)


def matmul_w8a8(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """w8a8 GEMM: dequantize both int8 operands, multiply in f32. x (M, K)
    int8 with x_scale (M, 1) or one value; w (K, N) int8, any strides,
    with w_scale (1, N) or one value. Returns (M, N) float32."""
    xs = x_scale.float().reshape(-1, 1)
    ws = w_scale.float().reshape(1, -1)
    return (x.float() * xs) @ (w.float() * ws)


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ y (K, N) multiplied in f32, cast to x's dtype. On the card
    it is IEEE f32 only while ``torch.backends.cuda.matmul.allow_tf32``
    stays off, PyTorch's default."""
    return (x.float() @ y.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS layer norm over the last axis, f32 inside, cast back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * (var + eps) ** -0.5 * weight.float()).to(x.dtype)
