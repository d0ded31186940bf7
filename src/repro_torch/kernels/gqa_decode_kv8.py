"""Ragged GQA decode over an int8 dense KV cache (the kv8 policy): the
wrapper around ``csrc/gqa_decode_kv8.cu``.

The CUDA C++ kernel replaces the TPU kernel ``_kv8_kernel`` of
``src/repro/kernels/gqa_decode_kv8.py``. It is the kernel template of
``csrc/gqa_decode.cuh`` built for int8 rows with per-token, per-head f32
scales, so this wrapper shares ``kernels.gqa_decode.launch`` (operand
checks, splits, the combine) as ``kernels.decode_attention`` does, and
counts its own launches. The source's header note says what bounds it on
Hopper (HBM bytes: D + 4 bytes a cached row where bf16 takes 2 D) and what
the int8 rows change in the design.

Layout: the serving cache stores k, v (B, T, Hkv, D) int8 and their scales
(B, T, Hkv) f32, the kv8 wire format of ``repro_torch.quant.quantize_kv``;
``models.attention.attn_decode`` hands the kernel the (B, Hkv, T, D) and
(B, Hkv, T) transposed views, and no step copies the cache or its scales.

Tunables (``kernels.ops.GQA_DECODE_KV8``): ``block_kv``, ``k_splits``,
``pack_gqa`` and ``num_warps``, as for the float kernel. Tensors on the
CPU take the plain version ``kernels.ref.gqa_decode_kv8``; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import gqa_decode as gqa_kernel


def gqa_decode_kv8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                   kv_len: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None, block_kv: int = 128,
                   k_splits: int = 1, pack_gqa: bool = True,
                   num_warps: int = 4) -> torch.Tensor:
    """Ragged batched GQA decode over an int8 cache. q (B, Hq, D) float32
    or bfloat16; k, v (B, Hkv, T, D) int8, any strides with D contiguous;
    k_scale, v_scale (B, Hkv, T) float32, any strides; kv_len (B,) int,
    clamped to T (None: all T). Requests with kv_len == 0 get zeros.
    Returns (B, Hq, D) in q's dtype."""
    out = gqa_kernel.launch(q, k, v, kv_len, scale=scale, block_kv=block_kv,
                            k_splits=k_splits, pack_gqa=pack_gqa,
                            num_warps=num_warps, name="gqa_decode_kv8",
                            scales=(k_scale, v_scale))
    if q.is_cuda:
        gqa_decode_kv8.launches += 1
    return out


gqa_decode_kv8.launches = 0
