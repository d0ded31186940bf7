"""Flash-decode attention over a dense KV cache, all heads of a query group
packed as rows of one block.

Shares its kernel with ``kernels.gqa_decode`` (``csrc/gqa_decode.cu``), as
the reference's ``decode_attention`` and ``gqa_decode`` share
``_decode_kernel``: this entry point is that kernel with ``pack_gqa``
fixed on. It replaces the TPU kernel ``decode_attention`` of
``src/repro/kernels/decode_attention.py``; its default ``k_splits`` is the
reference's 4.

Tunables (``kernels.ops.DECODE_ATTENTION``): ``block_kv``, ``k_splits``
and ``num_warps``. Tensors on the CPU take the plain version in
``kernels.ref``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import gqa_decode as gqa_kernel


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None, block_kv: int = 64,
                     k_splits: int = 4, num_warps: int = 4) -> torch.Tensor:
    """Single-token decode. q (B, Hq, D); k, v (B, Hkv, T, D) float32 or
    bfloat16 (q's dtype), D contiguous; kv_len optional (B,) int, clamped
    to T; requests with kv_len == 0 get zeros. Returns (B, Hq, D)."""
    out = gqa_kernel.launch(q, k, v, kv_len, scale=scale, block_kv=block_kv,
                            k_splits=k_splits, pack_gqa=True,
                            num_warps=num_warps, name="decode_attention")
    if q.is_cuda:
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
