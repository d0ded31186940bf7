"""Quantized serving (the port of ``repro.quant``, the kv8 subset): the
named policies and the int8 wire format of the KV cache.

    policy.py    — named dtype policies (w8a8 / w8a16 / kv8)
    calibrate.py — absmax scales, quantize / dequantize, ``quantize_kv``

The kernels that read the kv8 cache, ``gqa_decode_kv8`` (dense caches)
and the int8 branches of ``paged_decode`` and ``paged_verify`` (page
pools), live with their peers in ``repro_torch.kernels``. The weight policies (``QTensor``,
``quantize_params``, ``matmul_w8a8``) are a later slice of the port.
"""

from repro_torch.quant.calibrate import (  # noqa: F401
    QMAX, absmax_scale, dequantize, quantize, quantize_dynamic, quantize_kv,
)
from repro_torch.quant.policy import POLICIES, QuantPolicy, get_policy  # noqa: F401
