"""Quantized serving (the port of ``repro.quant``): the named policies,
the int8 wire format of the KV cache, and quantized weights.

    policy.py    — named dtype policies (w8a8 / w8a16 / kv8)
    calibrate.py — absmax and percentile scales, quantize / dequantize,
                   ``quantize_kv``
    qtensor.py   — ``QTensor`` (packed int8 weight + per-channel scale),
                   ``quantize_params`` (the MLP projections) and
                   ``qmatmul`` (the sim GEMM, or ``matmul_w8a8``)

The kernels that read the kv8 cache, ``gqa_decode_kv8`` (dense caches)
and the int8 branches of ``paged_decode`` and ``paged_verify`` (page
pools), and the w8a8 GEMM ``matmul_w8a8`` live with their peers in
``repro_torch.kernels``. The launcher serves w8a8 on the dense path;
w8a16, and both weight policies on the paged engine, are a later slice.
"""

from repro_torch.quant.calibrate import (  # noqa: F401
    QMAX, absmax_scale, compute_scale, dequantize, percentile_scale, quantize,
    quantize_dynamic, quantize_kv,
)
from repro_torch.quant.policy import POLICIES, QuantPolicy, get_policy  # noqa: F401
from repro_torch.quant.qtensor import (  # noqa: F401
    QTensor, qmatmul, quantize_params, quantize_tensor,
)
