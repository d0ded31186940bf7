"""QTensor: a quantized weight that stands where a parameter stood (the
port of ``repro.quant.qtensor``).

A ``QTensor`` holds the packed int8 values of a (K, N) projection weight,
its broadcastable float32 scale (one per output channel: (1, N)) and
``act_quant``, whether the GEMM that consumes it also quantizes its
activation operand per token (w8a8) or keeps it in full precision
(w8a16). It is an ``nn.Module`` with the two tensors as buffers, so it
takes a parameter's place in its module (``quantize_params`` deletes the
parameter, and with it the full-precision weight) and
``model.to(device)`` moves it.

Layout. The values are the (K, N) view, strides (1, K), of an (N, K)
contiguous int8 tensor made once at quantize time: the CUDA
``matmul_w8a8`` reads each output column's K values contiguously (the
``.col`` B operand of its int8 MMA). Logically they are the reference's
(K, N) values; their storage is ``values.T``.

The reference keeps two storage modes (int8, and the same integers in
float32 for its host simulation). The port stores int8 only and widens it
per call on the ``"sim"`` path: integer-valued float32 either way, so the
numbers are the same.

``qmatmul(x, qt, impl)`` is the quantized GEMM the model layers call:
``"sim"`` is the exact integer-grid float32 product (the reference
launcher's default), ``"pallas"`` (the reference's name for its kernel
path) quantizes x per token and runs ``kernels.ops.matmul_w8a8`` (the CUDA
kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.quant import calibrate
from repro_torch.quant.policy import QuantPolicy, get_policy


class QTensor(nn.Module):
    """Packed int8 values + broadcastable float32 calibration scale."""

    def __init__(self, values: torch.Tensor, scale: torch.Tensor,
                 act_quant: bool = False):
        super().__init__()
        if values.dtype != torch.int8:
            raise ValueError(f"QTensor values are int8, got {values.dtype}")
        self.register_buffer("values", values)
        self.register_buffer("scale", scale.float())
        self.act_quant = bool(act_quant)

    @property
    def shape(self):
        return tuple(self.values.shape)

    def extra_repr(self) -> str:
        return f"shape={self.shape}, act_quant={self.act_quant}"


def k_major(values: torch.Tensor) -> torch.Tensor:
    """The (K, N) view, strides (1, K), of ``values`` stored (N, K)."""
    return values.t().contiguous().t()


def quantize_tensor(x: torch.Tensor, *, axis=0, method: str = "absmax",
                    percentile: float = 99.9,
                    act_quant: bool = False) -> QTensor:
    """Quantize ``x`` with one scale per slice along the non-reduced axes
    (``calibrate``'s convention: the axes reduced over share a scale).
    Per-output-channel weight scales of a (K, N) projection reduce over
    axis 0; a 2-D weight's values are stored K-major (``k_major``)."""
    scale = calibrate.compute_scale(x, method=method, axis=axis,
                                    percentile=percentile)
    q = calibrate.quantize(x, scale)
    return QTensor(k_major(q) if q.dim() == 2 else q, scale, act_quant)


# The dense-MLP projections (``models.layers.MLP``): attention, embedding
# and norm weights stay in full precision, as the reference keeps them.
_QUANT_LEAVES = ("wi", "wo")


def quantize_params(model: nn.Module, policy) -> nn.Module:
    """Replace the MLP projection weights (``ffn.wi``, ``ffn.wo`` of every
    layer) with QTensors per ``policy``, in place, one scale per output
    channel per layer: the reference's scales of a scan-stacked unit
    sliced per layer (a max over the same values). The full-precision
    weights are released as each is replaced. ``policy`` is a name or a
    ``QuantPolicy``; a None/"none" policy or one without weights leaves
    the model as it is. Returns the model."""
    pol = policy if isinstance(policy, QuantPolicy) else get_policy(policy)
    if pol is None or not pol.quantizes_weights:
        return model
    mlps = [mod for name, mod in model.named_modules()
            if name.rsplit(".", 1)[-1] == "ffn"]
    if any(hasattr(mod, "router") for mod in mlps):
        raise NotImplementedError(
            f"{pol.name} weights on MoE experts: their stacked (E, K, N) "
            f"weights have no quantized path in the port")
    with torch.no_grad():
        for mod in mlps:
            for leaf in _QUANT_LEAVES:
                w = getattr(mod, leaf)
                if isinstance(w, QTensor):
                    continue
                qt = quantize_tensor(w, axis=w.dim() - 2, method=pol.method,
                                     percentile=pol.percentile,
                                     act_quant=pol.quantizes_acts)
                delattr(mod, leaf)          # the parameter goes
                setattr(mod, leaf, qt)
                del w
    return model


def qmatmul(x: torch.Tensor, qt: QTensor, *, impl: str = "sim"
            ) -> torch.Tensor:
    """x (..., K) @ QTensor (K, N) under the weight's recorded policy, in
    x's dtype.

    ``impl="sim"``: the integer-grid product in float32 (w8a8: x
    quantized per token to integers held in float32, times the widened
    int8 values, then ``acc * x_scale * w_scale``; w8a16: x times the
    dequantized weight cast to x's dtype). Exact while every partial sum
    stays below 2**24, as the reference's is. ``impl="pallas"``: x
    quantized per token (``quantize_dynamic``), then the autotuned
    ``matmul_w8a8``; w8a16 weights raise, as the reference's do."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    w_scale = qt.scale.reshape(1, -1)
    if impl == "pallas":
        if not qt.act_quant:
            raise NotImplementedError(
                "matmul_w8a8 kernel path needs an act-quant (w8a8) weight; "
                "w8a16 runs via the sim path")
        from repro_torch.kernels import ops as kops
        xq, xs = calibrate.quantize_dynamic(x2, axis=-1)
        out = kops.matmul_w8a8(xq, qt.values, xs, w_scale)
        return out.reshape(*lead, -1).to(x.dtype)
    if impl != "sim":
        raise ValueError(f"unknown qmatmul impl {impl!r} (sim | pallas)")
    wv = qt.values.float()
    if qt.act_quant:
        xf = x2.float()
        xs = calibrate.absmax_scale(xf, axis=-1)
        acc = torch.round(xf / xs) @ wv
        out = acc * xs * w_scale
    else:
        out = (x2 @ (wv * w_scale).to(x.dtype)).float()
    return out.reshape(*lead, -1).to(x.dtype)
