"""RMS norm as a Triton kernel for Hopper.

Replaces the TPU kernel ``rms_norm`` / ``_rms_kernel`` of
``src/repro/kernels/rms_norm.py``. A row reduction fused with an
elementwise scale: one program normalizes ``block_rows`` rows at the full
padded width (D = 3072 → a 4096-wide masked block), with the sum of
squares in fp32, and writes each row back in the input dtype.

Bound: memory. It reads x and the weight once and writes y once
(2·N·D + D elements), against about 4 flops per element. The design keeps
the row in registers between the reduction and the scale, so x crosses
HBM once; ``block_rows`` and ``num_warps`` trade registers per thread
against programs in flight, and the tuner picks them per shape.

``triton`` is imported inside the launching function: the module imports
where Triton is absent, and CPU tensors take the plain version in
``kernels.ref``.
"""

import threading

import torch

from repro_torch.kernels import ref

_kernel = None
_lock = threading.Lock()


def _get_kernel():
    # ``tl`` is bound as a module global: Triton resolves the names a
    # kernel uses through its function's globals.
    global _kernel, tl
    with _lock:
        if _kernel is None:
            import triton
            import triton.language as tl

            @triton.jit
            def _rms_kernel(x_ptr, w_ptr, o_ptr, n_rows, n_cols, stride,
                            eps, BLOCK_ROWS: tl.constexpr,
                            BLOCK_D: tl.constexpr):
                rows = tl.program_id(0) * BLOCK_ROWS + tl.arange(
                    0, BLOCK_ROWS)
                cols = tl.arange(0, BLOCK_D)
                cmask = cols < n_cols
                mask = (rows < n_rows)[:, None] & cmask[None, :]
                offs = rows.to(tl.int64)[:, None] * stride + cols[None, :]
                x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(
                    tl.float32)
                var = tl.sum(x * x, axis=1) / n_cols
                r = 1.0 / tl.sqrt(var + eps)
                w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(
                    tl.float32)
                y = x * r[:, None] * w[None, :]
                tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty),
                         mask=mask)

            _kernel = _rms_kernel
        return _kernel


def padded_width(D: int) -> int:
    """The power-of-two block width a row of D elements occupies."""
    return 1 << max(0, (D - 1).bit_length())


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
             block_rows: int = 1, num_warps: int = 4) -> torch.Tensor:
    """x (..., D) RMS-normalized over D and scaled by weight (D,)."""
    if not x.is_cuda:
        return ref.rms_norm(x, weight, eps)
    D = x.shape[-1]
    bad = [msg for ok, msg in [
        (x.dtype in (torch.float32, torch.bfloat16, torch.float16),
         f"dtype {x.dtype}"),
        (weight.shape == (D,), f"weight shape {tuple(weight.shape)} != ({D},)"),
        (weight.is_cuda and weight.device == x.device, "weight device"),
        (block_rows >= 1 and block_rows & (block_rows - 1) == 0,
         f"block_rows {block_rows} is not a power of two"),
        (num_warps in (1, 2, 4, 8, 16, 32), f"num_warps {num_warps}"),
    ] if not ok]
    if bad:
        raise ValueError("rms_norm: " + "; ".join(bad))
    x2 = x.reshape(-1, D).contiguous()
    w = weight.contiguous()
    out = torch.empty_like(x2)
    n = x2.shape[0]
    if n:
        grid = (-(-n // block_rows),)
        _get_kernel()[grid](x2, w, out, n, D, x2.stride(0), eps,
                            BLOCK_ROWS=block_rows, BLOCK_D=padded_width(D),
                            num_warps=num_warps)
        rms_norm.launches += 1
    return out.reshape(x.shape)


rms_norm.launches = 0
