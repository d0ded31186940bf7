"""PyTorch + CUDA port of the autotuned serving system, for one NVIDIA H100.

The JAX package ``repro`` stays the reference. This package mirrors it
subpackage by subpackage (``models``, ``configs``, ``kernels``, ``core``,
``serving``, ``launch``) so every module here has one counterpart there.
It imports ``torch`` and never ``jax``, and nothing of ``repro``.

Plain tensor code is PyTorch; every kernel on the serving paths is written
by hand for Hopper: ``kernels.paged_decode``, ``kernels.paged_verify`` and
``kernels.gqa_decode`` / ``kernels.decode_attention`` (CUDA C++, under
``csrc/``) and ``kernels.rms_norm`` (Triton), each registered in
``kernels.registry``. Each has a plain PyTorch version in ``kernels.ref``
that its wrapper runs only for tensors on the CPU.
"""
