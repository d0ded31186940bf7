"""The port's blocked matmul held against the JAX package's.

The plain ``matmul`` (what the CUDA kernel's wrapper runs on the CPU)
against the reference's oracle ``ref.matmul`` and its TPU kernel
``_matmul_kernel`` in interpret mode, on numpy operands from a seed: one
ragged f32 case and one bf16 case. Then what the CPU can check of the
Hopper kernel around it: its space keeps the reference's tunable names and
every valid config fits one block's shared memory and registers,
``canonicalize`` clamps blocks to the shape, the workload counts 2·M·K·N
operations, and a CPU tensor takes the plain version; the version-2 space's
fits equal the CUDA source's formulas (read out of ``csrc/matmul.cu``),
each shape chip_smoke and the shipped DB use has valid configs and a valid
heuristic, and the layout rule sends each to its kernel (wgmma, mma.sync
or the f32 FMAs). Tolerances: the
reference's (``tests/test_kernel_oracles.py`` ``_tol``): f32 1e-4, bf16
2e-2. The CUDA kernel is held against the plain version on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.matmul import matmul as jax_matmul

from repro_torch.core import cpu_host, get_chip, roofline_seconds
from repro_torch.kernels import matmul as mm_kernel
from repro_torch.kernels import ops, ref

from test_torch_flash_hopper import c_function

H100 = get_chip("NVIDIA H100 80GB HBM3 (SXM)")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype,shape", [("float32", (37, 300, 136)),
                                         ("bfloat16", (64, 128, 96))])
def test_plain_matmul_matches_the_reference_and_the_pallas_kernel(dtype,
                                                                  shape):
    x, y = _operands(sum(shape), *shape)
    if dtype == "bfloat16":
        x, y = _bf16(x), _bf16(y)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    xt, yt = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    ours = ref.matmul(xt, yt)
    assert ours.dtype == tdt and ours.shape == (shape[0], shape[2])
    ours = ours.float().numpy()
    oracle = np.asarray(jref.matmul(jnp.asarray(x, jdt), jnp.asarray(y, jdt))
                        .astype(jnp.float32))
    pallas = np.asarray(jax_matmul(jnp.asarray(x, jdt), jnp.asarray(y, jdt),
                                   block_m=64, block_n=128, block_k=128,
                                   interpret=True).astype(jnp.float32))
    tol = TOL[dtype]
    np.testing.assert_allclose(ours, oracle, atol=tol, rtol=tol)
    np.testing.assert_allclose(ours, pallas, atol=tol, rtol=tol)
    # the autotuned entry point on CPU tensors is the plain version
    got = ops.matmul(xt, yt)
    assert torch.equal(got, ref.matmul(xt, yt))


def test_space_keeps_the_reference_names_and_fits_the_card():
    names = [p.name for p in ops.MATMUL.space.params]
    theirs = [p.name for p in jops.MATMUL.space.params]
    assert names[:3] == theirs == ["block_m", "block_n", "block_k"]
    assert names[3:] == ["num_warps", "num_stages"]
    assert ops.MATMUL.version == ops.MATMUL.space.version == 2
    for dtype, itemsize in (("bfloat16", 2), ("float32", 4)):
        for M, K, N in ((8192, 8192, 8192), (256, 256, 256), (200, 300, 136)):
            ctx = ops.matmul_context(H100, M, K, N, dtype)
            valid = ops.MATMUL.space.valid_configs(ctx)
            every = list(ops.MATMUL.space.iter_all())
            assert 0 < len(valid) < len(every)
            wgmma = dtype == "bfloat16" and K % 8 == 0
            for cfg in every:
                if wgmma:
                    fits = (mm_kernel.wgmma_smem_bytes(
                        cfg["block_m"], cfg["block_n"], cfg["num_stages"])
                        <= H100.smem_per_block
                        and cfg["block_m"] in (64, 128)
                        and cfg["num_warps"] == cfg["block_m"] // 16
                        and cfg["block_k"] == 64)
                else:
                    fits = (mm_kernel.smem_bytes(
                        itemsize, cfg["block_m"], cfg["block_n"],
                        cfg["block_k"], cfg["num_stages"])
                        <= H100.smem_per_block
                        and cfg["block_m"] * cfg["block_n"]
                        <= 4096 * cfg["num_warps"])
                assert (cfg in valid) == fits, cfg
            assert ops.MATMUL.default_config(ctx) == (
                {"block_m": 128, "block_n": 256, "block_k": 64,
                 "num_warps": 8, "num_stages": 3} if wgmma else
                {"block_m": 128, "block_n": 128, "block_k": 32,
                 "num_warps": 4, "num_stages": 3})
    # bf16's stages fit where f32's do not: 256 x 128 x 64 over 4 stages
    # on the mma.sync kernel (K 300: rows TMA cannot read)
    cfg = {"block_m": 256, "block_n": 128, "block_k": 64, "num_warps": 8,
           "num_stages": 4}
    assert ops.MATMUL.space.is_valid(
        cfg, ops.matmul_context(H100, 256, 300, 256, "bfloat16"))
    assert ops.MATMUL.space.why_invalid(
        cfg, ops.matmul_context(H100, 256, 256, 256, "float32")) == "smem"
    # the wgmma kernel holds 128 x 256 over three stages, not four
    cfg = {"block_m": 128, "block_n": 256, "block_k": 64, "num_warps": 8,
           "num_stages": 4}
    mm8k = ops.matmul_context(H100, 8192, 8192, 8192, "bfloat16")
    assert ops.MATMUL.space.why_invalid(cfg, mm8k) == "smem"
    assert ops.MATMUL.space.is_valid(dict(cfg, num_stages=3), mm8k)
    assert ops.MATMUL.space.why_invalid(dict(cfg, num_stages=3,
                                             num_warps=4),
                                        mm8k) == "registers"


def test_canonicalize_clamps_blocks_to_the_shape():
    cfg = {"block_m": 256, "block_n": 256, "block_k": 64, "num_warps": 8,
           "num_stages": 2}
    small = ops.matmul_context(cpu_host(), 8, 16, 40, "float32")
    assert ops.MATMUL.canonicalize(cfg, small) == {
        "block_m": 64, "block_n": 64, "block_k": 32, "num_warps": 8,
        "num_stages": 2}
    assert mm_kernel.clamp_blocks(256, 256, 64, 8, 40, 16) == (64, 64, 32)
    ragged = ops.matmul_context(cpu_host(), 200, 300, 136, "bfloat16")
    assert ops.MATMUL.canonicalize(cfg, ragged) == cfg
    assert mm_kernel.clamp_blocks(256, 256, 64, 100, 130, 300) == \
        (128, 256, 64)
    # the wgmma path: block_m to the warpgroups that cover M, num_warps
    # after it, block_k the TMA box's 64 whatever K is
    cfg = {"block_m": 128, "block_n": 256, "block_k": 64, "num_warps": 8,
           "num_stages": 3}
    decode = ops.matmul_context(cpu_host(), 8, 3072, 64, "bfloat16")
    assert ops.MATMUL.canonicalize(cfg, decode) == {
        "block_m": 64, "block_n": 64, "block_k": 64, "num_warps": 4,
        "num_stages": 3}
    assert mm_kernel.clamp_blocks(128, 256, 64, 8, 64, 16, "wgmma") == \
        (64, 64, 64)
    assert mm_kernel.clamp_blocks(128, 128, 64, 100, 200, 16, "wgmma") == \
        (128, 128, 64)


def test_wgmma_fits_equal_the_source():
    """``wgmma_smem_bytes``, ``smem_bytes`` and ``regs_fit`` are
    ``wgmma_smem``, ``smem_bytes`` and ``regs_fit`` of ``csrc/matmul.cu``."""
    wgmma_smem = c_function("matmul.cu", "wgmma_smem")
    mma_smem = c_function("matmul.cu", "smem_bytes")
    regs = c_function("matmul.cu", "regs_fit")
    for bm in mm_kernel.BLOCK_M:
        for bn in mm_kernel.BLOCK_N:
            for st in mm_kernel.NUM_STAGES:
                assert mm_kernel.wgmma_smem_bytes(bm, bn, st) == \
                    wgmma_smem(bm, bn, st)
                for bk in mm_kernel.BLOCK_K:
                    for item in (2, 4):
                        assert mm_kernel.smem_bytes(item, bm, bn, bk, st) \
                            == mma_smem(item, bm, bn, bk, st)
            for nw in mm_kernel.NUM_WARPS:
                assert mm_kernel.regs_fit(bm, bn, nw) == bool(
                    regs(bm, bn, nw))


# chip_smoke's matmul cases (ragged rows that TMA cannot read, decode-like
# rows, the registry's m256), mm8k, and rows TMA can read at ragged M and N
SHAPES = [(200, 300, 136), (37, 45, 29), (1000, 1030, 520), (8, 3072, 64),
          (256, 256, 256), (8192, 8192, 8192), (1000, 1024, 520)]


@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_space_at_every_shape(shape, dtype):
    """Valid configs and the heuristic among them; on the wgmma path each
    config is a tile the kernel instantiates."""
    M, K, N = shape
    ctx = ops.matmul_context(H100, M, K, N, dtype)
    valid = ops.MATMUL.space.valid_configs(ctx)
    assert valid and ops.MATMUL.default_config(ctx) in valid
    route = mm_kernel.path(getattr(torch, dtype), K, N)
    for c in valid:
        if route == "wgmma":
            assert mm_kernel.wgmma_tile_ok(c["block_m"], c["block_k"],
                                           c["num_warps"])
            assert mm_kernel.wgmma_smem_bytes(
                c["block_m"], c["block_n"], c["num_stages"]) <= \
                H100.smem_per_block


def test_layout_rule_sends_each_shape_to_its_kernel():
    """mm8k, m256 in bf16 and a contiguous (8, 3072) x (3072, 64) take
    wgmma; K 45, K 300 and N 29 (rows of no 16-byte multiple) and a base
    off 16 bytes take mma.sync; float32 takes the FMAs. A pure function of
    the layout, so the space and the wrapper agree."""
    bf = torch.bfloat16
    assert mm_kernel.path(bf, 8192, 8192) == "wgmma"
    assert mm_kernel.path(bf, 256, 256) == "wgmma"
    x = torch.empty(8, 3072, dtype=bf)
    y = torch.empty(3072, 64, dtype=bf)
    assert mm_kernel.path(bf, 3072, 64, x.data_ptr(), y.data_ptr()) == \
        "wgmma"
    assert mm_kernel.tma_layout_error(3072, 64, 2, x.data_ptr(),
                                      y.data_ptr()) is None
    for K, N in ((45, 29), (300, 136), (1030, 520), (64, 29)):
        assert mm_kernel.path(bf, K, N) == "mma_sync", (K, N)
        assert "16-byte" in mm_kernel.tma_layout_error(K, N, 2)
    flat = torch.empty(8 * 64 + 8, dtype=bf)
    off = flat[1:1 + 8 * 64].view(8, 64)
    assert mm_kernel.path(bf, 64, 64, off.data_ptr(), y.data_ptr()) == \
        "mma_sync"
    assert "aligned" in mm_kernel.tma_layout_error(64, 64, 2,
                                                   off.data_ptr(), 0)
    assert mm_kernel.path(torch.float32, 8192, 8192) == "fma"
    for M, K, N in SHAPES:
        ctx = ops.matmul_context(H100, M, K, N, "bfloat16")
        assert ops._mm_path(ctx) == mm_kernel.path(bf, K, N)


def test_workload_counts_two_mkn_operations():
    for dtype, itemsize, (M, K, N), ms in (
            ("bfloat16", 2, (8192, 8192, 8192), 1.1117),
            ("float32", 4, (256, 256, 256), 0.0005)):
        ctx = ops.matmul_context(H100, M, K, N, dtype)
        w = ops.MATMUL.workload_fn(ops.MATMUL.default_config(ctx), ctx)
        assert w.flops == 2.0 * M * K * N
        assert w.hbm_bytes == (M * K + K * N + M * N) * itemsize
        assert w.dtype == dtype
        t, by = roofline_seconds(w, H100)
        assert by == "operations" and round(t * 1e3, 4) == ms


def test_cpu_tensors_take_the_plain_version():
    x, y = _operands(5, 20, 33, 17)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    before = mm_kernel.matmul.launches
    for cfg in ({}, {"block_m": 256, "block_n": 64, "block_k": 64,
                     "num_warps": 8, "num_stages": 4}):
        assert torch.equal(mm_kernel.matmul(xt, yt, **cfg),
                           ref.matmul(xt, yt))
    assert mm_kernel.matmul.launches == before
    with pytest.raises(ValueError, match="disagree on K"):
        mm_kernel.matmul(xt, yt[1:])
    with pytest.raises(ValueError, match="differ"):
        mm_kernel.matmul(xt, yt.double())
    with pytest.raises(ValueError, match="matrices"):
        mm_kernel.matmul(xt[None], yt)
