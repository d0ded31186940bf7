"""The port's w8a8 weight quantization held against the JAX package's.

``quant.quantize_tensor`` / ``quantize_params`` against the reference's
(int8 values and scales byte for byte, per layer out of a stacked unit),
the calibration helpers, the plain ``matmul_w8a8`` (what the CUDA
kernel's wrapper runs on the CPU) against the TPU kernel in interpret mode
and the reference's oracle, ``qmatmul`` against the reference's, the w8a8
dense prefill and decode steps against the reference's ``lm`` on the
reference's own quantized weights, and the launcher's w8a8 tokens against
the reference's ``serve_dense`` steps. All on the CPU, inputs from numpy
with a seed. Tolerances: the reference's (``tests/test_kernel_oracles.py``
``_tol``): f32 1e-4, int8 2e-3 (rtol 1e-4); ``qmatmul`` sim to 1e-6, since
its integer-grid float32 sums are exact (every partial sum here stays far
below 2**24) and the scales multiply in the same order on both sides.
The Hopper kernels' host-side rules are checked too: the fits equal the
CUDA source's formulas, the version-2 space has valid configs and a valid
heuristic at every shape chip_smoke and the shipped DB use, the layout
rule sends each shape to wgmma or mma.sync, and split_k falls where K is
too short to split. The CUDA kernels are held against the plain version on
the card in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import quant as jquant
from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.matmul_int8 import matmul_w8a8 as jax_matmul_w8a8
from repro.models import lm as jlm
from repro.models.param import init_params as jax_init_params

from repro_torch.configs import get_config
from repro_torch.kernels import matmul_w8a8 as mm8_kernel
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.param import from_numpy_tree
from repro_torch.quant import (
    QTensor, calibrate, qmatmul, quantize_params, quantize_tensor,
)
from repro_torch.serving import ServingEngine

from test_torch_flash_hopper import c_function

ARCH = "phi4-mini-3.8b"
F32_TOL = dict(atol=1e-4, rtol=1e-4)
INT8_TOL = dict(atol=2e-3, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weight(seed, shape):
    """A weight with an all-zero output column (the scale floor) and one
    of large magnitude."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0
    w[..., 5] *= 1e3
    return w


def _assert_qtensor_equal(ours: QTensor, values, scale, act_quant):
    """Values and scale byte for byte (the values compared as the (K, N)
    array, stored K-major)."""
    v = ours.values.numpy()
    assert v.dtype == np.int8 and v.shape == np.shape(values)
    assert np.ascontiguousarray(v).tobytes() == \
        np.asarray(values).astype(np.int8).tobytes()
    s = ours.scale.numpy()
    assert s.dtype == np.float32 and s.shape == np.shape(scale)
    assert s.tobytes() == np.asarray(scale).tobytes()
    assert ours.act_quant is act_quant
    if v.ndim == 2:
        assert ours.values.stride() == (1, v.shape[0])    # K-major


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor_matches_the_reference_byte_for_byte(dtype):
    """A (K, N) weight per output channel, and each layer of a stacked
    (reps, K, N) unit against the reference's stacked quantization (its
    (reps, 1, N) scales sliced)."""
    w = _weight(0, (24, 16))
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    tw = _t(w).to(getattr(torch, dtype))
    for act_quant in (True, False):
        theirs = jquant.quantize_tensor(jw, axis=0, act_quant=act_quant)
        _assert_qtensor_equal(quantize_tensor(tw, axis=0,
                                              act_quant=act_quant),
                              theirs.values, theirs.scale, act_quant)
    stacked = _weight(1, (3, 24, 16))
    theirs = jquant.quantize_tensor(
        jnp.asarray(stacked).astype(getattr(jnp, dtype)), axis=1,
        act_quant=True)
    assert np.shape(theirs.scale) == (3, 1, 16)
    for r in range(3):
        ours = quantize_tensor(_t(stacked[r]).to(getattr(torch, dtype)),
                               axis=0, act_quant=True)
        _assert_qtensor_equal(ours, np.asarray(theirs.values)[r],
                              np.asarray(theirs.scale)[r], True)


def test_calibration_scales_match_the_reference():
    """absmax and ``compute_scale`` byte for byte; ``percentile_scale`` to
    rtol 1e-5: both interpolate between the same two order statistics in
    float32, but XLA folds the /100 of the percentile into the index
    product, which moves the interpolation weight by a few ulp."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((37, 29)) * 3).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    for axis in (0, -1, None, (0, 1)):
        want = np.asarray(jquant.compute_scale(jx, axis=axis))
        got = calibrate.compute_scale(tx, axis=axis).numpy()
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
        for pct in (99.9, 50.0, 100.0):
            want = np.asarray(jquant.calibrate.percentile_scale(jx, pct,
                                                                axis=axis))
            got = calibrate.compute_scale(tx, method="percentile", axis=axis,
                                          percentile=pct).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="percentile"):
        calibrate.percentile_scale(tx, 0.0)
    with pytest.raises(ValueError, match="calibration method"):
        calibrate.compute_scale(tx, method="mse")


def _gemm_operands(seed, M, K, N, gran):
    """x (M, K), w (K, N) quantized by the reference's calibration, numpy
    out: (x int8, w int8, x_scale, w_scale)."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((K, N)).astype(np.float32))
    per_tensor = gran == "per_tensor"
    xs = jquant.absmax_scale(x, axis=None if per_tensor else -1)
    ws = jquant.absmax_scale(w, axis=None if per_tensor else 0)
    return tuple(np.asarray(a) for a in (jquant.quantize(x, xs),
                                         jquant.quantize(w, ws), xs, ws))


def _ours(xq, wq, xs, ws, **cfg):
    """The port's wrapper on CPU tensors, w K-major as serving holds it."""
    w = _t(wq).t().contiguous().t()
    return mm8_kernel.matmul_w8a8(_t(xq), w, _t(xs), _t(ws), **cfg).numpy()


# Two interpret-mode cases of the TPU kernel, ragged (100 x 200 x 96).
PALLAS_CASES = [("epilogue", "per_channel"), ("inline", "per_tensor")]


@pytest.mark.parametrize("dequant,gran", PALLAS_CASES)
def test_plain_matmul_w8a8_matches_pallas(dequant, gran):
    args = _gemm_operands(3, 100, 200, 96, gran)
    ours = _ours(*args, dequant=dequant, scale_gran=gran)
    pallas = jax_matmul_w8a8(*(jnp.asarray(a) for a in args),
                             dequant=dequant, scale_gran=gran,
                             interpret=True)
    assert ours.shape == (100, 96) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, np.asarray(pallas), **INT8_TOL)


@pytest.mark.parametrize("dequant", ["epilogue", "inline"])
@pytest.mark.parametrize("gran", ["per_channel", "per_tensor"])
def test_plain_matmul_w8a8_matches_the_reference_oracle(dequant, gran):
    args = _gemm_operands(4, 33, 64, 40, gran)
    ours = _ours(*args, dequant=dequant, scale_gran=gran)
    want = np.asarray(jref.matmul_w8a8(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(ours, want, **F32_TOL)


def test_matmul_w8a8_cpu_runs_plain_and_counts_nothing():
    xq, wq, xs, ws = (_t(a) for a in _gemm_operands(5, 8, 64, 40,
                                                     "per_channel"))
    w = wq.t().contiguous().t()
    before = mm8_kernel.matmul_w8a8.launches
    out = ops.matmul_w8a8(xq, w, xs, ws)          # no tuning on the CPU
    from repro_torch.kernels import ref
    torch.testing.assert_close(out, ref.matmul_w8a8(xq, w, xs, ws),
                               rtol=0, atol=0)
    assert mm8_kernel.matmul_w8a8.launches == before
    with pytest.raises(ValueError, match="per_channel scales"):
        mm8_kernel.matmul_w8a8(xq, w, xs[:4], ws)
    with pytest.raises(ValueError, match="per_tensor scales"):
        mm8_kernel.matmul_w8a8(xq, w, xs, ws, scale_gran="per_tensor")
    with pytest.raises(ValueError, match="int8"):
        mm8_kernel.matmul_w8a8(xq.float(), w, xs, ws)


# The Hopper kernels' host-side rules: what decides which kernel a launch
# takes and which configs the version-2 space holds is Python; the fits
# equal the CUDA source's formulas (read out of csrc/matmul_w8a8.cu).
# chip_smoke's shapes: phi4-mini's four serving GEMMs, its ragged ones, and
# the shipped DB's two.
W8A8_SERVING = [(4096, 3072, 16384), (4096, 8192, 3072), (8, 3072, 16384),
                (8, 8192, 3072)]
W8A8_RAGGED = [(M, K, N) for M in (8, 100, 257) for K in (200, 3072)
               for N in (96, 3072)]
W8A8_DB = [(8192, 8192, 8192), (512, 4096, 4096)]


def test_w8a8_fits_equal_the_source():
    """``wgmma_smem_bytes``, ``wgmma_regs_fit`` and ``effective_splits``
    are the source's ``wgmma_smem``, ``wgmma_regs_fit`` and
    ``effective_splits``."""
    wgmma_smem = c_function("matmul_w8a8.cu", "wgmma_smem")
    wgmma_regs = c_function("matmul_w8a8.cu", "wgmma_regs_fit")
    splits = c_function("matmul_w8a8.cu", "effective_splits")
    for bm in mm8_kernel.BLOCK_M:
        for bn in mm8_kernel.BLOCK_N:
            for st in mm8_kernel.NUM_STAGES:
                assert mm8_kernel.wgmma_smem_bytes(bm, bn, st) == \
                    wgmma_smem(bm, bn, st)
            n = bm if mm8_kernel.swapped(bm) else bn
            for dq in ("epilogue", "inline"):
                assert mm8_kernel.wgmma_regs_fit(bm, bn, dq) == bool(
                    wgmma_regs(n, dq == "inline"))
    for K in (16, 128, 200, 3072, 8192, 8320):
        for sk in mm8_kernel.SPLIT_K:
            assert mm8_kernel.effective_splits(K, sk) == splits(K, sk)


@pytest.mark.parametrize("gran", ["per_channel", "per_tensor"])
@pytest.mark.parametrize(
    "shape", W8A8_SERVING + W8A8_RAGGED + W8A8_DB,
    ids=lambda s: "x".join(map(str, s)))
def test_w8a8_space_at_every_shape(shape, gran):
    """Valid configs and the heuristic among them at each granularity; on
    the wgmma path the operands swap roles exactly at M <= 32, split-K only
    there, and every config is a tile the kernel instantiates; on the
    mma.sync path none of the wgmma kernel's knobs moves."""
    from repro_torch.core.hardware import chip_from_properties
    h100 = chip_from_properties("NVIDIA H100 80GB HBM3", 132, 232448,
                                50 * 2**20, 80 * 2**30)
    M, K, N = shape
    ctx = ops.matmul_w8a8_context(h100, M, K, N, gran)
    valid = ops.MATMUL_W8A8.space.valid_configs(ctx)
    assert valid and ops.MATMUL_W8A8.default_config(ctx) in valid
    route = mm8_kernel.path(K)
    for c in valid:
        assert c["scale_gran"] == gran
        if route == "wgmma":
            assert mm8_kernel.swapped(c["block_m"]) == (M <= 32)
            assert c["split_k"] == 1 or M <= 32
            assert mm8_kernel.wgmma_tile_ok(c["block_m"], c["block_n"],
                                            c["block_k"], c["num_warps"])
            assert mm8_kernel.wgmma_regs_fit(c["block_m"], c["block_n"],
                                             c["dequant"])
            assert mm8_kernel.wgmma_smem_bytes(
                c["block_m"], c["block_n"], c["num_stages"]) <= \
                h100.smem_per_block
        else:
            assert c["num_stages"] == 2 and c["split_k"] == 1
            assert mm8_kernel.regs_fit(c["block_m"], c["block_n"],
                                       c["num_warps"], c["dequant"])
    if route == "wgmma" and M <= 32:
        assert max(c["split_k"] for c in valid) == 16


def test_w8a8_layout_rule_sends_each_shape_to_its_kernel():
    """K a multiple of 16 with aligned bases takes wgmma (every serving
    and DB shape, K 3072 and 8192), K 200 takes mma.sync, as does a base
    off 16 bytes. A pure function of the layout."""
    for M, K, N in W8A8_SERVING + W8A8_DB:
        assert mm8_kernel.path(K) == "wgmma"
    assert mm8_kernel.path(200) == "mma_sync"
    assert "16-byte" in mm8_kernel.tma_layout_error(200)
    x = torch.empty(8, 3072, dtype=torch.int8)
    w = torch.empty(64, 3072, dtype=torch.int8)
    assert mm8_kernel.path(3072, x.data_ptr(), w.data_ptr()) == "wgmma"
    flat = torch.empty(8 * 3072 + 16, dtype=torch.int8)
    off = flat[4:4 + 8 * 3072]
    assert mm8_kernel.path(3072, off.data_ptr(), w.data_ptr()) == \
        "mma_sync"
    assert "aligned" in mm8_kernel.tma_layout_error(3072, off.data_ptr())


def test_w8a8_split_k_canonicalises_down_where_k_is_short():
    """The splits that run: each takes ceil(slices / split_k) slices of 128
    bytes of K and none is empty, so split_k falls where K has too few
    slices; canonical configs that launch the same splits are timed once.
    The space holds no more splits than slices."""
    from repro_torch.core import cpu_host
    cfg = {"block_m": 8, "block_n": 128, "block_k": 128, "num_warps": 8,
           "num_stages": 4, "split_k": 16, "dequant": "epilogue",
           "scale_gran": "per_channel"}
    for K, want in ((128, 1), (256, 2), (1024, 8), (3072, 12), (8192, 16)):
        ctx = ops.matmul_w8a8_context(cpu_host(), 8, K, 3072)
        canon = ops.MATMUL_W8A8.canonicalize(cfg, ctx)
        assert canon["split_k"] == want, K
        assert mm8_kernel.effective_splits(K, 16) == want
    short = ops.matmul_w8a8_context(cpu_host(), 8, 256, 3072)
    assert ops.MATMUL_W8A8.space.why_invalid(cfg, short) == \
        "split_k<=slices"
    assert ops.MATMUL_W8A8.space.is_valid(dict(cfg, split_k=2), short)
    # K 200 takes mma.sync: split_k and num_stages canonicalise away
    ragged = ops.matmul_w8a8_context(cpu_host(), 8, 200, 96)
    canon = ops.MATMUL_W8A8.canonicalize(
        dict(cfg, block_k=64, num_warps=4, split_k=4), ragged)
    assert canon["split_k"] == 1 and canon["num_stages"] == 2
    assert canon["block_m"] == 16
    assert mm8_kernel.clamp_blocks(8, 128, 128, 8, 100, 128, "wgmma") == \
        (8, 128, 128)
    assert mm8_kernel.clamp_blocks(128, 256, 128, 100, 96, 3072,
                                   "wgmma") == (128, 128, 128)


def test_qmatmul_matches_the_reference():
    """sim against the reference's sim: w8a8 to 1e-6 (exact integer grid),
    w8a16 at f32 (a float product); the port's "pallas" on the CPU (the
    plain version) against sim at the reference's 2e-3 / 1e-3
    (``tests/test_quant.py::test_qmatmul_pallas_matches_sim``); a w8a16
    weight under "pallas" raises, as the reference's does."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    for act_quant in (True, False):
        jq = jquant.quantize_tensor(jnp.asarray(w), axis=0,
                                    act_quant=act_quant)
        tq = quantize_tensor(_t(w), axis=0, act_quant=act_quant)
        want = np.asarray(jquant.qmatmul(jnp.asarray(x), jq, impl="sim"))
        got = qmatmul(_t(x), tq, impl="sim").numpy()
        assert got.shape == (2, 8, 64) and got.dtype == np.float32
        tol = dict(atol=1e-6, rtol=1e-6) if act_quant else F32_TOL
        np.testing.assert_allclose(got, want, **tol)
        if act_quant:
            np.testing.assert_allclose(
                qmatmul(_t(x), tq, impl="pallas").numpy(), got, atol=2e-3,
                rtol=1e-3)
        else:
            with pytest.raises(NotImplementedError, match="w8a16"):
                qmatmul(_t(x), tq, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        qmatmul(_t(x), tq, impl="xla")


@pytest.fixture(scope="module")
def both():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = jax_init_params(jax.random.PRNGKey(0), jlm.lm_specs(jcfg))
    cfg = get_config(ARCH, smoke=True)
    return jcfg, jparams, cfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ffn(params, layer, cfg):
    """Layer ``layer``'s reference MLP subtree and its index in the
    stacked unit (None when the unit is not stacked)."""
    start = 0
    for ui, (unit, reps) in enumerate(cfg.scan_plan()):
        n = len(unit) * reps
        if layer < start + n:
            r, li = divmod(layer - start, len(unit))
            return params[f"u{ui}"][f"l{li}"]["ffn"], (r if reps > 1
                                                        else None)
        start += n
    raise IndexError(layer)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_matches_the_reference_per_layer(both, dtype):
    """The port's quantize_params on the reference's weights (loaded by
    from_numpy_tree) gives each layer the reference's int8 values and
    scales (its stacked unit's slice) byte for byte, and only the MLP
    projections; the reference's quantized tree carried across by
    from_numpy_tree (grid storage, as its launcher keeps it) gives the
    same QTensors."""
    jcfg, jparams, cfg = both
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype))
                          if a.ndim >= 2 else a, jparams)
    theirs = jquant.quantize_params(params, "w8a8")
    grid = jquant.quantize_params(params, "w8a8", store="grid")
    ours = quantize_params(from_numpy_tree(_np_tree(params), cfg,
                                           device="cpu"), "w8a8")
    carried = from_numpy_tree(_np_tree(grid), cfg, device="cpu")
    assert cfg.scan_plan()[0][1] > 1          # a stacked unit
    for layer in range(cfg.n_layers):
        ffn, r = _ffn(_np_tree(theirs), layer, jcfg)
        for leaf in ("wi", "wo"):
            qt = ffn[leaf]
            values, scale = ((a if r is None else a[r])
                             for a in (qt.values, qt.scale))
            for model in (ours, carried):
                mine = getattr(model.layers[layer].ffn, leaf)
                _assert_qtensor_equal(mine, values, scale, True)
        mix = ours.layers[layer].mix
        assert not any(isinstance(m, QTensor) for m in mix.modules())
        assert mix.wq.dtype == getattr(torch, dtype)
    # the full-precision MLP weights are gone; the rest stay parameters
    assert not [n for n, _ in ours.named_parameters() if ".ffn." in n]
    assert {n for n, _ in ours.named_buffers()} == {
        f"layers.{i}.ffn.{leaf}.{t}" for i in range(cfg.n_layers)
        for leaf in ("wi", "wo") for t in ("values", "scale")}
    assert quantize_params(ours, None) is ours
    assert quantize_params(ours, "kv8") is ours


@pytest.mark.parametrize("decode_impl", ["kernel", "plain"])
def test_w8a8_dense_steps_match_jax_lm(both, decode_impl):
    """Prefill + G-1 decode steps on the smoke phi4-mini in f32 on the
    reference's own quantized weights (its quantize_params, int8 storage,
    carried across by from_numpy_tree): logits at every step at the f32
    tolerance and the greedy tokens equal to the reference's
    ``lm.prefill`` / ``lm.decode_step`` under ``quant="w8a8"``, both
    through the sim GEMM."""
    jcfg, jparams, cfg = both
    jq = jquant.quantize_params(jparams, "w8a8")
    model = from_numpy_tree(_np_tree(jq), cfg, device="cpu")
    B, P, G = 3, 13, 5
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (B, P)).astype(np.int32)
    jopts = jlm.ForwardOpts(attn_chunk=4, decode_impl="full", quant="w8a8")
    opts = lm.ForwardOpts(attn_chunk=4, decode_impl=decode_impl,
                          quant="w8a8")
    jl, jc = jlm.prefill(jq, jcfg, jnp.asarray(prompts), max_len=P + G,
                         opts=jopts)
    logits, cache = lm.prefill(model, cfg, _t(prompts), max_len=P + G,
                               opts=opts)
    for i in range(G):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **F32_TOL)
        tok = torch.argmax(logits, -1, keepdim=True)
        jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        if i == G - 1:
            break
        jl, jc = jlm.decode_step(jq, jcfg, jtok, jc, jnp.int32(P + i), jopts)
        logits, cache = lm.decode_step(model, cfg, tok, cache, P + i, opts)


@pytest.fixture(scope="module")
def jax_w8a8_tokens(both):
    """The reference's ``serve_dense`` steps under w8a8 on the prompts the
    launcher draws from seed 0: weights quantized as its launcher
    quantizes them (grid storage), prefill with KV chunks of 64, greedy
    decode steps, the sim GEMM."""
    jcfg, jparams, _ = both
    B, P, G = 3, 13, 6
    jq = jquant.quantize_params(jparams, "w8a8", store="grid")
    prompts = np.random.default_rng(0).integers(1, jcfg.vocab_size, (B, P))
    jopts = jlm.ForwardOpts(attn_chunk=64, decode_impl="full", quant="w8a8")
    logits, cache = jlm.prefill(jq, jcfg, jnp.asarray(prompts, jnp.int32),
                                max_len=P + G, opts=jopts)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    outs = [tok]
    for i in range(G - 1):
        logits, cache = jlm.decode_step(jq, jcfg, tok, cache,
                                        jnp.int32(P + i), jopts)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        outs.append(tok)
    return np.concatenate(outs, 1).tolist()


@pytest.mark.parametrize("quant_impl", ["sim", "pallas"])
@pytest.mark.parametrize("impl", ["full", "pallas"])
def test_serve_dense_w8a8_matches_jax(both, jax_w8a8_tokens, monkeypatch,
                                      impl, quant_impl):
    """The launcher's w8a8 dense run on the CPU (``--quant w8a8 --device
    cpu``, quantizing the reference's weights itself) gives the reference's
    tokens, by the einsum or the decode kernel's plain version, through
    the sim GEMM or matmul_w8a8's plain version."""
    _, jparams, cfg = both
    tree = _np_tree(jparams)
    monkeypatch.setattr(serve, "init_params", lambda cfg_, gen, device:
                        from_numpy_tree(tree, cfg, device="cpu"))
    before = mm8_kernel.matmul_w8a8.launches
    report = serve.main(["--decode-impl", impl, "--device", "cpu",
                         "--quant", "w8a8", "--quant-impl", quant_impl,
                         "--requests", "3", "--prompt-len", "13",
                         "--gen", "6"])
    assert report["quant"] == "w8a8" and report["quant_impl"] == quant_impl
    assert report["tokens"] == jax_w8a8_tokens
    assert mm8_kernel.matmul_w8a8.launches == before     # CPU: plain


def test_w8a8_refusals(both):
    """What waits for a later slice raises before any device check:
    w8a16, w8a8 on the paged path and on the paged engine."""
    _, _, cfg = both
    for argv in (["--quant", "w8a16", "--decode-impl", "pallas"],
                 ["--quant", "w8a16", "--decode-impl", "full",
                  "--quant-impl", "pallas"],
                 ["--quant", "w8a8"],
                 ["--quant", "w8a8", "--decode-impl", "paged",
                  "--quant-impl", "pallas"]):
        with pytest.raises(NotImplementedError):
            serve.main(argv + ["--device", "cpu"])
    model = from_numpy_tree(_np_tree(both[1]), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="weight policies"):
        ServingEngine(cfg, model, num_pages=8, page_size=8, max_batch=2,
                      max_seq_len=16, prefill_chunk=4, quant="w8a8",
                      device="cpu")
