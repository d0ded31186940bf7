"""The port's MLA + MoE dense serving held against the JAX package's.

The plain ``mla_decode`` (the oracle's counterpart, ``ref.mla_decode``)
and the kernel's function (``ref.mla_decode_ragged``, what the CUDA
wrapper runs on the CPU) against the reference's oracle on ragged
lengths, kv_len 0 and past T, in f32 and bf16; ``ops.latent_decode``
against the Pallas ``mla_decode`` in interpret mode (one case); the
port's ``apply_moe`` against the reference's ``index`` dispatch on
dsv2-lite-smoke weights, with and without capacity drops; the whole
dsv2-lite-smoke prefill + decode steps (``decode_impl`` full, and pallas
in interpret mode against the kernel path's plain version) and the
launcher's tokens against the reference's; olmoe-smoke (MoE without MLA)
token parity; and the refusals of what the port does not serve on an MLA
or MoE arch. Tolerance: the reference's f32 1e-4
(``tests/test_kernel_oracles.py`` ``_tol``), atol and rtol. The CUDA
kernel itself is held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.mla_decode import mla_decode as jax_mla_decode
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.param import init_params as jax_init_params

from repro_torch.configs import get_config
from repro_torch.core import Autotuner
from repro_torch.kernels import mla_decode as mla_kernel
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import attention as ATT
from repro_torch.models import lm, moe
from repro_torch.models.param import from_numpy_tree
from repro_torch.quant import quantize_params

MLA_ARCH = "deepseek-v2-lite-16b"
MOE_ARCH = "olmoe-1b-7b"
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _latents(seed, B, H, C, R, T):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, C), (B, H, R), (B, T, C), (B, T, R)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_mla_decode_matches_the_reference_oracle(dtype):
    """``ref.mla_decode`` against ``repro.kernels.ref.mla_decode`` on every
    row (a row with kv_len 0 averages ckv in both); the kernel's function
    ``ref.mla_decode_ragged`` against the oracle at min(kv_len, T) where a
    row sees a key, and zeros at kv_len 0; the wrapper on CPU tensors is
    that function and counts no launch. bf16 operands are upcast to f32 on
    both sides, so f32 1e-4 holds."""
    B, H, C, R, T = 5, 4, 64, 16, 40
    arrays = _latents(3, B, H, C, R, T)
    lens = np.array([0, 1, 17, 40, 57], np.int32)
    scale = (C + R) ** -0.5
    jargs = [jnp.asarray(a).astype(dtype) for a in arrays]
    args = [_t(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
            for a in jargs]
    want = np.asarray(jref.mla_decode(*jargs, kv_len=jnp.asarray(lens),
                                      scale=scale))
    got = ref.mla_decode(*args, kv_len=_t(lens), scale=scale)
    assert got.dtype == torch.float32 and got.shape == (B, H, C)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    clamped = np.asarray(jref.mla_decode(
        *jargs, kv_len=jnp.asarray(np.minimum(lens, T)), scale=scale))
    ragged = ref.mla_decode_ragged(*args, kv_len=_t(lens), scale=scale)
    np.testing.assert_allclose(ragged[1:].numpy(), clamped[1:], **F32_TOL)
    assert not ragged[0].any() and np.abs(want[0]).sum() > 0
    before = mla_kernel.mla_decode.launches
    out = mla_kernel.mla_decode(*args, kv_len=_t(lens), scale=scale)
    assert mla_kernel.mla_decode.launches == before
    torch.testing.assert_close(out, ragged, rtol=0, atol=0)
    whole = ref.mla_decode_ragged(*args, scale=scale)     # kv_len None: all T
    np.testing.assert_allclose(
        whole.numpy(), np.asarray(jref.mla_decode(*jargs, scale=scale)),
        **F32_TOL)


def test_latent_decode_matches_pallas():
    """``ops.latent_decode`` on CPU tensors (the kernel's plain version, no
    tuning, no launch) against the TPU kernel in interpret mode at two
    splits of 128 rows: H 4 (rows the CUDA kernel pads to 16), ragged
    lengths with 0 (zeros in both) and past T (the whole cache)."""
    B, H, C, R, T = 3, 4, 64, 16, 200
    arrays = _latents(7, B, H, C, R, T)
    lens = np.array([0, 137, 250], np.int32)
    scale = (C + R) ** -0.5
    before = mla_kernel.mla_decode.launches
    got = ops.latent_decode(*(_t(a) for a in arrays), kv_len=_t(lens),
                            scale=scale, tuner=Autotuner(on_miss="error"))
    assert mla_kernel.mla_decode.launches == before
    want = jax_mla_decode(*(jnp.asarray(a) for a in arrays),
                          kv_len=jnp.asarray(lens), scale=scale,
                          block_kv=128, k_splits=2, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert not got[0].any()


@pytest.fixture(scope="module")
def dsv2():
    jcfg = jax_get_config(MLA_ARCH, smoke=True)
    jparams = jax_init_params(jax.random.PRNGKey(0), jlm.lm_specs(jcfg))
    cfg = get_config(MLA_ARCH, smoke=True)
    model = from_numpy_tree(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


def test_from_numpy_tree_carries_mla_and_moe_leaves(dsv2):
    """The smoke model's one unit of three layers (the dense first layer,
    two MoE layers; the full config's plan, the reference's, scans a unit
    of 16 layers once and its last 11 MoE layers stacked, as olmoe-smoke's
    two below) lands layer by layer: the MLA leaves, the f32 router, the
    stacked experts and the shared experts' MLP."""
    jcfg, jparams, cfg, model = dsv2
    assert cfg.scan_plan() == jcfg.scan_plan() == [
        (("attn_mlp", "attn_moe", "attn_moe"), 1)]
    assert get_config(MLA_ARCH).scan_plan() == \
        jax_get_config(MLA_ARCH).scan_plan() == [
            (("attn_mlp",) + ("attn_moe",) * 15, 1), (("attn_moe",), 11)]
    first = jparams["u0"]["l0"]
    assert isinstance(model.layers[0].ffn, lm.MLP)
    np.testing.assert_array_equal(model.layers[0].ffn.wi.numpy(),
                                  np.asarray(first["ffn"]["wi"]))
    assert model.layers[0].ffn.wi.shape == (64, 2 * 128)
    for i in (1, 2):
        ours, theirs = model.layers[i], jparams["u0"][f"l{i}"]
        assert isinstance(ours.ffn, moe.MoE)
        for name in ("wq", "wdkv", "kvnorm", "wuk", "wuv", "wo"):
            np.testing.assert_array_equal(getattr(ours.mix, name).numpy(),
                                          np.asarray(theirs["mix"][name]))
        for name in ("router", "wi", "wo"):
            np.testing.assert_array_equal(getattr(ours.ffn, name).numpy(),
                                          np.asarray(theirs["ffn"][name]))
        np.testing.assert_array_equal(
            ours.ffn.shared.wo.numpy(),
            np.asarray(theirs["ffn"]["shared"]["wo"]))
        assert ours.ffn.router.dtype == ours.mix.kvnorm.dtype == \
            torch.float32
        assert ours.mix.wuk.shape == (4, 32, 16)
        assert ours.ffn.wi.shape == (8, 64, 64)


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
def test_apply_moe_matches_jax(dsv2, capacity_factor):
    """The port's index dispatch against the reference's on the first MoE
    layer's weights: at the smoke capacity factor (8.0, nothing dropped)
    and at 0.25, where each expert keeps 4 of a row's 48 (token, choice)
    pairs and the rest are dropped in pair order. Output and aux loss at
    f32 1e-4; the ranks equal the reference's stable-sort ranks."""
    jcfg, jparams, cfg, model = dsv2
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
    jp = jparams["u0"]["l1"]["ffn"]
    x = np.random.default_rng(4).standard_normal((2, 24, 64)).astype(
        np.float32)
    out, aux = moe.apply_moe(model.layers[1].ffn, _t(x), cfg)
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)
    _, idx, _ = moe.route(model.layers[1].ffn, _t(x), cfg)
    flat = idx.reshape(2, -1)
    rank = moe.rank_in_expert(flat, cfg.moe.n_experts)
    np.testing.assert_array_equal(
        rank.numpy(), np.asarray(jmoe._rank_in_expert(
            jnp.asarray(flat.numpy()), cfg.moe.n_experts)))
    C = moe.capacity(cfg, 24)
    assert C == jmoe._capacity(jcfg, 24)
    dropped = int((rank >= C).sum())
    if capacity_factor is None:
        assert C == 48 and dropped == 0
    else:
        assert C == 4 and dropped > 0


@pytest.mark.parametrize("decode_impl,jax_impl", [("plain", "full"),
                                                   ("kernel", "pallas")])
def test_dsv2_serving_matches_jax_lm(dsv2, decode_impl, jax_impl):
    """Prefill + G-1 decode steps on dsv2-lite-smoke in f32 (the
    reference's init_params weights): logits at every step within f32
    1e-4 and the greedy tokens equal, the reference's
    ``decode_impl="pallas"`` the Pallas kernel in interpret mode, the
    port's ``kernel`` path ``mla_decode``'s plain version; the latent
    caches the steps wrote agree."""
    jcfg, jparams, cfg, model = dsv2
    B, P, G = 2, 11, 4
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (B, P)).astype(np.int32)
    jopts = jlm.ForwardOpts(attn_chunk=4, decode_impl=jax_impl)
    opts = lm.ForwardOpts(attn_chunk=4, decode_impl=decode_impl)
    jl, jc = jlm.prefill(jparams, jcfg, jnp.asarray(prompts), max_len=P + G,
                         opts=jopts)
    logits, cache = lm.prefill(model, cfg, _t(prompts).long(),
                               max_len=P + G, opts=opts)
    assert set(cache[0]) == {"ckv", "krope"}
    assert cache[0]["ckv"].shape == (B, P + G, 32)
    for i in range(G):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **F32_TOL)
        tok = torch.argmax(logits, -1, keepdim=True)
        jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        if i == G - 1:
            break
        jl, jc = jlm.decode_step(jparams, jcfg, jtok, jc, jnp.int32(P + i),
                                 jopts)
        logits, cache = lm.decode_step(model, cfg, tok, cache, P + i, opts)
    for layer in range(cfg.n_layers):
        for name in ("ckv", "krope"):
            np.testing.assert_allclose(
                cache[layer][name].numpy(),
                np.asarray(jc["u0"][f"l{layer}"]["self"][name]), **F32_TOL)


def _jax_serve_dense(jcfg, jparams, B, P, G):
    """The reference's ``serve_dense`` steps (prefill with KV chunks of 64,
    then greedy ``decode_impl="full"`` steps) on the prompts the launcher
    draws from seed 0."""
    prompts = np.random.default_rng(0).integers(1, jcfg.vocab_size, (B, P))
    jopts = jlm.ForwardOpts(attn_chunk=64, decode_impl="full")
    logits, cache = jlm.prefill(jparams, jcfg, jnp.asarray(prompts, jnp.int32),
                                max_len=P + G, opts=jopts)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    outs = [tok]
    for i in range(G - 1):
        logits, cache = jlm.decode_step(jparams, jcfg, tok, cache,
                                        jnp.int32(P + i), jopts)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        outs.append(tok)
    return np.concatenate(outs, 1).tolist()


def test_serve_dense_mla_matches_jax(dsv2, monkeypatch):
    """The launcher's MLA run on the CPU (``--arch deepseek-v2-lite-16b
    --device cpu --decode-impl pallas``: ``mla_decode``'s plain version)
    on the reference's weights gives the reference's tokens, and counts
    no kernel launch there."""
    jcfg, jparams, cfg, model = dsv2
    monkeypatch.setattr(serve, "init_params",
                        lambda cfg_, gen, device: model)
    B, P, G = 3, 12, 5
    report = serve.main(["--arch", MLA_ARCH, "--decode-impl", "pallas",
                         "--device", "cpu", "--requests", str(B),
                         "--prompt-len", str(P), "--gen", str(G)])
    assert report["arch"] == "dsv2-lite-smoke"
    assert report["decode_impl"] == "pallas"
    assert report["launches"]["mla_decode"] == 0
    assert report["tokens"] == _jax_serve_dense(jcfg, jparams, B, P, G)


def test_olmoe_serving_matches_jax():
    """MoE without MLA: olmoe-smoke through the launcher's dense path on
    the CPU (GQA decode by the kernel path's plain version) gives the
    reference's tokens."""
    jcfg = jax_get_config(MOE_ARCH, smoke=True)
    jparams = jax_init_params(jax.random.PRNGKey(0), jlm.lm_specs(jcfg))
    cfg = get_config(MOE_ARCH, smoke=True)
    model = from_numpy_tree(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    assert all(isinstance(b.ffn, moe.MoE) for b in model.layers)
    assert not hasattr(model.layers[0].ffn, "shared")
    args = serve.build_parser().parse_args(
        ["--arch", MOE_ARCH, "--decode-impl", "pallas", "--device", "cpu",
         "--requests", "3", "--prompt-len", "12", "--gen", "5"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "init_params", lambda cfg_, gen, device: model)
        report = serve.serve_dense(args, Autotuner(on_miss="error"))
    assert report["arch"] == "olmoe-smoke"
    assert report["tokens"] == _jax_serve_dense(jcfg, jparams, 3, 12, 5)


@pytest.mark.parametrize("argv,match", [
    (["--arch", MLA_ARCH, "--decode-impl", "paged"], "paged"),
    (["--arch", MOE_ARCH, "--decode-impl", "paged"], "paged"),
    (["--arch", MLA_ARCH, "--decode-impl", "pallas", "--speculative"],
     "speculative"),
    (["--arch", MLA_ARCH, "--decode-impl", "full", "--quant", "kv8"],
     "kv8"),
    (["--arch", MLA_ARCH, "--decode-impl", "pallas", "--quant", "w8a8"],
     "w8a8"),
    (["--arch", MOE_ARCH, "--decode-impl", "full", "--quant", "w8a16"],
     "w8a16"),
    (["--arch", MLA_ARCH, "--decode-impl", "pallas", "--attn-impl",
      "pallas"], "one head dim"),
])
def test_serve_refuses_on_mla_and_moe_archs(argv, match):
    """What the launcher does not serve on an MLA or MoE arch is refused
    by name before any weight is made: the paged path and speculation (the
    reference's paged attention asserts no MLA), int8 latent caches (its
    ``_check_kv8``), quantized expert weights, and the flash prefill (one
    head dim)."""
    with pytest.raises(NotImplementedError, match=match):
        serve.main(argv + ["--device", "cpu"])


def _refusal(case, model_cfg):
    cfg = get_config(model_cfg, smoke=True)
    if case == "paged cache":
        return lambda: lm.init_paged_cache(cfg, 8, 4, device="cpu")
    if case == "kv8 latent cache":
        return lambda: ATT.attn_cache_spec(cfg, 1, 8, kv_dtype="int8")
    if case == "flash prefill":
        model = lm.LM(cfg, device="cpu")
        return lambda: lm.prefill(model, cfg, torch.ones(1, 4).long(),
                                  max_len=6,
                                  opts=lm.ForwardOpts(attn_impl="pallas"))
    model = lm.LM(cfg, device="cpu")
    return lambda: quantize_params(model, "w8a8")


@pytest.mark.parametrize("case,arch,match", [
    ("paged cache", MLA_ARCH, "paged serving"),
    ("paged cache", MOE_ARCH, "paged serving"),
    ("kv8 latent cache", MLA_ARCH, "latent-cache quant path"),
    ("flash prefill", MLA_ARCH, "one head dim"),
    ("quantized experts", MOE_ARCH, "MoE experts"),
])
def test_models_refuse_what_is_not_ported(case, arch, match):
    """The same refusals inside the library: the paged path's
    ``_check_paged``, the MLA cache's ``_check_kv8``, the MLA prefill under
    ``attn_impl="pallas"`` and ``quantize_params`` on MoE experts."""
    with pytest.raises(NotImplementedError, match=match):
        _refusal(case, arch)()
