"""The port's dense-cache serving held against the JAX package's.

The plain ``gqa_decode`` / ``decode_attention`` (what the CUDA kernel's
wrappers run on the CPU) against the Pallas kernels in interpret mode; the
port's ``attn_decode`` against the reference's; the port's dense prefill
and decode steps against the reference's ``lm.prefill`` /
``lm.decode_step`` on the same weights; the dense tokens against the
port's paged engine; and the launcher's dense path. The same under the
kv8 policy (int8 caches with per-token scales): the plain
``gqa_decode_kv8`` against the Pallas kernel and the reference's oracle,
``attn_prefill`` / ``attn_decode`` against the reference's, and the
launcher's kv8 tokens against the reference's ``serve_dense`` steps.
Tolerances are the reference's (``tests/test_kernel_oracles.py``
``_tol``): f32 1e-4, int8 2e-3.
The CUDA kernel itself is held against the plain versions on the card in
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
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.gqa_decode import gqa_decode as jax_gqa_decode
from repro.kernels.gqa_decode_kv8 import gqa_decode_kv8 as jax_gqa_kv8
from repro.models import attention as JATT
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.param import init_params as jax_init_params

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da_kernel
from repro_torch.kernels import gqa_decode as gqa_kernel
from repro_torch.kernels import gqa_decode_kv8 as kv8_kernel
from repro_torch.launch import serve
from repro_torch.models import attention as ATT
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import from_numpy_tree
from repro_torch.serving import Request, ServingEngine

ARCH = "phi4-mini-3.8b"
F32_TOL = dict(atol=1e-4, rtol=1e-4)
INT8_TOL = dict(atol=2e-3, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qkv(seed, B, Hq, Hkv, T, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32))


# Four interpret-mode cases: (kernel, group, k_splits, pack_gqa); the
# lengths hold kv_len == 0 and kv_len > T, and splits that find no key.
PALLAS_CASES = [("gqa_decode", 3, 2, True), ("gqa_decode", 2, 1, False),
                ("decode_attention", 3, 4, True),
                ("decode_attention", 1, 1, True)]


@pytest.mark.parametrize("kernel,group,k_splits,pack", PALLAS_CASES)
def test_plain_dense_decode_matches_pallas(kernel, group, k_splits, pack):
    B, Hkv, T, D = 4, 2, 40, 16
    q, k, v = _qkv(group * 10 + k_splits, B, Hkv * group, Hkv, T, D)
    lens = np.array([0, T + 9, 7, 33], np.int32)
    args = [_t(a) for a in (q, k, v)]
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    if kernel == "gqa_decode":
        ours = gqa_kernel.gqa_decode(*args, kv_len=_t(lens), k_splits=k_splits,
                                     pack_gqa=pack).numpy()
        pallas = jax_gqa_decode(*jargs, kv_len=jnp.asarray(lens),
                                block_kv=128, k_splits=k_splits,
                                pack_gqa=pack, interpret=True)
    else:
        ours = da_kernel.decode_attention(*args, kv_len=_t(lens),
                                          k_splits=k_splits).numpy()
        pallas = jax_decode(*jargs, kv_len=jnp.asarray(lens), block_kv=128,
                            k_splits=k_splits, interpret=True)
    np.testing.assert_allclose(ours, np.asarray(pallas), **F32_TOL)
    assert not ours[0].any(), "kv_len == 0 must give exact zeros"
    # the jnp oracle agrees where a row has keys (it averages V at 0)
    oracle = np.asarray(jref.gqa_decode(*jargs, kv_len=jnp.asarray(
        np.minimum(lens, T))))
    np.testing.assert_allclose(ours[1:], oracle[1:], **F32_TOL)


def test_dense_decode_cpu_runs_plain_and_counts_nothing():
    from repro_torch.kernels import ops, ref
    q, k, v = (_t(a) for a in _qkv(0, 2, 4, 2, 24, 16))
    lens = torch.tensor([5, 30])
    before = (gqa_kernel.gqa_decode.launches,
              da_kernel.decode_attention.launches)
    out = ops.ragged_decode(q, k, v, kv_len=lens)
    torch.testing.assert_close(out, ref.gqa_decode(q, k, v, kv_len=lens),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.decode(q, k, v),
                               ref.gqa_decode(q, k, v), rtol=0, atol=0)
    assert (gqa_kernel.gqa_decode.launches,
            da_kernel.decode_attention.launches) == before
    with pytest.raises(NotImplementedError, match="ragged_decode_kv8"):
        ops.ragged_decode(q, k.to(torch.int8), v.to(torch.int8), kv_len=lens)
    with pytest.raises(ValueError, match="gqa_decode_kv8"):
        gqa_kernel.gqa_decode(q, k.to(torch.int8), v.to(torch.int8))


# Three interpret-mode cases of the int8 kernel: (group, k_splits,
# pack_gqa); the lengths hold kv_len == 0 and kv_len > T.
KV8_PALLAS_CASES = [(3, 2, True), (2, 1, False), (1, 1, True)]


def _kv8_cache(seed, B, Hkv, T, D):
    """An int8 cache (B, Hkv, T, D) with its (B, Hkv, T) scales, quantized
    by the reference's wire format (numpy out)."""
    from repro.quant.calibrate import quantize_kv
    rng = np.random.default_rng(seed)
    kv = [rng.standard_normal((B, Hkv, T, D)).astype(np.float32) * 3
          for _ in range(2)]
    kq, ks, vq, vs = (np.array(a) for a in quantize_kv(
        jnp.asarray(kv[0]), jnp.asarray(kv[1])))
    return kq, vq, ks, vs


@pytest.mark.parametrize("group,k_splits,pack", KV8_PALLAS_CASES)
def test_plain_kv8_decode_matches_pallas(group, k_splits, pack):
    """The plain gqa_decode_kv8 (what the CUDA wrapper runs on the CPU)
    against the TPU kernel in interpret mode and the reference's oracle,
    on one int8 cache."""
    B, Hkv, T, D = 4, 2, 40, 16
    q = np.random.default_rng(group).standard_normal(
        (B, Hkv * group, D)).astype(np.float32)
    kq, vq, ks, vs = _kv8_cache(group * 10 + k_splits, B, Hkv, T, D)
    lens = np.array([0, T + 9, 7, 33], np.int32)
    ours = kv8_kernel.gqa_decode_kv8(
        _t(q), _t(kq), _t(vq), _t(ks), _t(vs), kv_len=_t(lens),
        k_splits=k_splits, pack_gqa=pack).numpy()
    jargs = [jnp.asarray(a) for a in (q, kq, vq, ks, vs)]
    pallas = jax_gqa_kv8(*jargs, kv_len=jnp.asarray(lens), block_kv=128,
                         k_splits=k_splits, pack_gqa=pack, interpret=True)
    np.testing.assert_allclose(ours, np.asarray(pallas), **INT8_TOL)
    assert not ours[0].any(), "kv_len == 0 must give exact zeros"
    oracle = np.asarray(jref.gqa_decode_kv8(*jargs, kv_len=jnp.asarray(
        np.minimum(lens, T))))
    np.testing.assert_allclose(ours[1:], oracle[1:], **INT8_TOL)


def test_attn_decode_matches_jax():
    """The port's attn_decode (plain and kernel) against the reference's
    (full and pallas) at the reference's test size, same weights."""
    kw = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
              dtype="float32")
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    p = jax_init_params(jax.random.PRNGKey(0), JATT.attn_specs(jcfg))
    att = ATT.Attention(cfg, "cpu")
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(att, name).copy_(_t(p[name]))
    B, S = 2, 8
    rng = np.random.default_rng(0)
    xp = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    _, jcache = JATT.attn_prefill(p, jnp.asarray(xp), jcfg, max_len=S + 4)
    for jimpl, impl in (("full", "plain"), ("pallas", "kernel")):
        jo, jc = JATT.attn_decode(p, jnp.asarray(x), jcfg, jcache,
                                  jnp.int32(S), impl=jimpl)
        cache = lm.init_cache(dataclasses.replace(cfg, n_layers=1), B,
                              S + 4, device="cpu")[0]
        _, cache = ATT.attn_prefill(att, _t(xp), cfg, cache)
        o, cache = ATT.attn_decode(att, _t(x), cfg, cache, S, impl=impl)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(jc[key]), **F32_TOL)


def _attn_pair():
    kw = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
              dtype="float32")
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    p = jax_init_params(jax.random.PRNGKey(0), JATT.attn_specs(jcfg))
    att = ATT.Attention(cfg, "cpu")
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(att, name).copy_(_t(p[name]))
    return jcfg, cfg, p, att


def test_attn_kv8_matches_jax():
    """kv8 attn_prefill / attn_decode against the reference's on the same
    weights: the int8 cache after prefill (values one step apart at most,
    on under 1% of the entries, where the two matmuls put x / scale on
    either side of a rounding edge; scales to rtol 1e-6), the prefill
    output at f32 (the prompt is attended in full precision), and the
    decode outputs (plain and kernel against full and pallas) at the int8
    tolerance, on the port's own cache and on the reference's cache
    carried across as numpy."""
    jcfg, cfg, p, att = _attn_pair()
    B, S, T = 3, 24, 30
    rng = np.random.default_rng(0)
    xp = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jo, jcache = JATT.attn_prefill(p, jnp.asarray(xp), jcfg, max_len=T,
                                   kv_dtype="int8")
    cache = lm.init_cache(cfg, B, T, device="cpu", kv_dtype="int8")[0]
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "k": ((B, T, 2, 16), torch.int8), "v": ((B, T, 2, 16), torch.int8),
        "k_scale": ((B, T, 2), torch.float32),
        "v_scale": ((B, T, 2), torch.float32)}
    o, cache = ATT.attn_prefill(att, _t(xp), cfg, cache)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32_TOL)
    for key in ("k", "v"):
        diff = np.abs(cache[key].numpy().astype(np.int32)
                      - np.asarray(jcache[key]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, key
        np.testing.assert_allclose(cache[key + "_scale"].numpy(),
                                   np.asarray(jcache[key + "_scale"]),
                                   rtol=1e-6, atol=0)
    carried = {k: _t(np.asarray(v)).clone() for k, v in jcache.items()}
    for jimpl, impl in (("full", "plain"), ("pallas", "kernel")):
        jo, jc = JATT.attn_decode(p, jnp.asarray(x), jcfg, jcache,
                                  jnp.int32(S), impl=jimpl)
        for label, start in (("own", cache), ("carried", carried)):
            c = {k: v.clone() for k, v in start.items()}
            o, c = ATT.attn_decode(att, _t(x), cfg, c, S, impl=impl)
            np.testing.assert_allclose(o.numpy(), np.asarray(jo),
                                       err_msg=f"{impl} {label}",
                                       **INT8_TOL)
            assert c["k"].dtype == torch.int8
            for key in ("k_scale", "v_scale"):
                np.testing.assert_allclose(c[key][:, S].numpy(),
                                           np.asarray(jc[key])[:, S],
                                           rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def both():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = jax_init_params(jax.random.PRNGKey(0), jlm.lm_specs(jcfg))
    cfg = get_config(ARCH, smoke=True)
    model = from_numpy_tree(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


@pytest.mark.parametrize("attn_impl,decode_impl",
                         [("chunked", "kernel"), ("full", "plain"),
                          ("pallas", "kernel")])
def test_dense_serving_matches_jax_lm(both, attn_impl, decode_impl):
    """Prefill + G-1 decode steps on the smoke phi4-mini in f32 (the
    reference's init_params weights): logits at every step and the greedy
    tokens equal the reference's prefill + decode_step(decode_impl="full")
    with the same attn_impl (``pallas``: the flash_attention kernel's
    plain version here, the Pallas kernel in interpret mode there)."""
    jcfg, jparams, cfg, model = both
    B, P, G = 3, 13, 5
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (B, P)).astype(np.int32)
    jopts = jlm.ForwardOpts(attn_impl=attn_impl, attn_chunk=4,
                            decode_impl="full")
    opts = lm.ForwardOpts(attn_impl=attn_impl, attn_chunk=4,
                          decode_impl=decode_impl)
    jl, jc = jlm.prefill(jparams, jcfg, jnp.asarray(prompts), max_len=P + G,
                         opts=jopts)
    logits, cache = lm.prefill(model, cfg, _t(prompts), max_len=P + G,
                               opts=opts)
    for i in range(G):
        assert logits.dtype == torch.float32
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
        jk = np.asarray(jc["u0"]["l0"]["self"]["k"][layer])
        np.testing.assert_allclose(cache[layer]["k"].numpy(), jk, **F32_TOL)


def test_dense_tokens_equal_paged_engine(both):
    """The port's dense greedy tokens equal its paged engine's for the same
    prompts, as the reference's paged engine equals its dense path."""
    _, _, cfg, model = both
    rng = np.random.default_rng(42)
    spec = [(rng.integers(1, cfg.vocab_size, int(p)).astype(np.int32),
             int(g)) for p, g in zip(rng.integers(2, 10, 5),
                                     rng.integers(1, 5, 5))]
    eng = ServingEngine(cfg, model, num_pages=24, page_size=8, max_batch=3,
                        max_seq_len=24, prefill_chunk=4,
                        opts=lm.ForwardOpts(), device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(spec)]
    eng.run(reqs)
    opts = lm.ForwardOpts(attn_impl="full")
    for r, (prompt, gen) in zip(reqs, spec):
        P = len(prompt)
        logits, cache = lm.prefill(model, cfg, _t(prompt[None]).long(),
                                   max_len=P + gen, opts=opts)
        out = [int(torch.argmax(logits[0]))]
        for i in range(gen - 1):
            logits, cache = lm.decode_step(
                model, cfg, torch.tensor([[out[-1]]]), cache, P + i, opts)
            out.append(int(torch.argmax(logits[0])))
        assert r.tokens == out, f"req {r.rid}: paged {r.tokens} != {out}"


@pytest.mark.parametrize("impl", ["full", "pallas"])
def test_serve_dense_kv8_matches_jax(both, monkeypatch, impl):
    """The launcher's kv8 dense run on the CPU (``--quant kv8 --device
    cpu``) on the reference's weights gives the reference's tokens: its
    ``serve_dense`` steps (prefill with KV chunks of 64, then greedy
    decode steps under the kv8 policy, ``decode_impl="full"``) on the
    prompts the launcher draws from the same seed."""
    jcfg, jparams, cfg, model = both
    monkeypatch.setattr(serve, "init_params",
                        lambda cfg_, gen, device: model)
    B, P, G = 3, 13, 6
    report = serve.main(["--decode-impl", impl, "--device", "cpu",
                         "--quant", "kv8", "--requests", str(B),
                         "--prompt-len", str(P), "--gen", str(G)])
    assert report["quant"] == "kv8"
    prompts = np.random.default_rng(0).integers(1, jcfg.vocab_size, (B, P))
    jopts = jlm.ForwardOpts(attn_chunk=64, decode_impl="full", quant="kv8")
    logits, cache = jlm.prefill(jparams, jcfg, jnp.asarray(prompts, jnp.int32),
                                max_len=P + G, opts=jopts)
    assert np.asarray(cache["u0"]["l0"]["self"]["k"]).dtype == np.int8
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    outs = [tok]
    for i in range(G - 1):
        logits, cache = jlm.decode_step(jparams, jcfg, tok, cache,
                                        jnp.int32(P + i), jopts)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        outs.append(tok)
    assert report["tokens"] == np.concatenate(outs, 1).tolist()


def test_dense_path_refuses_what_is_not_ported():
    cfg = get_config(ARCH, smoke=True)
    for change in ({"window": 16}, {"n_prefix": 4}, {"learned_pos": True}):
        with pytest.raises(NotImplementedError, match="not ported"):
            lm.init_cache(dataclasses.replace(cfg, **change), 1, 8, "cpu")
    with pytest.raises(NotImplementedError, match="SWA"):
        ATT.attn_cache_spec(dataclasses.replace(cfg, window=16), 1, 8)


def test_serve_dense_full_runs_on_the_cpu():
    argv = ["--decode-impl", "full", "--device", "cpu", "--requests", "2",
            "--prompt-len", "6", "--gen", "3"]
    report = serve.main(argv)
    assert report["decode_impl"] == "full" and report["device"] == "cpu"
    assert np.asarray(report["tokens"]).shape == (2, 3)
    for key in ("prefill_ms", "decode_ms", "tokens_per_s", "sample",
                "tuner"):
        assert key in report
    kernel = serve.main(argv[:1] + ["pallas"] + argv[2:])
    assert kernel["tokens"] == report["tokens"]


@pytest.mark.parametrize("argv,exc", [
    (["--decode-impl", "pallas", "--speculative"], SystemExit),
    (["--decode-impl", "full", "--speculative", "3"], SystemExit),
    (["--decode-impl", "paged", "--quant", "kv8", "--speculative"],
     RuntimeError),
    (["--decode-impl", "full", "--tp", "2"], NotImplementedError),
    (["--decode-impl", "pallas", "--quant", "w8a16"], NotImplementedError),
    (["--decode-impl", "paged", "--attn-impl", "pallas"],
     NotImplementedError),
])
def test_serve_dense_refuses(argv, exc):
    with pytest.raises(exc):
        serve.main(argv + ["--device", "cpu"])
