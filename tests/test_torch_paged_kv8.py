"""The port's kv8 paged serving (int8 page pools with per-token f32 scale
pools), plain and speculative, held against the JAX package's.

The plain ``paged_decode`` and ``paged_verify`` over int8 pools (what the
CUDA wrappers run on the CPU) against the reference's oracles on the same
numpy pools and scales, and against the Pallas kernels in interpret mode;
the port's ``attn_prefill_paged`` / ``attn_decode_paged`` /
``attn_verify_paged`` over int8 pools against the reference's on the same
weights; the kv8 engine, plain and speculative, against the reference's
kv8 engines; preemption and the non-finite-burst degrade under kv8; the
launcher's int8 lookups. Tolerances: 1e-4 where both sides dequantize the
same bytes in f32, the reference's int8 tolerance 2e-3
(``tests/test_kernel_oracles.py``) against the Pallas kernels. The CUDA
kernels' int8 branches are held against the plain versions on the card
in ``tests/test_torch_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.paged_decode import paged_decode as jax_paged_decode
from repro.kernels.paged_verify import paged_verify as jax_paged_verify
from repro.models import attention as JATT
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.param import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_decode as pd_kernel
from repro_torch.kernels import paged_verify as pv_kernel
from repro_torch.launch import serve
from repro_torch.models import attention as ATT
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import from_numpy_tree
from repro_torch.quant import quantize_kv
from repro_torch.serving import Request, ServingEngine

ARCH = "phi4-mini-3.8b"
F32_TOL = dict(atol=1e-4, rtol=1e-4)
INT8_TOL = dict(atol=2e-3, rtol=2e-3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _kv8_operands(seed, B, Hq, Hkv, D, page_size, max_pages, kv_len,
                  K=None):
    """f32 q ((B, Hq, D), or (B, K, Hq, D) for a verify of depth K) and
    int8 pools with their scales (the port's wire format on seeded numpy
    pools), page 0 as scratch, each sequence on shuffled pages, trailing
    table entries on the scratch page; all numpy."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_pages
    q = rng.standard_normal((B, Hq, D) if K is None
                            else (B, K, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((Hkv, n_pages, page_size, D)).astype(np.float32)
    vp = rng.standard_normal((Hkv, n_pages, page_size, D)).astype(np.float32)
    kq, ks, vq, vs = (a.numpy() for a in quantize_kv(_t(kp), _t(vp)))
    tables = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = tables.reshape(B, max_pages).copy()
    for b, n in enumerate(kv_len):
        used = -(-min(max(n, 0), max_pages * page_size) // page_size)
        tables[b, used:] = 0
    return q, kq, vq, ks, vs, tables, np.asarray(kv_len, np.int32)


# group, page_size: an unpacked group of one, groups of 2 and 4
ORACLE_CASES = [(g, ps) for g in (1, 2, 4) for ps in (8, 16)]


@pytest.mark.parametrize("group,page_size", ORACLE_CASES)
def test_plain_paged_decode_kv8_matches_reference_oracle(group, page_size):
    """Both sides dequantize the same int8 bytes by the same scales in f32,
    so they agree at f32's tolerance; the wrapper on the CPU runs the
    plain version, the ``ops`` entry point too, and neither counts a
    launch."""
    Hkv, D, max_pages = 2, 16, 4
    cap = max_pages * page_size
    # inactive slot, ragged, mid-page, exactly full, past capacity
    kv_len = [0, 5, cap - page_size + 3, cap, cap + 7]
    q, kq, vq, ks, vs, tables, lens = _kv8_operands(
        group * 10 + page_size, len(kv_len), Hkv * group, Hkv, D, page_size,
        max_pages, kv_len)
    args = [_t(a) for a in (q, kq, vq, tables, lens)]
    scales = {"k_scales": _t(ks), "v_scales": _t(vs)}
    before = pd_kernel.paged_decode.launches
    ours = pd_kernel.paged_decode(*args, **scales)
    torch.testing.assert_close(ops.paged_decode(*args, **scales), ours,
                               rtol=0, atol=0)
    torch.testing.assert_close(ref.paged_decode(*args, **scales), ours,
                               rtol=0, atol=0)
    assert pd_kernel.paged_decode.launches == before
    oracle = np.asarray(jref.paged_decode(
        *(jnp.asarray(a) for a in (q, kq, vq, tables, lens)),
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
    assert ours.dtype == torch.float32 and ours.shape == q.shape
    np.testing.assert_allclose(ours.numpy(), oracle, **F32_TOL)
    assert not ours[0].any(), "kv_len == 0 must give exact zeros"


@pytest.mark.parametrize("pack", [True, False])
def test_plain_paged_decode_kv8_matches_pallas(pack):
    """The Pallas kernel's int8 branch in interpret mode, packed and
    unpacked, against the plain version at the reference's int8
    tolerance."""
    kv_len = [3, 0, 40]
    q, kq, vq, ks, vs, tables, lens = _kv8_operands(5, 3, 8, 2, 16, 8, 5,
                                                    kv_len)
    ours = pd_kernel.paged_decode(
        *(_t(a) for a in (q, kq, vq, tables, lens)), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    pallas = np.asarray(jax_paged_decode(
        *(jnp.asarray(a) for a in (q, kq, vq, tables, lens)),
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), block_kv=16,
        pack_gqa=pack, interpret=True))
    np.testing.assert_allclose(ours, pallas, **INT8_TOL)
    assert not ours[1].any()


def test_paged_decode_scales_go_with_int8_pools_only():
    q, kq, vq, ks, vs, tables, lens = (_t(a) for a in _kv8_operands(
        1, 2, 4, 2, 16, 8, 2, [3, 9]))
    with pytest.raises(ValueError, match="int8 pools"):
        pd_kernel.paged_decode(q, kq, vq, tables, lens)
    with pytest.raises(ValueError, match="int8 pools"):
        pd_kernel.paged_decode(q, kq.float(), vq.float(), tables, lens,
                               k_scales=ks, v_scales=vs)
    with pytest.raises(ValueError, match="int8 pools"):
        pd_kernel.paged_decode(q, kq, vq, tables, lens, k_scales=ks)


# group, page_size, K: groups of 1, 2 and 4, at depths 2 and 4
VERIFY_CASES = [(g, ps, K) for g in (1, 2, 4) for ps in (8, 16)
                for K in (2, 4)]


@pytest.mark.parametrize("group,page_size,K", VERIFY_CASES)
def test_plain_paged_verify_kv8_matches_reference_oracle(group, page_size,
                                                         K):
    """The plain verify over int8 pools against the reference's oracle
    with scales: both dequantize the same int8 bytes in f32, so they agree
    at f32's tolerance; the wrapper on the CPU runs the plain version, the
    ``ops`` entry point too, and neither counts a launch. Rows whose
    causal window is empty (an inactive slot, the first positions of a
    tail shorter than K) are exact zeros."""
    Hkv, D, max_pages = 2, 16, 4
    cap = max_pages * page_size
    # inactive slot, a tail shorter than K, ragged, mid-page, exactly
    # full, past capacity
    kv_len = [0, K - 1, K + 3, cap - page_size + 3, cap, cap + 7]
    q, kq, vq, ks, vs, tables, lens = _kv8_operands(
        group * 100 + page_size + K, len(kv_len), Hkv * group, Hkv, D,
        page_size, max_pages, kv_len, K)
    args = [_t(a) for a in (q, kq, vq, tables, lens)]
    scales = {"k_scales": _t(ks), "v_scales": _t(vs)}
    before = pv_kernel.paged_verify.launches
    ours = pv_kernel.paged_verify(*args, **scales)
    torch.testing.assert_close(ops.paged_verify(*args, **scales), ours,
                               rtol=0, atol=0)
    torch.testing.assert_close(ref.paged_verify(*args, **scales), ours,
                               rtol=0, atol=0)
    assert pv_kernel.paged_verify.launches == before
    oracle = np.asarray(jref.paged_verify(
        *(jnp.asarray(a) for a in (q, kq, vq, tables, lens)),
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
    assert ours.dtype == torch.float32 and ours.shape == q.shape
    np.testing.assert_allclose(ours.numpy(), oracle, **F32_TOL)
    assert not ours[0].any(), "kv_len == 0 must give exact zeros"
    # kv_len K - 1: query 0's window is empty, query t sees t keys
    assert not ours[1, 0].any() and ours[1, 1:].any()


@pytest.mark.parametrize("pack", [True, False])
def test_plain_paged_verify_kv8_matches_pallas(pack):
    """The Pallas verify kernel's int8 branch in interpret mode, packed
    and unpacked, against the plain version at the reference's int8
    tolerance (one small shape: interpret mode is slow)."""
    kv_len = [2, 0, 40]
    q, kq, vq, ks, vs, tables, lens = _kv8_operands(6, 3, 8, 2, 16, 8, 5,
                                                    kv_len, K=3)
    ours = pv_kernel.paged_verify(
        *(_t(a) for a in (q, kq, vq, tables, lens)), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    pallas = np.asarray(jax_paged_verify(
        *(jnp.asarray(a) for a in (q, kq, vq, tables, lens)),
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), block_kv=16,
        pack_gqa=pack, interpret=True))
    np.testing.assert_allclose(ours, pallas, **INT8_TOL)
    assert not ours[1].any() and not ours[0, 0].any()


def test_paged_verify_scales_go_with_int8_pools_only():
    """Scales are required with int8 pools and refused with float pools,
    on the CPU as on the card, by the wrapper and the ``ops`` entry."""
    q, kq, vq, ks, vs, tables, lens = (_t(a) for a in _kv8_operands(
        1, 2, 4, 2, 16, 8, 2, [3, 9], K=2))
    for fn in (pv_kernel.paged_verify, ops.paged_verify):
        with pytest.raises(ValueError, match="int8 pools"):
            fn(q, kq, vq, tables, lens)
        with pytest.raises(ValueError, match="int8 pools"):
            fn(q, kq.float(), vq.float(), tables, lens, k_scales=ks,
               v_scales=vs)
        with pytest.raises(ValueError, match="int8 pools"):
            fn(q, kq, vq, tables, lens, v_scales=vs)


def _attn_pair(rope: bool):
    """One attention layer's weights from the reference's init, on both
    sides; with ``rope`` off, weights and inputs on a coarse grid make
    every matmul exact in f32 whatever the summation order, so the
    quantized bytes can be held equal."""
    kw = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
              dtype="float32", rope=rope)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    p = jax_init_params(jax.random.PRNGKey(0), JATT.attn_specs(jcfg))
    p = {k: np.round(np.asarray(v) * 64) / 64 for k, v in p.items()}
    att = ATT.Attention(cfg, "cpu")
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(att, name).copy_(_t(p[name]))
    return jcfg, cfg, {k: jnp.asarray(v) for k, v in p.items()}, att


def _assert_pools_equal(c, jc, rope, label):
    """The int8 pools and scale pools byte for byte; with RoPE the two
    libraries' cos and sin may differ in the last bit, which moves a
    scale by an ulp and, rarely, an int8 key by one step: there the keys
    are held within one step on under 1% of the entries and the scales
    to rtol 1e-6, as the dense kv8 test holds them."""
    for key in ("k_pages", "v_pages", "k_scales", "v_scales"):
        ours, theirs = c[key].numpy(), np.asarray(jc[key])
        if not rope or key == "v_pages":
            np.testing.assert_array_equal(ours, theirs,
                                          err_msg=f"{label} {key}")
        elif key == "k_pages":
            diff = np.abs(ours.astype(np.int32) - theirs)
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, label
        else:
            np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0,
                                       err_msg=f"{label} {key}")


def _prefilled_kv8(rope):
    """Both sides' int8 pools after one kv8 ``attn_prefill_paged`` of
    three sequences of 12 tokens (two of them starting mid-page) on the
    same weights, outputs held at f32's tolerance and pools by
    ``_assert_pools_equal``. Returns (jcfg, cfg, jax params, port layer,
    jax pools, port pools, tables, resident lengths, a decode input, rng)."""
    jcfg, cfg, p, att = _attn_pair(rope)
    B, S, ps, max_pages = 3, 12, 4, 8
    n_pages = 1 + B * max_pages
    rng = np.random.default_rng(0)
    xp = np.round(rng.standard_normal((B, S, 64)) * 4).astype(np.float32) / 4
    x = np.round(rng.standard_normal((B, 1, 64)) * 4).astype(np.float32) / 4
    tables = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = tables.reshape(B, max_pages)
    start = np.array([0, 3, 9], np.int32)
    spec = JATT.paged_cache_spec(jcfg, n_pages, ps, kv_dtype="int8")
    jcache = {k: jnp.zeros(v.shape, v.dtype) for k, v in spec.items()}
    cache = lm.init_paged_cache(cfg, n_pages, ps, device="cpu",
                                kv_dtype="int8")[0]
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(v.shape), torch.int8 if v.dtype == jnp.int8
            else torch.float32) for k, v in spec.items()}
    jo, jcache = JATT.attn_prefill_paged(p, jnp.asarray(xp), jcfg, jcache,
                                         jnp.asarray(tables),
                                         jnp.asarray(start))
    o, cache = ATT.attn_prefill_paged(att, _t(xp), cfg, cache, _t(tables),
                                      _t(start))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32_TOL)
    _assert_pools_equal(cache, jcache, rope, "prefill")
    return jcfg, cfg, p, att, jcache, cache, tables, start + S, x, rng


@pytest.mark.parametrize("rope", [False, True], ids=["exact", "rope"])
def test_attn_paged_kv8_matches_jax(rope):
    """kv8 ``attn_prefill_paged`` (three sequences, two of them starting
    mid-page) then ``attn_decode_paged`` (plain and kernel) over int8
    pools against the reference's on the same weights: the outputs at
    f32's tolerance, and the int8 pools and scale pools byte for byte
    after the prefill and after the decode (``_assert_pools_equal``)."""
    jcfg, cfg, p, att, jcache, cache, tables, lens, x, _ = \
        _prefilled_kv8(rope)
    jo, jc = JATT.attn_decode_paged(p, jnp.asarray(x), jcfg, jcache,
                                    jnp.asarray(tables), jnp.asarray(lens))
    for impl in ("plain", "kernel"):
        c = {k: v.clone() for k, v in cache.items()}
        o, c = ATT.attn_decode_paged(att, _t(x), cfg, c, _t(tables),
                                     _t(lens), impl=impl)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo),
                                   err_msg=impl, **F32_TOL)
        _assert_pools_equal(c, jc, rope, f"decode {impl}")


@pytest.mark.parametrize("rope", [False, True], ids=["exact", "rope"])
def test_attn_verify_paged_kv8_matches_jax(rope):
    """kv8 ``attn_verify_paged`` (K 3, plain and kernel) after the same
    prefill, against the reference's: each of the K positions quantized as
    it is written, the int8 pools and scale pools equal after the write
    (``_assert_pools_equal``), the outputs at f32's tolerance. Then a
    rollback: a second verify from one position further on overwrites
    the rejected drafts' int8 entries and scales, and still agrees."""
    jcfg, cfg, p, att, jcache, cache, tables, lens, _, rng = \
        _prefilled_kv8(rope)
    K = 3
    for step, start in enumerate((lens, lens + 1)):
        x = np.round(rng.standard_normal((3, K, 64)) * 4).astype(
            np.float32) / 4
        jo, jcache = JATT.attn_verify_paged(
            p, jnp.asarray(x), jcfg, jcache, jnp.asarray(tables),
            jnp.asarray(start))
        outs = {}
        for impl in ("plain", "kernel"):
            c = {k: v.clone() for k, v in cache.items()}
            outs[impl], c = ATT.attn_verify_paged(att, _t(x), cfg, c,
                                                  _t(tables), _t(start),
                                                  impl=impl)
            assert outs[impl].shape == (3, K, 64)
            np.testing.assert_allclose(outs[impl].numpy(), np.asarray(jo),
                                       err_msg=impl, **F32_TOL)
            _assert_pools_equal(c, jcache, rope, f"verify {step} {impl}")
        cache = c


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = jax_init_params(jax.random.PRNGKey(0), jlm.lm_specs(jcfg))
    cfg = get_config(ARCH, smoke=True)
    return jcfg, jparams, cfg, from_numpy_tree(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _requests(cls, vocab):
    """The reference's kv8 engine test's requests
    (``tests/test_quant.py::test_paged_kv8_engine_serves_and_agrees``)."""
    r = np.random.default_rng(7)
    return [cls(rid=i, prompt=r.integers(1, vocab, 9).astype(np.int32),
                max_new_tokens=4) for i in range(2)]


ENGINE = dict(num_pages=1 + 2 * 4, page_size=8, max_batch=2, max_seq_len=24,
              prefill_chunk=8)


def test_kv8_engine_matches_jax_engine(weights):
    """The kv8 engine on the CPU (plain versions) against the reference's
    kv8 engine on the smoke model: the same tokens, request for request,
    int8 pools, and a clean drain."""
    jcfg, jparams, cfg, model = weights
    jreqs = _requests(JaxRequest, cfg.vocab_size)
    jeng = JaxServingEngine(jcfg, jparams, quant="kv8", **ENGINE)
    jeng.run(jreqs)
    reqs = _requests(Request, cfg.vocab_size)
    eng = ServingEngine(cfg, model, quant="kv8", device="cpu", **ENGINE)
    assert {k: v.dtype for k, v in eng.cache[0].items()} == {
        "k_pages": torch.int8, "v_pages": torch.int8,
        "k_scales": torch.float32, "v_scales": torch.float32}
    res = eng.run(reqs)
    assert res["generated_tokens"] == sum(r.max_new_tokens for r in reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    eng.scheduler.check_invariants()
    assert eng.pool.num_allocated == 0


def test_kv8_preempted_run_matches_uninterrupted(weights):
    """A pool too small for every sequence's growth preempts; a resumed
    request re-prefills and re-quantizes the KV it had, so the tokens
    equal an ample pool's (the reference pins the same,
    ``tests/test_fault_tolerance.py::test_preemption_exact_resume_equality``)."""
    _, _, cfg, model = weights
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 12, 7, 10)]

    def run(num_pages):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        eng = ServingEngine(cfg, model, num_pages=num_pages, page_size=4,
                            max_batch=4, max_seq_len=32, prefill_chunk=4,
                            quant="kv8", device="cpu")
        res = eng.run(reqs)
        eng.scheduler.check_invariants()
        assert eng.pool.num_allocated == 0
        return [r.tokens for r in reqs], res

    ample, res_a = run(40)
    tight, res_t = run(13)
    assert res_a["preemptions"] == 0 and res_t["preemptions"] > 0
    assert res_t["resumes"] > 0
    assert tight == ample


def _spec_cfgs(vocab=128, n_layers=2):
    """The reference's speculative test model
    (``tests/test_spec_decode.py::_tiny_cfg``) on both sides, with its
    weights from the reference's init."""
    fields = dict(name="spec-t", family="dense", n_layers=n_layers,
                  d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                  vocab_size=vocab, dtype="float32")
    jcfg, cfg = JaxModelConfig(**fields), ModelConfig(**fields)
    jparams = jax_init_params(jax.random.PRNGKey(0), jlm.lm_specs(jcfg))
    return jcfg, jparams, cfg, from_numpy_tree(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _spec_requests(cls, vocab, n=6, gen=12, seed=7):
    """The reference's speculative test requests
    (``tests/test_spec_decode.py::_reqs``)."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=rng.integers(1, vocab,
                                    int(rng.integers(6, 14))).astype(np.int32),
                max_new_tokens=gen, arrival=float(i))
            for i in range(n)]


SPEC_ENGINE = dict(num_pages=1 + 4 * 6, page_size=8, max_batch=4,
                   max_seq_len=40, prefill_chunk=8, quant="kv8")


@pytest.mark.parametrize("spec_k", [2, 4])
def test_kv8_spec_engine_matches_jax_engine(spec_k):
    """The kv8 speculative engine on the CPU (plain versions) against the
    reference's kv8 speculative engine at the shapes of
    ``tests/test_spec_decode.py::test_spec_token_equality[kv8-K]``: more
    requests than slots, so retired pages are re-quantized by new
    sequences. The same tokens, verify steps and committed tokens, and
    the port's own kv8 plain engine's tokens; int8 pools, no plain decode
    step, a clean drain."""
    jcfg, jparams, cfg, model = _spec_cfgs()
    jeng = JaxServingEngine(jcfg, jparams, **SPEC_ENGINE, speculative=spec_k)
    jreqs = _spec_requests(JaxRequest, cfg.vocab_size)
    jres = jeng.run(jreqs)
    eng = ServingEngine(cfg, model, **SPEC_ENGINE, device="cpu",
                        speculative=spec_k)
    assert eng.cache[0]["k_pages"].dtype == torch.int8
    reqs = _spec_requests(Request, cfg.vocab_size)
    res = eng.run(reqs)
    plain = _spec_requests(Request, cfg.vocab_size)
    ServingEngine(cfg, model, **SPEC_ENGINE, device="cpu").run(plain)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert [r.tokens for r in reqs] == [r.tokens for r in plain]
    assert all(len(r.tokens) == r.max_new_tokens for r in reqs)
    sp, jsp = res["speculative"], jres["speculative"]
    for key in ("draft_k", "verify_steps", "committed_tokens",
                "accepted_per_step", "fallbacks", "degraded"):
        assert sp[key] == jsp[key], key
    assert sp["committed_tokens"] == res["generated_tokens"] - len(reqs)
    assert res["decode_steps"] == 0 and res["verify_passes"] > 0
    # drafts both accepted and rejected: the rollback over int8 pools runs
    assert 1.0 < sp["accepted_per_step"] < spec_k, sp
    eng.scheduler.check_invariants()
    assert eng.pool.num_allocated == 0


def test_kv8_spec_preempted_run_matches_ample_pool():
    """A kv8 pool too small for the K-token bursts preempts mid-burst; the
    resumed requests re-prefill and re-quantize, and still give the ample
    kv8 plain run's tokens."""
    _, _, cfg, model = _spec_cfgs()
    kw = dict(page_size=4, max_batch=2, max_seq_len=36, prefill_chunk=4,
              quant="kv8", device="cpu")
    plain = _spec_requests(Request, cfg.vocab_size, n=4, gen=8, seed=5)
    big = ServingEngine(cfg, model, num_pages=64, **kw)
    big.run(plain)
    assert big.scheduler.preemptions == 0
    reqs = _spec_requests(Request, cfg.vocab_size, n=4, gen=8, seed=5)
    tight = ServingEngine(cfg, model, num_pages=9, **kw, speculative=4)
    res = tight.run(reqs)
    assert tight.scheduler.preemptions > 0 and tight.scheduler.resumes > 0
    assert [r.tokens for r in reqs] == [r.tokens for r in plain]
    assert res["terminal_requests"] == 4
    tight.scheduler.check_invariants()
    assert tight.pool.num_allocated == 0


def test_kv8_spec_non_finite_burst_degrades_to_int8_decode(monkeypatch):
    """A non-finite verify burst under kv8 commits nothing and the engine
    goes on by plain decode through ``paged_decode`` over the same int8
    pools and scale pools; the tokens are the kv8 plain run's."""
    _, _, cfg, model = _spec_cfgs()
    kw = dict(SPEC_ENGINE, device="cpu")
    plain = _spec_requests(Request, cfg.vocab_size)
    ServingEngine(cfg, model, **kw).run(plain)
    real_verify, real_decode = lm.verify_step_paged, ops.pd_kernel.paged_decode
    calls, pools = [], []

    def poisoned(*a, **k):
        logits, cache = real_verify(*a, **k)
        calls.append(1)
        if len(calls) == 2:
            logits[0, 1] = float("nan")
        return logits, cache

    def recording(q, k_pages, v_pages, *a, **k):
        pools.append((k_pages.data_ptr(), k_pages.dtype,
                      k.get("k_scales") is not None))
        return real_decode(q, k_pages, v_pages, *a, **k)

    monkeypatch.setattr(lm, "verify_step_paged", poisoned)
    monkeypatch.setattr(ops.pd_kernel, "paged_decode", recording)
    eng = ServingEngine(cfg, model, **kw, speculative=4)
    reqs = _spec_requests(Request, cfg.vocab_size)
    res = eng.run(reqs)
    sp = res["speculative"]
    assert sp["degraded"] and sp["fallbacks"] == 1
    assert res["verify_passes"] == 2 and res["decode_steps"] > 0
    assert res["failed_requests"] == 0
    assert [r.tokens for r in reqs] == [r.tokens for r in plain]
    layer_pools = {layer["k_pages"].data_ptr() for layer in eng.cache}
    assert len(pools) == res["decode_steps"] * cfg.n_layers
    assert all(ptr in layer_pools and dt == torch.int8 and scaled
               for ptr, dt, scaled in pools)


def test_kv8_refusals(weights):
    """What waits for later slices raises, and a pool of the wrong kv
    dtype is refused."""
    _, _, cfg, model = weights
    with pytest.raises(ValueError, match="conflicts"):
        ServingEngine(cfg, model, opts=lm.ForwardOpts(), quant="kv8",
                      device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError, match="weight policies"):
        ServingEngine(cfg, model, quant="w8a8", device="cpu", **ENGINE)
    pools = lm.init_paged_cache(cfg, 4, 8, device="cpu", kv_dtype="int8")
    tok, tables = torch.ones(1, 2, dtype=torch.long), torch.tensor([[1, 2]])
    with pytest.raises(ValueError, match="kv dtype"):
        lm.decode_step_paged(model, cfg, tok[:, :1], pools, tables,
                             torch.tensor([3]), lm.ForwardOpts())
    with pytest.raises(ValueError, match="kv dtype"):
        lm.decode_step_paged(model, cfg, tok[:, :1],
                             lm.init_paged_cache(cfg, 4, 8, device="cpu"),
                             tables, torch.tensor([3]),
                             lm.ForwardOpts(quant="kv8"))
    with pytest.raises(ValueError, match="kv_dtype"):
        lm.init_paged_cache(cfg, 4, 8, device="cpu", kv_dtype="int4")
    for argv in (["--quant", "w8a8"], ["--quant", "w8a16"]):
        with pytest.raises(NotImplementedError):
            serve.main(argv)


def test_serve_kv8_lookups_use_int8_contexts(monkeypatch, weights):
    """Under kv8 the launcher's deployment lookup is the canonical
    scenario at dtype int8 with q in bf16, and the engine's paged_decode
    context is the int8 one at the pool layout: each a key of its own."""
    from repro_torch.core import cpu_host
    monkeypatch.setattr(serve.ops, "device_chip", lambda index: cpu_host())
    full = get_config(ARCH)
    chip = cpu_host()
    plain, kv8 = (serve.deployment_context(full, chip, q)
                  for q in (None, "kv8"))
    assert plain.dtype == "bfloat16" and plain.extra == {}
    assert kv8.dtype == "int8" and kv8.extra == {"q_dtype": "bfloat16"}
    assert kv8.shapes == plain.shapes
    assert plain.signature() != kv8.signature()
    _, _, cfg, model = weights
    eng = ServingEngine(cfg, model, quant="kv8", device="cpu", **ENGINE)
    (kernel, ctx), = serve.engine_contexts(eng)
    assert kernel is ops.PAGED_DECODE and ctx.dtype == "int8"
    # the smoke model's q is f32, the reference's default: no extra key
    assert ctx.extra == {"page_size": 8}
    float_ctx = serve.engine_contexts(
        ServingEngine(cfg, model, device="cpu", **ENGINE))[0][1]
    assert ctx.signature() != float_ctx.signature()


def test_serve_kv8_verify_lookups_use_int8_contexts(monkeypatch, weights):
    """Under kv8 the launcher's ``paged_verify`` deployment lookup (whose
    winner gives the bare ``--speculative`` its depth) is the canonical
    scenario at dtype int8 with q in bf16, a key apart from the bf16
    pools'; the kv8 speculative engine's contexts are the int8 ones at
    the pool layout and depth for both kernels, q in the model's dtype."""
    from repro_torch.core import cpu_host
    monkeypatch.setattr(serve.ops, "device_chip", lambda index: cpu_host())
    full = get_config(ARCH)
    chip = cpu_host()
    plain, kv8 = (serve.verify_deployment_context(full, chip, q)
                  for q in (None, "kv8"))
    assert plain.dtype == "bfloat16" and plain.extra == {}
    assert kv8.dtype == "int8" and kv8.extra == {"q_dtype": "bfloat16"}
    assert kv8.shapes == plain.shapes
    assert plain.signature() != kv8.signature()
    _, _, cfg, model = weights
    eng = ServingEngine(cfg, model, quant="kv8", device="cpu",
                        speculative=4, **ENGINE)
    eng.cfg = dataclasses.replace(cfg, dtype="bfloat16")   # q in bf16
    contexts = {k.name: c for k, c in serve.engine_contexts(eng)}
    for name in ("paged_decode", "paged_verify"):
        assert contexts[name].dtype == "int8", name
        assert contexts[name].extra["q_dtype"] == "bfloat16", name
    assert contexts["paged_verify"].extra == {
        "page_size": 8, "draft_k": 4, "q_dtype": "bfloat16"}
    eng.cfg = cfg
    ctx = dict((k.name, c) for k, c in serve.engine_contexts(eng))[
        "paged_verify"]
    assert ctx.dtype == "int8" and ctx.extra == {"page_size": 8,
                                                 "draft_k": 4}
    float_ctx = dict((k.name, c) for k, c in serve.engine_contexts(
        ServingEngine(cfg, model, device="cpu", speculative=4,
                      **ENGINE)))["paged_verify"]
    assert float_ctx.dtype == "float32"
    assert ctx.signature() != float_ctx.signature()
