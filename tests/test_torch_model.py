"""The port's model held against the JAX ``lm`` on the very same weights.

The reference's ``init_params(PRNGKey(0), lm_specs(phi4-mini SMOKE))`` tree
is carried into the port by ``from_numpy_tree``; chunked prefill and paged
decode then run on both sides over identical pools and block tables, and
the logits and the written pages must agree at the f32 tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.param import init_params as jax_init_params

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import lm
from repro_torch.models.param import from_numpy_tree, init_params

ARCH = "phi4-mini-3.8b"
F32_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def both():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = jax_init_params(jax.random.PRNGKey(0), jlm.lm_specs(jcfg))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = get_config(ARCH, smoke=True)
    return jcfg, jparams, tree, cfg, from_numpy_tree(tree, cfg, device="cpu")


def test_from_numpy_tree_unstacks_scan_units(both):
    jcfg, _, tree, cfg, model = both
    assert cfg.name == jcfg.name
    (unit, reps), = cfg.scan_plan()
    assert reps == cfg.n_layers == len(model.layers)
    for i, block in enumerate(model.layers):
        lt = tree["u0"]["l0"]
        np.testing.assert_array_equal(block.mix.wq.numpy(), lt["mix"]["wq"][i])
        np.testing.assert_array_equal(block.ffn.wo.numpy(), lt["ffn"]["wo"][i])
        np.testing.assert_array_equal(block.ln2.w.numpy(), lt["ln2"]["w"][i])
    np.testing.assert_array_equal(model.embed.tok.numpy(),
                                  tree["embed"]["tok"])
    assert all(not p.requires_grad for p in model.parameters())


def test_init_params_follows_reference_rules():
    cfg = get_config(ARCH, smoke=True)
    m = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(m.final_ln.w, torch.ones(cfg.d_model))
    tok_std = float(m.embed.tok.std())          # scale 1.0
    wq_std = float(m.layers[0].mix.wq.std())    # 1/sqrt(fan_in)
    assert abs(tok_std - 1.0) < 0.05
    assert abs(wq_std - cfg.d_model ** -0.5) < 0.02
    m2 = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(m.layers[1].ffn.wi, m2.layers[1].ffn.wi)


def test_configs_cover_the_paged_archs():
    """The port's archs, the paged path's three dense GQA ones and the
    dense path's MoE (olmoe) and MLA + MoE (deepseek-v2-lite) ones, equal
    the reference's configs field by field, their MLA and MoE settings and
    scan plans included."""
    import dataclasses
    assert set(ARCHS) == {"phi4-mini-3.8b", "phi3-mini-3.8b", "stablelm-12b",
                          "olmoe-1b-7b", "deepseek-v2-lite-16b"}
    for name in ARCHS:
        for smoke in (False, True):
            ref = jax_get_config(name, smoke=smoke)
            ours = get_config(name, smoke=smoke)
            for field in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                          "head_dim", "d_ff", "vocab_size", "dtype",
                          "tie_embeddings", "rope_theta", "window",
                          "family", "first_dense", "d_ff_dense"):
                assert getattr(ours, field) == getattr(ref, field), field
            for field in ("mla", "moe"):
                mine, theirs = getattr(ours, field), getattr(ref, field)
                assert (mine is None) == (theirs is None), field
                if mine is not None:
                    assert dataclasses.asdict(mine) == \
                        dataclasses.asdict(theirs), field
            assert ours.scan_plan() == ref.scan_plan()


def _pages_np(cache):
    return [{k: v.numpy() for k, v in layer.items()} for layer in cache]


def _jax_pages(jcache, n_layers):
    c = jcache["u0"]["l0"]["self"]
    return [{k: np.asarray(c[k][i]) for k in ("k_pages", "v_pages")}
            for i in range(n_layers)]


def _assert_pages_equal(ours, jcache, n_layers):
    for i, (mine, theirs) in enumerate(zip(_pages_np(ours),
                                           _jax_pages(jcache, n_layers))):
        for k in mine:
            # page 0 is scratch: inactive rows write there in any order
            np.testing.assert_allclose(mine[k][:, 1:], theirs[k][:, 1:],
                                       err_msg=f"layer {i} {k}", **F32_TOL)


@pytest.mark.parametrize("norm_impl,decode_impl",
                         [("plain", "plain"), ("kernel", "kernel")])
def test_prefill_and_decode_match_jax_lm(both, norm_impl, decode_impl):
    jcfg, jparams, _, cfg, model = both
    opts = lm.ForwardOpts(decode_impl=decode_impl, norm_impl=norm_impl)
    num_pages, ps = 12, 4
    tables = np.array([[1, 2, 3, 4, 0], [5, 6, 7, 0, 0], [0, 0, 0, 0, 0]],
                      np.int32)
    rng = np.random.default_rng(0)
    cache = lm.init_paged_cache(cfg, num_pages, ps, device="cpu")
    jcache = jlm.init_paged_cache(jcfg, num_pages, ps)

    def t(a):
        return torch.from_numpy(np.asarray(a))

    # two prefill chunks (the second resumes mid-sequence), then one decode
    # step with an inactive third slot on the scratch table
    for start in ([0, 0], [5, 2]):
        toks = rng.integers(1, cfg.vocab_size, (2, 5)).astype(np.int32)
        st = np.asarray(start, np.int32)
        logits, cache = lm.prefill_paged(model, cfg, t(toks), cache,
                                         t(tables[:2]), t(st), opts)
        jlogits, jcache = jlm.prefill_paged(
            jparams, jcfg, jnp.asarray(toks), jcache,
            jnp.asarray(tables[:2]), jnp.asarray(st))
        assert logits.dtype == torch.float32 and logits.shape == (2, 5, 512)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **F32_TOL)
        _assert_pages_equal(cache, jcache, cfg.n_layers)

    tok = rng.integers(1, cfg.vocab_size, (3, 1)).astype(np.int32)
    lens = np.array([10, 7, 0], np.int32)
    dec_tables = tables.copy()
    logits, cache = lm.decode_step_paged(model, cfg, t(tok), cache,
                                         t(dec_tables), t(lens), opts)
    jlogits, jcache = jlm.decode_step_paged(
        jparams, jcfg, jnp.asarray(tok), jcache, jnp.asarray(dec_tables),
        jnp.asarray(lens), jlm.ForwardOpts(decode_impl="paged"))
    assert logits.shape == (3, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **F32_TOL)
    _assert_pages_equal(cache, jcache, cfg.n_layers)


def test_check_paged_refuses_windowed_archs():
    import dataclasses
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), window=16)
    with pytest.raises(NotImplementedError, match="paged serving"):
        lm.LM(cfg, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _prefilled(both, rng):
    """Both sides' pools after one prefill chunk of 6 and one of 4 tokens
    on two sequences (tables as in the test above)."""
    jcfg, jparams, _, cfg, model = both
    tables = np.array([[1, 2, 3, 4, 0], [5, 6, 7, 0, 0], [0, 0, 0, 0, 0]],
                      np.int32)
    cache = lm.init_paged_cache(cfg, 12, 4, device="cpu")
    jcache = jlm.init_paged_cache(jcfg, 12, 4)
    toks = rng.integers(1, cfg.vocab_size, (2, 6)).astype(np.int32)
    st = np.zeros(2, np.int32)
    _, cache = lm.prefill_paged(model, cfg, _t(toks), cache, _t(tables[:2]),
                                _t(st), lm.ForwardOpts(decode_impl="plain"))
    _, jcache = jlm.prefill_paged(jparams, jcfg, jnp.asarray(toks), jcache,
                                  jnp.asarray(tables[:2]), jnp.asarray(st))
    return tables, cache, jcache


@pytest.mark.parametrize("draft_k", [2, 4])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_verify_step_matches_jax_lm(both, draft_k, impl):
    """Logits (B, K, vocab) and the pages the K positions write, against
    the JAX verify step on the same weights, pools and tables; the third
    slot is inactive (lens 0, the scratch table)."""
    jcfg, jparams, _, cfg, model = both
    rng = np.random.default_rng(draft_k)
    tables, cache, jcache = _prefilled(both, rng)
    toks = rng.integers(1, cfg.vocab_size, (3, draft_k)).astype(np.int32)
    lens = np.array([6, 5, 0], np.int32)
    opts = lm.ForwardOpts(decode_impl=impl, norm_impl=impl)
    logits, cache = lm.verify_step_paged(model, cfg, _t(toks), cache,
                                         _t(tables), _t(lens), opts)
    jlogits, jcache = jlm.verify_step_paged(
        jparams, jcfg, jnp.asarray(toks), jcache, jnp.asarray(tables),
        jnp.asarray(lens))
    assert logits.dtype == torch.float32
    assert logits.shape == (3, draft_k, cfg.vocab_size)
    np.testing.assert_allclose(logits[:2].numpy(), np.asarray(jlogits)[:2],
                               **F32_TOL)
    _assert_pages_equal(cache, jcache, cfg.n_layers)


def test_verify_position_t_is_t_plus_one_decode_steps(both):
    """Position t's logits equal what t+1 sequential one-token decode
    steps give on the same tokens."""
    _, _, _, cfg, model = both
    rng = np.random.default_rng(11)
    tables, cache, _ = _prefilled(both, rng)
    dec_cache = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    K = 4
    toks = rng.integers(1, cfg.vocab_size, (3, K)).astype(np.int32)
    lens = np.array([6, 5, 0], np.int32)
    verify, _ = lm.verify_step_paged(model, cfg, _t(toks), cache,
                                     _t(tables), _t(lens))
    for t in range(K):
        step, dec_cache = lm.decode_step_paged(
            model, cfg, _t(toks[:, t:t + 1]), dec_cache, _t(tables),
            _t(np.where(lens > 0, lens + t, 0).astype(np.int32)))
        np.testing.assert_allclose(verify[:2, t].numpy(), step[:2].numpy(),
                                   err_msg=f"position {t}", **F32_TOL)
