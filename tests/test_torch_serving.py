"""The port's serving engine held against the JAX engine, plus the port's
package boundary.

The engine test reuses the setup of
``tests/test_paged_serving.py::test_paged_engine_matches_dense_reference``
(seed-42 requests, 24 pages of 8, max_batch 3, max_seq_len 24, prefill
chunk 4) on phi4-mini SMOKE with the reference's weights. Tokens must be
equal; since a random smoke model often repeats tokens, the logits each
token was taken from are also held against the JAX dense path.
"""

import ast
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.param import init_params as jax_init_params
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving import NgramDrafter as JaxNgramDrafter
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import from_numpy_tree
from repro_torch.serving import (
    NgramDrafter, PagePool, Request, RequestState, Scheduler, ServingEngine,
)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
ARCH = "phi4-mini-3.8b"
F32_TOL = dict(atol=1e-4, rtol=1e-4)
ENGINE = dict(num_pages=24, page_size=8, max_batch=3, max_seq_len=24,
              prefill_chunk=4)


def _requests(cls, vocab):
    rng = np.random.default_rng(42)
    return [cls(rid=i, prompt=rng.integers(1, vocab, int(p)).astype(np.int32),
                max_new_tokens=int(g))
            for i, (p, g) in enumerate(zip(rng.integers(2, 10, 5),
                                           rng.integers(1, 5, 5)))]


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = jax_init_params(jax.random.PRNGKey(0), jlm.lm_specs(jcfg))
    cfg = get_config(ARCH, smoke=True)
    return jcfg, jparams, cfg, from_numpy_tree(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _dense_logits(jparams, jcfg, prompt, tokens):
    """Logits the JAX dense path gives before each of ``tokens``."""
    P = len(prompt)
    lg, cache = jlm.prefill(jparams, jcfg, jnp.asarray(prompt[None]),
                            max_len=P + len(tokens),
                            opts=jlm.ForwardOpts(attn_impl="full"))
    out = [np.asarray(lg[0])]
    for i, tok in enumerate(tokens[:-1]):
        lg, cache = jlm.decode_step(
            jparams, jcfg, jnp.asarray([[tok]], jnp.int32), cache,
            jnp.int32(P + i), opts=jlm.ForwardOpts(decode_impl="full"))
        out.append(np.asarray(lg[0]))
    return out


def test_engine_matches_jax_engine(weights):
    jcfg, jparams, cfg, model = weights
    jreqs = _requests(JaxRequest, cfg.vocab_size)
    jeng = JaxServingEngine(jcfg, jparams, **ENGINE)
    assert jeng.run(jreqs)["requests"] == len(jreqs)

    reqs = _requests(Request, cfg.vocab_size)
    eng = ServingEngine(cfg, model, device="cpu", record_logits=True,
                        **ENGINE)
    res = eng.run(reqs)
    assert res["requests"] == res["terminal_requests"] == len(reqs)
    eng.scheduler.check_invariants()
    assert eng.pool.num_allocated == 0
    for mine, theirs in zip(reqs, jreqs):
        assert mine.tokens == theirs.tokens, f"request {mine.rid}"
        want = _dense_logits(jparams, jcfg, mine.prompt, mine.tokens)
        got = eng.logits_log[mine.rid]
        assert len(got) == len(want) == mine.max_new_tokens
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, err_msg=f"req {mine.rid} "
                                       f"token {step}", **F32_TOL)


def test_preempted_run_matches_uninterrupted(weights):
    """A pool too small for every sequence's growth forces preemption;
    exact resume must give the same greedy tokens as an ample pool."""
    _, _, cfg, model = weights
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 12, 7, 10)]

    def run(num_pages):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        eng = ServingEngine(cfg, model, num_pages=num_pages, page_size=4,
                            max_batch=4, max_seq_len=32, prefill_chunk=4,
                            device="cpu")
        res = eng.run(reqs)
        eng.scheduler.check_invariants()
        assert eng.pool.num_allocated == 0
        return [r.tokens for r in reqs], res

    ample, res_a = run(40)
    tight, res_t = run(13)
    assert res_a["preemptions"] == 0 and res_t["preemptions"] > 0
    assert res_t["resumes"] > 0
    assert tight == ample


def test_scheduler_random_trace_keeps_invariants():
    rng = np.random.default_rng(0)
    pool = PagePool(num_pages=20, page_size=4)
    sched = Scheduler(pool, max_batch=3, max_pages=8, prefill_chunk=4)
    reqs = [Request(rid=i, prompt=np.ones(int(rng.integers(1, 12)), np.int32),
                    max_new_tokens=int(rng.integers(1, 10)))
            for i in range(12)]
    for r in reqs:
        sched.submit(r)
    for _ in range(500):
        if not sched.has_work():
            break
        sched.retire_finished()
        sched.admit()
        chunk = sched.next_prefill()
        if chunk is not None:
            b, _, _, valid = chunk
            sched.mark_prefilled(b, valid)
            seq = sched.slots[b]
            if seq.prompt_done and not seq.req.tokens:
                seq.req.tokens.append(1)
        mask = sched.decode_mask()
        for b in np.nonzero(mask)[0]:
            sched.slots[int(b)].req.tokens.append(1)
        sched.advance_decoded(mask)
        sched.check_invariants()
    sched.retire_finished()
    assert not sched.has_work()
    assert all(r.state is RequestState.FINISHED for r in reqs)
    assert pool.num_allocated == 0


def test_scheduler_lifecycle_cancel_and_deadline():
    pool = PagePool(num_pages=12, page_size=4)
    sched = Scheduler(pool, max_batch=1, max_pages=4, prefill_chunk=4)
    running = Request(rid=0, prompt=np.ones(5, np.int32), max_new_tokens=3)
    late = Request(rid=1, prompt=np.ones(3, np.int32), max_new_tokens=2,
                   deadline=5.0)
    dropped = Request(rid=2, prompt=np.ones(3, np.int32), max_new_tokens=2)
    for r in (running, late, dropped):
        sched.submit(r)
    assert sched.admit(now=1.0) == [0]          # one slot: 1 and 2 wait
    dropped.cancel()
    sched.admit(now=6.0)                        # past late's deadline
    assert late.state is RequestState.TIMED_OUT
    assert dropped.state is RequestState.FAILED
    assert dropped.failure_reason == "cancelled"
    running.cancel()
    sched.admit(now=7.0)
    assert running.state is RequestState.FAILED
    assert not sched.has_work() and pool.num_allocated == 0
    sched.check_invariants()
    assert (sched.failures, sched.timeouts) == (2, 1)


def test_oversized_request_fails_as_result(weights):
    _, _, cfg, model = weights
    eng = ServingEngine(cfg, model, device="cpu", **ENGINE)
    big = Request(rid=0, prompt=np.ones(30, np.int32), max_new_tokens=4)
    res = eng.run([big])
    assert big.state is RequestState.FAILED and res["failed_requests"] == 1


def test_entry_points_default_to_the_card(weights):
    """Entry points run on the card unless the caller asks for the CPU:
    the model, the pools and the converted weights default to "cuda", the
    engine follows its model's device, and the launchers raise without a
    card (``test_serve_raises_without_a_gpu``; the train launcher's in
    ``tests/test_torch_train.py``)."""
    from repro_torch.launch import serve, train
    from repro_torch.models.param import init_params
    for fn in (lm.LM, lm.init_paged_cache, lm.init_cache, from_numpy_tree,
               init_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__name__
    for launcher in (serve, train):
        assert launcher.build_parser().get_default("device") == "cuda"
    _, _, cfg, model = weights
    eng = ServingEngine(cfg, model, **ENGINE)
    assert eng.device == torch.device("cpu")
    assert all(t.device == eng.device for layer in eng.cache
               for t in layer.values())


def test_serve_raises_without_a_gpu(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1", "--prompt-len", "4", "--gen", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1", "--prompt-len", "4", "--gen", "2",
                    "--decode-impl", "pallas"])


def test_engine_contexts_skip_off_space_layouts(monkeypatch, weights):
    """An engine with pages of 4, or speculating at depth 5, has no
    paged_decode or paged_verify context to tune (those dispatch a fixed
    config), so ``prepare`` does not ask the tuner for a space with no
    valid config; its rms_norm contexts stay."""
    from repro_torch.core import cpu_host
    from repro_torch.launch import serve
    monkeypatch.setattr(serve.ops, "device_chip", lambda index: cpu_host())
    _, _, cfg, model = weights
    names = {}
    for ps, K in ((8, 0), (8, 4), (8, 5), (4, 0), (4, 5)):
        eng = ServingEngine(cfg, model, **dict(ENGINE, page_size=ps),
                            speculative=K)
        names[ps, K] = sorted(k.name for k, _ in serve.engine_contexts(eng))
    assert names[8, 0] == ["paged_decode"]
    assert names[8, 4] == ["paged_decode", "paged_verify"]
    assert names[8, 5] == ["paged_decode"]
    assert names[4, 0] == names[4, 5] == []


def test_serve_sizes_pool_like_the_reference():
    from repro_torch.launch import serve
    assert serve.pool_page_size(64, 544) == 64
    assert serve.pool_page_size(128, 20) == 16
    assert serve.pool_page_size(8, 3) == 8


# --- speculative decoding -----------------------------------------------------

def test_drafter_matches_jax_drafter():
    """Seeded streams with repeats: after every observed prefix both
    drafters propose the same drafts at every depth."""
    rng = np.random.default_rng(0)
    for trial in range(6):
        motif = rng.integers(0, 9, int(rng.integers(2, 6))).tolist()
        stream = []
        while len(stream) < 48:
            stream += (motif if rng.random() < 0.6
                       else rng.integers(0, 9, 3).tolist())
        min_n, max_n = (1, 4) if trial % 2 == 0 else (2, 3)
        ours, theirs = NgramDrafter(min_n, max_n), JaxNgramDrafter(min_n,
                                                                   max_n)
        for n in range(0, len(stream), 5):
            ours.observe(stream[:n])
            theirs.observe(stream[:n])
            for k in (1, 3, 7):
                assert ours.propose(k) == theirs.propose(k), (trial, n, k)
        assert ours.observed == theirs.observed


def _tiny_cfgs(vocab=128, n_layers=2):
    """The reference's speculative test model (``tests/test_spec_decode.py``)
    on both sides."""
    fields = dict(name="spec-t", family="dense", n_layers=n_layers,
                  d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                  vocab_size=vocab, dtype="float32")
    return JaxModelConfig(**fields), ModelConfig(**fields)


def _tiny_models(vocab=128, n_layers=2):
    jcfg, cfg = _tiny_cfgs(vocab, n_layers)
    jparams = jax_init_params(jax.random.PRNGKey(0), jlm.lm_specs(jcfg))
    model = from_numpy_tree(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


def _spec_requests(cls, vocab, n=6, gen=12, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=rng.integers(1, vocab,
                                    int(rng.integers(6, 14))).astype(np.int32),
                max_new_tokens=gen, arrival=float(i))
            for i in range(n)]


# (draft_k, vocab, n_layers, gen): the reference's token-equality model,
# and its repetition-prone acceptance model at depth 4
SPEC_CASES = [(2, 128, 2, 12), (4, 128, 2, 12), (4, 64, 1, 24)]


@pytest.mark.parametrize("draft_k,vocab,n_layers,gen", SPEC_CASES)
def test_spec_engine_matches_jax_engine(draft_k, vocab, n_layers, gen):
    """More requests than slots (retirement recycles pages mid-trace): the
    port's speculative engine gives the JAX speculative engine's tokens,
    verify steps and committed tokens, and the port's own plain tokens."""
    jcfg, jparams, cfg, model = _tiny_models(vocab, n_layers)
    kw = dict(num_pages=1 + 4 * 6, page_size=8, max_batch=4, max_seq_len=48,
              prefill_chunk=8)
    jeng = JaxServingEngine(jcfg, jparams, **kw, speculative=draft_k)
    jreqs = _spec_requests(JaxRequest, vocab, gen=gen)
    jres = jeng.run(jreqs)

    reqs = _spec_requests(Request, vocab, gen=gen)
    eng = ServingEngine(cfg, model, **kw, device="cpu", speculative=draft_k)
    res = eng.run(reqs)
    plain = _spec_requests(Request, vocab, gen=gen)
    ServingEngine(cfg, model, **kw, device="cpu").run(plain)

    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert [r.tokens for r in reqs] == [r.tokens for r in plain]
    assert all(len(r.tokens) == gen for r in reqs)
    sp, jsp = res["speculative"], jres["speculative"]
    for key in ("draft_k", "verify_steps", "committed_tokens",
                "accepted_per_step", "fallbacks", "degraded"):
        assert sp[key] == jsp[key], key
    assert sp["committed_tokens"] == res["generated_tokens"] - len(reqs)
    assert res["decode_steps"] == 0 and res["verify_passes"] > 0
    # drafts both accepted and rejected: the rollback path runs
    assert 1.0 < sp["accepted_per_step"] < draft_k, sp
    eng.scheduler.check_invariants()
    assert eng.pool.num_allocated == 0


def test_spec_preempted_run_matches_ample_pool():
    """A pool too small for the K-token bursts preempts mid-burst; the
    resumed requests still give the ample plain run's tokens."""
    _, _, cfg, model = _tiny_models()
    kw = dict(page_size=4, max_batch=2, max_seq_len=36, prefill_chunk=4,
              device="cpu")
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


def test_spec_non_finite_burst_degrades_to_decode(monkeypatch):
    """A non-finite verify burst commits nothing, switches the engine to
    plain decode, and the run still gives the plain tokens."""
    _, _, cfg, model = _tiny_models()
    kw = dict(num_pages=25, page_size=8, max_batch=4, max_seq_len=48,
              prefill_chunk=8, device="cpu")
    plain = _spec_requests(Request, cfg.vocab_size)
    ServingEngine(cfg, model, **kw).run(plain)
    real = lm.verify_step_paged
    calls = []

    def poisoned(*a, **k):
        logits, cache = real(*a, **k)
        calls.append(1)
        if len(calls) == 2:
            logits[0, 1] = float("nan")
        return logits, cache

    monkeypatch.setattr(lm, "verify_step_paged", poisoned)
    reqs = _spec_requests(Request, cfg.vocab_size)
    eng = ServingEngine(cfg, model, **kw, speculative=4)
    res = eng.run(reqs)
    sp = res["speculative"]
    assert sp["degraded"] and sp["fallbacks"] == 1
    assert res["verify_passes"] == 2 and res["decode_steps"] > 0
    assert res["failed_requests"] == 0
    assert [r.tokens for r in reqs] == [r.tokens for r in plain]


def test_commit_verify_keeps_burst_reservation():
    """Rollback does not free the rejected tail's pages: a slot's page
    list only grows while it is occupied (the device-table cache relies
    on it), as ``tests/test_spec_decode.py`` pins for the reference."""
    pool = PagePool(16, 4)
    sched = Scheduler(pool, max_batch=1, max_pages=8, prefill_chunk=4,
                      spec_k=4)
    req = Request(rid=0, prompt=np.arange(1, 8, dtype=np.int32),
                  max_new_tokens=8)
    sched.submit(req)
    sched.admit()
    seq = sched.slots[0]
    seq.pos = 7
    seq.prompt_done = True
    req.tokens = [9]
    assert sched.decode_mask(lookahead=4).all()
    pages_before = list(seq.pages)      # covers pos + 4 = 11: 3 pages
    assert len(pages_before) == 3
    req.tokens.append(1)
    sched.commit_verify(0, 1)           # 1 of 4 positions accepted
    assert seq.pos == 8 and seq.pages == pages_before
    sched.check_invariants()
    with pytest.raises(ValueError):
        sched.commit_verify(0, 5)


def test_max_tokens_charges_verify_burst():
    """Admission charges the K-token scatter up front: the deepest verify
    step holds total - 2 + K resident tokens, and a request whose burst
    overflows the table width fails at submit."""
    pool = PagePool(64, 4)
    plain = Scheduler(pool, max_batch=1, max_pages=16)
    spec = Scheduler(pool, max_batch=1, max_pages=16, spec_k=6)
    req = Request(rid=0, prompt=np.ones(9, np.int32), max_new_tokens=8)
    assert plain.max_tokens(req) == 17
    assert spec.max_tokens(req) == 9 + 8 - 2 + 6
    tiny = Scheduler(PagePool(64, 4), max_batch=1, max_pages=5, spec_k=6)
    big = Request(rid=1, prompt=np.ones(9, np.int32), max_new_tokens=8)
    tiny.submit(big)
    assert big.state is RequestState.FAILED
    assert "table width" in big.failure_reason


# --- package boundary ----------------------------------------------------------

def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_reference():
    files = list(_port_files())
    assert len(files) > 20
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{os.path.relpath(path, REPO)} imports {name}"


def test_importing_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.kernels.ops, "
            "repro_torch.kernels.paged_verify, repro_torch.serving.drafter, "
            "repro_torch.launch.serve; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'repro' not in sys.modules, 'repro imported'; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
