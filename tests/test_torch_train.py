"""The port's training path held against the JAX package's.

On phi4-mini-smoke in float32, from the reference's own
``init_params(PRNGKey(0))`` weights carried over by ``from_numpy_tree``:
``lm.loss_fn``'s value, metrics and gradients (restacked by
``to_numpy_tree``) against ``jax.value_and_grad(lm.loss_fn)`` by chunked
and by pallas attention (the reference's Pallas pair in interpret mode),
with masked labels; AdamW's ``apply_updates`` over three steps against the
reference's on the same numpy params, gradients and state, the clip and
the decay rule on the reference's stacked tree included, and every
schedule; ``TokenStream`` byte for byte; the checkpoint and trainer tests
of ``tests/test_substrate.py`` mirrored on the port's tensors; ``ef_compress``;
the launcher's losses against the reference's ``Trainer`` on the same
weights and data; and what training refuses by name. Tolerance: the
reference's f32 1e-4 and rtol 1e-4 (``tests/test_kernel_oracles.py``
``_tol``) where two frameworks compute, exact where the port meets itself.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.launch import steps as jsteps
from repro.launch.mesh import make_local_mesh
from repro.models import lm as jlm
from repro.models.param import init_params as jax_init_params
from repro.optim import adamw as jadamw
from repro.runtime import compression as jcompression
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenStream
from repro_torch.launch import steps, train
from repro_torch.models import attention as ATT
from repro_torch.models import lm
from repro_torch.models.param import (
    from_numpy_tree, init_params, stacked_ndims, to_numpy_tree,
)
from repro_torch.optim import adamw
from repro_torch.runtime import (
    InjectedFailure, Trainer, TrainerConfig, compression,
)

ARCH = "phi4-mini-3.8b"
F32_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ref_weights():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = jax_init_params(jax.random.PRNGKey(0), jlm.lm_specs(jcfg))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams), \
        get_config(ARCH, smoke=True)


def _pairs(a, b, path=""):
    """(path, a leaf, b leaf) over two trees nested alike."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def _assert_trees_close(got, want, **tol):
    for path, g, w in _pairs(got, want):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, err_msg=path, **tol)


def _batch(cfg, B=2, S=16, seed=4, masked=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    if masked:
        labels[0, :5] = -1
        labels[1, -3:] = -1
    return {"tokens": tokens, "labels": labels}


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("impl,masked", [("chunked", False),
                                         ("chunked", True),
                                         ("pallas", True)])
def test_loss_metrics_and_grads_match_reference(ref_weights, impl, masked):
    """loss_fn's value, its metrics and every parameter's gradient equal
    the reference's jax.value_and_grad(lm.loss_fn) on the same weights and
    batch, leaf by leaf on the reference's stacked tree."""
    jcfg, jparams, tree, cfg = ref_weights
    batch = _batch(cfg, masked=masked)
    jopts = jlm.ForwardOpts(attn_impl=impl, attn_chunk=8)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, batch, jopts), has_aux=True)(jparams)
    model = from_numpy_tree(tree, cfg, "cpu", trainable=True)
    loss, metrics = lm.loss_fn(model, cfg, _port_batch(batch),
                               lm.ForwardOpts(attn_impl=impl, attn_chunk=8))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **F32_TOL)
    for k in ("ce", "aux", "acc", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   err_msg=k, **F32_TOL)
    if masked:
        assert float(metrics["tokens"]) == 2 * 16 - 8
    grads = to_numpy_tree(model, cfg, {n: p.grad for n, p in
                                       model.named_parameters()})
    _assert_trees_close(grads, jax.tree.map(np.asarray, jgrads), **F32_TOL)


def test_to_numpy_tree_inverts_from_numpy_tree(ref_weights):
    _, _, tree, cfg = ref_weights
    model = from_numpy_tree(tree, cfg, "cpu", trainable=True)
    assert all(p.requires_grad for p in model.parameters())
    _assert_trees_close(to_numpy_tree(model, cfg), tree, rtol=0, atol=0)
    ndims = stacked_ndims(model, cfg)
    assert ndims["layers.0.ln1.w"] == ndims["layers.1.ln2.w"] == 2
    assert ndims["final_ln.w"] == 1 and ndims["embed.tok"] == 2
    assert ndims["layers.1.mix.wq"] == 3


def test_remat_full_gives_the_same_gradients(ref_weights):
    """remat "full" recomputes each layer in the backward: the same loss
    and gradients, bit for bit, as keeping the activations."""
    _, _, tree, cfg = ref_weights
    batch = _port_batch(_batch(cfg))
    out = []
    for remat in ("none", "full"):
        model = from_numpy_tree(tree, cfg, "cpu", trainable=True)
        loss, _ = lm.loss_fn(model, cfg, batch,
                             lm.ForwardOpts(attn_impl="pallas",
                                            remat=remat))
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def _grad_tree(tree, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape))
                        .astype(np.float32), tree)


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_matches_reference_over_three_steps(ref_weights, clip):
    """Three apply_updates on the same numpy params, gradients and state:
    the port's parameters, moments, grad norm and lr equal the
    reference's, with the decay rule read on the reference's stacked tree
    (the per-layer norm weights are (2, 64) there and decayed); deciding
    by the port's own 1-D norm weights would leave them undecayed and
    apart from the reference's."""
    _, _, tree, cfg = ref_weights
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jcfg = jadamw.AdamWConfig(**ocfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jadamw.init_state(jcfg, jp)
    tcfg = adamw.AdamWConfig(**ocfg)
    model = from_numpy_tree(tree, cfg, "cpu")
    own = from_numpy_tree(tree, cfg, "cpu")           # the 1-D decay rule
    params, own_params = (dict(m.named_parameters()) for m in (model, own))
    ndims = stacked_ndims(model, cfg)
    state = adamw.init_state(tcfg, params)
    own_state = adamw.init_state(tcfg, own_params)
    for i in range(3):
        gtree = _grad_tree(tree, 10 + i, scale=0.5)
        jp, jstate, jm = jadamw.apply_updates(
            jcfg, jp, jax.tree.map(jnp.asarray, gtree), jstate)
        grads = dict(from_numpy_tree(gtree, cfg, "cpu").named_parameters())
        _, state, m = adamw.apply_updates(tcfg, params, grads, state, ndims)
        _, own_state, _ = adamw.apply_updates(tcfg, own_params, grads,
                                              own_state)
        assert int(state.step) == int(jstate.step) == i + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
        tol = dict(rtol=1e-5, atol=1e-6)
        _assert_trees_close(to_numpy_tree(model, cfg),
                            jax.tree.map(np.asarray, jp), **tol)
        _assert_trees_close(to_numpy_tree(model, cfg, state.m),
                            jax.tree.map(np.asarray, jstate.m), **tol)
        _assert_trees_close(to_numpy_tree(model, cfg, state.v),
                            jax.tree.map(np.asarray, jstate.v), **tol)
    ln = np.asarray(jp["u0"]["l0"]["ln1"]["w"])
    apart = np.abs(to_numpy_tree(own, cfg)["u0"]["l0"]["ln1"]["w"] - ln)
    assert apart.max() > 1e-4
    np.testing.assert_allclose(to_numpy_tree(own, cfg)["final_ln"]["w"],
                               np.asarray(jp["final_ln"]["w"]), rtol=1e-5)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear_warmup"])
def test_schedules_match_reference(schedule):
    kw = dict(lr=3e-3, schedule=schedule, warmup_steps=4, total_steps=20,
              min_lr_frac=0.2)
    for s in (0, 1, 3, 4, 5, 11, 19, 20, 27):
        got = adamw.schedule_lr(adamw.AdamWConfig(**kw),
                                torch.tensor(s, dtype=torch.int32))
        want = jadamw.schedule_lr(jadamw.AdamWConfig(**kw),
                                  jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=f"{schedule} step {s}")


def test_token_stream_matches_reference_byte_for_byte(tmp_path):
    """Synthetic and file-backed batches equal the reference's, and a
    stream restored from another's state goes on with the same batches."""
    path = tmp_path / "tokens.bin"
    np.random.default_rng(1).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    for kw in (dict(source="synthetic"), dict(source="synthetic", seed=3,
                                              pack=False),
               dict(source="file", path=str(path))):
        cfg = dict(vocab_size=512, seq_len=16, global_batch=4, **kw)
        ours, theirs = (iter(TokenStream(DataConfig(**cfg))),
                        JTokenStream(JDataConfig(**cfg)))
        theirs_it = iter(theirs)
        stream = TokenStream(DataConfig(**cfg))
        it = iter(stream)
        for _ in range(3):
            a, b, c = next(it), next(theirs_it), next(ours)
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
                np.testing.assert_array_equal(c[key], b[key])
        resumed = TokenStream(DataConfig(**cfg))
        resumed.restore(stream.state())
        assert stream.state() == theirs.state()
        np.testing.assert_array_equal(next(iter(resumed))["tokens"],
                                      next(theirs_it)["tokens"])


# ---------------------------------------------------------------------------
# checkpoints and the trainer: tests/test_substrate.py, on the port's tensors
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 4, generator=g),
            "b": {"c": torch.arange(5), "d": torch.tensor(3.5)},
            "h": torch.randn(3, 5, generator=g).bfloat16(),
            "s": adamw.AdamWState(torch.tensor(7, dtype=torch.int32),
                                  {"w": torch.randn(2, generator=g)},
                                  {"w": torch.rand(2, generator=g)})}


def test_checkpoint_roundtrip_is_bit_exact(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 10, t, extra={"step": 10, "data": {"step": 4}})
    like = _tree(1)
    restored, extra = ckpt.restore(str(tmp_path), like)
    assert isinstance(restored["s"], adamw.AdamWState)
    for (ka, a), (kb, b) in zip(ckpt._flatten(t).items(),
                                ckpt._flatten(restored).items()):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka
    assert extra == {"step": 10, "data": {"step": 4}}
    assert sorted(os.listdir(tmp_path / "step_00000010")) == \
        ["manifest.json", "shard_0.pt"]


def test_checkpoint_latest_and_prune(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.latest_step(str(tmp_path)) == 4
    ckpt.prune_old(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.restore(str(tmp_path), t, step=3)[0] is not None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), t, step=1)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), t)


def test_checkpoint_ignores_incomplete_tmp(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_00000009.tmp")   # simulated crashed writer
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["a"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="leaf a"):
        ckpt.restore(str(tmp_path), bad)
    missing = _tree()
    missing["z"] = torch.zeros(1)
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), missing)


def _make_trainer(tmp_path, total=12, failure_at=None):
    ocfg = adamw.AdamWConfig(lr=0.05, schedule="constant", warmup_steps=0,
                             grad_clip=None, weight_decay=0.0)
    params = {"w": torch.tensor([4.0])}
    state = adamw.init_state(ocfg, params)

    def step(params, opt_state, batch):
        loss = torch.sum((params["w"] - batch["target"]) ** 2)
        g = {"w": 2 * (params["w"] - batch["target"])}
        p, s, m = adamw.apply_updates(ocfg, params, g, opt_state)
        return p, s, dict(m, loss=loss)

    class Stream:
        """Resume-safe data source (same protocol as data.TokenStream)."""

        def __init__(self):
            self.i = 0

        def __iter__(self):
            while True:
                i = self.i
                self.i += 1       # before yield: state() == batches consumed
                yield {"target": torch.tensor([float(i % 3)])}

        def state(self):
            return {"step": self.i}

        def restore(self, s):
            self.i = int(s.get("step", 0))

    stream = Stream()
    tcfg = TrainerConfig(total_steps=total, ckpt_dir=str(tmp_path),
                         ckpt_every=4, log_every=100, failure_at=failure_at)
    return Trainer(tcfg, step, params, state, iter(stream),
                   data_state_fn=stream.state, data_restore_fn=stream.restore)


def test_trainer_failure_injection_and_resume(tmp_path):
    t1 = _make_trainer(tmp_path, total=12, failure_at=10)
    with pytest.raises(InjectedFailure):
        t1.run()
    # A fresh trainer (fresh process equivalent) resumes from step 8 ckpt.
    t2 = _make_trainer(tmp_path, total=12, failure_at=None)
    out = t2.run()
    assert out["step"] == 12 and len(t2.step_times) == 4
    assert int(t2.opt_state.step) == 12
    # Uninterrupted reference run must match bitwise.
    ref = _make_trainer(tmp_path / "ref", total=12)
    ref.run()
    assert torch.equal(t2.params["w"], ref.params["w"])
    for a, b in zip((t2.opt_state.m["w"], t2.opt_state.v["w"]),
                    (ref.opt_state.m["w"], ref.opt_state.v["w"])):
        assert torch.equal(a, b)


def test_trainer_straggler_watchdog(tmp_path):
    t = _make_trainer(tmp_path, total=6)
    orig_fn = t.step_fn

    def slow_step(p, s, b):
        if int(s.step) == 3:
            time.sleep(0.25)
        return orig_fn(p, s, b)

    t.step_fn = slow_step
    out = t.run()
    assert len(out["stragglers"]) == 1 and out["stragglers"][0][0] == 3


def test_trainer_without_checkpoints_writes_none(tmp_path):
    t = _make_trainer(tmp_path / "none", total=5)
    t.tcfg.ckpt_every = 0
    assert t.run()["step"] == 5
    assert not (tmp_path / "none").exists()


def test_ef_compress_matches_reference():
    rng = np.random.default_rng(2)
    grads = {"a": rng.standard_normal((16, 8)).astype(np.float32),
             "b": rng.standard_normal(33).astype(np.float32) * 1e-3}
    ef = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-2
          for k, v in grads.items()}
    jg, je = jcompression.ef_compress(grads, ef)
    tg, te = compression.ef_compress(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in ef.items()},
        {k: k for k in grads})
    for k in grads:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]),
                                   rtol=1e-5, atol=1e-9)
    zeros = compression.init_ef_state({"a": torch.ones(2, 3).bfloat16()})
    assert zeros["a"].dtype == torch.float32 and not zeros["a"].any()
    with pytest.raises(NotImplementedError, match="compressed_psum_mean"):
        compression.compressed_psum_mean(torch.ones(2), "data")


# ---------------------------------------------------------------------------
# make_train_step: micro-batching and gradient compression
# ---------------------------------------------------------------------------

STEP_ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _steps_pair(ref_weights, **fields):
    """The reference's jitted make_train_step and the port's, from the
    reference's weights, with the same StepConfig fields and AdamW."""
    jcfg, jparams, tree, cfg = ref_weights
    opts = dict(attn_impl="chunked", attn_chunk=8)
    jscfg = jsteps.StepConfig(opts=jlm.ForwardOpts(**opts),
                              adamw=jadamw.AdamWConfig(**STEP_ADAMW),
                              **fields)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jscfg, make_local_mesh()))
    scfg = steps.StepConfig(opts=lm.ForwardOpts(**opts),
                            adamw=adamw.AdamWConfig(**STEP_ADAMW), **fields)
    model = from_numpy_tree(tree, cfg, "cpu", trainable=True)
    params = dict(model.named_parameters())
    return ((jstep, jparams, jsteps.init_opt_state(jcfg, jscfg, jparams)),
            (steps.make_train_step(cfg, scfg, model), model, params,
             steps.init_opt_state(cfg, scfg, params)))


@pytest.mark.parametrize("accum_dtype", ["float32", "bfloat16"])
def test_micro_batched_train_step_matches_reference(ref_weights,
                                                    accum_dtype):
    """micro_batches 2 (B 4 cut into two of 2, gradients summed in
    ``accum_dtype`` and halved, metrics averaged): three steps of the
    port's make_train_step against the reference's on the same weights and
    batches, the loss, the metrics and every parameter after each step."""
    cfg = ref_weights[3]
    (jstep, jp, jstate), (step, model, params, state) = _steps_pair(
        ref_weights, micro_batches=2, accum_dtype=accum_dtype)
    for i in range(3):
        batch = _batch(cfg, B=4, S=16, seed=20 + i, masked=i == 1)
        jp, jstate, jm = jstep(jp, jstate, batch)
        params, state, m = step(params, state, batch)
        for k in ("loss", "ce", "acc", "tokens", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"step {i} {k}", **F32_TOL)
        _assert_trees_close(to_numpy_tree(model, cfg),
                            jax.tree.map(np.asarray, jp), **F32_TOL)


def test_compressed_train_step_matches_reference_on_fed_gradients(
        ref_weights, monkeypatch):
    """grad_compression (int8 error feedback) with micro_batches 2, both
    steps fed the same gradients: ``lm.loss_fn`` replaced on both sides by
    a linear loss whose gradient is a fixed numpy tree, so the steps differ
    only in what follows the gradients (accumulation, ef_compress, AdamW).
    The parameters and the error-feedback state agree over three steps.
    The int8 scale spans a leaf of the reference's stacked tree (both of
    phi4-mini-smoke's layers): scaled per layer, the two steps' updates
    part by lr where an element rounds to 0 on one side only. Real
    gradients are not fed: the frameworks' last-bit differences can flip
    an int8 rounding on their own (the masked batch of the micro-batched
    test flips one in ``embed.tok``)."""
    _, _, tree, cfg = ref_weights
    gtree = _grad_tree(tree, 30, scale=0.5)
    jg = jax.tree.map(jnp.asarray, gtree)
    tg = dict(from_numpy_tree(gtree, cfg, "cpu").named_parameters())

    def jax_loss(params, jcfg, batch, opts):
        terms = jax.tree.map(lambda p, g: jnp.sum(p * g), params, jg)
        return sum(jax.tree.leaves(terms)), {}

    def port_loss(model, cfg_, batch, opts):
        return sum((p * tg[k].detach()).sum()
                   for k, p in model.named_parameters()), {}

    monkeypatch.setattr(jlm, "loss_fn", jax_loss)
    monkeypatch.setattr(lm, "loss_fn", port_loss)
    (jstep, jp, jstate), (step, model, params, state) = _steps_pair(
        ref_weights, micro_batches=2, grad_compression=True)
    for i in range(3):
        batch = _batch(cfg, B=4, S=16, seed=40 + i)
        jp, jstate, jm = jstep(jp, jstate, batch)
        params, state, m = step(params, state, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"step {i} {k}", **F32_TOL)
        _assert_trees_close(to_numpy_tree(model, cfg),
                            jax.tree.map(np.asarray, jp), **F32_TOL)
        _assert_trees_close(to_numpy_tree(model, cfg, state["ef"]),
                            jax.tree.map(np.asarray, jstate["ef"]),
                            **F32_TOL)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _reference_losses(tmp_path, jparams, jcfg, steps_n, batch, seq):
    scfg = jsteps.StepConfig(
        opts=jlm.ForwardOpts(attn_impl="chunked", attn_chunk=128),
        adamw=jadamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                                 total_steps=steps_n))
    step = jax.jit(jsteps.make_train_step(jcfg, scfg, make_local_mesh()))
    stream = JTokenStream(JDataConfig(vocab_size=jcfg.vocab_size,
                                      seq_len=seq, global_batch=batch))
    trainer = JTrainer(
        JTrainerConfig(total_steps=steps_n, ckpt_dir=str(tmp_path),
                       ckpt_every=steps_n, log_every=1),
        step, jparams, jsteps.init_opt_state(jcfg, scfg, jparams),
        iter(stream), data_state_fn=stream.state,
        data_restore_fn=stream.restore)
    trainer.run()
    return [m["loss"] for m in trainer.metrics_history]


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_launcher_losses_match_the_reference_trainer(ref_weights, tmp_path,
                                                     impl):
    """``launch.train`` on the CPU at the smoke widths, 3 steps from the
    reference's weights: finite losses equal to the reference's Trainer
    (its launcher's step: chunked attention, AdamW with warmup 10) on the
    same data stream, each kernel's launches 0 on the CPU."""
    jcfg, jparams, tree, cfg = ref_weights
    want = _reference_losses(tmp_path / "ref", jparams, jcfg, 3, 4, 32)
    args = train.build_parser().parse_args(
        ["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32",
         "--attn-impl", impl, "--ckpt-dir", str(tmp_path / impl)])
    report = train.train(args, model=from_numpy_tree(tree, cfg, "cpu",
                                                     trainable=True))
    assert report["steps"] == 3 and len(report["step_ms"]) == 3
    assert all(np.isfinite(report["losses"]))
    np.testing.assert_allclose(report["losses"], want, **F32_TOL)
    assert report["launches"] == {"flash_attention": 0,
                                  "flash_attention_bwd": 0}
    assert ckpt.latest_step(str(tmp_path / impl)) == 3


def test_launcher_resumes_from_its_checkpoint(tmp_path):
    """A second run of the launcher over the same --ckpt-dir resumes at the
    latest step; --micro-batches, --remat full and --grad-compression run."""
    argv = ["--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
            "16", "--ckpt-dir", str(tmp_path), "--micro-batches", "2",
            "--remat", "full", "--grad-compression"]
    first = train.main(argv)
    assert first["steps"] == 2 and len(first["losses"]) == 2
    again = train.main(argv[:3] + ["3"] + argv[4:])
    assert again["steps"] == 3 and len(again["losses"]) == 1


def test_train_refuses_by_name():
    parse = train.build_parser().parse_args
    base = ["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "8"]
    with pytest.raises(NotImplementedError, match="MoE"):
        train.train(parse(base + ["--arch", "olmoe-1b-7b"]))
    with pytest.raises(NotImplementedError, match="MoE"):
        train.train(parse(base + ["--arch", "deepseek-v2-lite-16b"]))
    with pytest.raises(NotImplementedError, match="dots"):
        train.train(parse(base + ["--remat", "dots"]))
    dsv2 = get_config("deepseek-v2-lite-16b", smoke=True)
    model = init_params(dsv2, None, "cpu")
    with pytest.raises(NotImplementedError, match="MLA"):
        ATT.attn_forward(model.layers[0].mix,
                         torch.zeros(1, 4, dsv2.d_model), dsv2)
    windowed = dataclasses.replace(get_config(ARCH, smoke=True), window=4)
    with pytest.raises(NotImplementedError, match="SWA"):
        lm._check_train(windowed, lm.ForwardOpts())
    with pytest.raises(ValueError, match="plain norm"):
        lm._check_train(get_config(ARCH, smoke=True),
                        lm.ForwardOpts(norm_impl="kernel"))
    cfg = get_config(ARCH, smoke=True)
    model = init_params(cfg, None, "cpu", trainable=True)
    for field in ("policy", "opt_policy", "kv_layout"):
        with pytest.raises(NotImplementedError, match=field):
            steps.make_train_step(cfg, steps.StepConfig(**{field: "x"}),
                                  model)


def test_train_defaults_to_the_card_and_raises_without_one(monkeypatch):
    args = train.build_parser().parse_args([])
    assert args.device == "cuda" and args.attn_impl == "chunked"
    assert (args.steps, args.batch, args.seq, args.lr) == (50, 8, 128, 1e-3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])
