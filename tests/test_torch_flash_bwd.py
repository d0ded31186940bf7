"""The port's flash attention backward held against the JAX package's.

The plain backward (``ref.flash_attention_bwd``, what the CUDA wrapper runs
on the CPU) against ``jax.grad`` of the reference's oracle
(``repro.kernels.ref.attention``) at the reference's four ``BWD_CASES``;
``ops.attention_bwd`` against the reference's Pallas
``flash_attention_bwd`` in interpret mode (one case, GQA causal with a
window); rows that see no key; the autograd function ``_FlashAttention``
against the reference's ``run_attention(impl="pallas")`` gradients (its
custom_vjp around the Pallas pair, interpret mode) and against torch
autograd through the plain ``full_attention``; the config space, the
bound's formulas and the registry's operands. Tolerance: the reference's
f32 1e-4 and rtol 1e-4 (``tests/test_kernel_oracles.py`` ``_tol``). The
CUDA kernels themselves are held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention_bwd import \
    flash_attention_bwd as jax_flash_bwd
from repro.models import attention as JATT

from repro_torch.core import cpu_host
from repro_torch.kernels import flash_attention_bwd as fab_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import registry
from repro_torch.models import attention as ATT

F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hq, Sq, D)).astype(np.float32))


# the reference's BWD_CASES (tests/test_kernels.py): B, Hq, Hkv, Sq, Skv, D,
# causal, window
BWD_CASES = [
    (1, 4, 2, 128, 128, 64, True, None),
    (2, 2, 2, 200, 200, 64, True, None),
    (1, 6, 2, 128, 128, 64, True, 48),
    (1, 2, 1, 64, 256, 64, False, None),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_bwd_matches_reference_autodiff(case):
    """dq, dk, dv of the plain backward, fed the plain forward's o and lse,
    equal jax.grad of the reference's oracle attention."""
    B, Hq, Hkv, Sq, Skv, D, causal, window = case
    q, k, v, do = _operands(Sq + Skv, B, Hq, Hkv, Sq, Skv, D)
    o, lse = ref.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                 window=window, return_lse=True)
    got = ops.attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(do),
                            causal=causal, window=window)
    want = jax.grad(
        lambda q_, k_, v_: jnp.sum(jref.attention(
            q_, k_, v_, causal=causal, window=window) * do),
        argnums=(0, 1, 2))(q, k, v)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, _t(w), **F32_TOL)


def test_attention_bwd_matches_pallas_interpret():
    """``ops.attention_bwd`` on the CPU (the plain version) against the
    reference's Pallas dkv and dq kernels in interpret mode on the same q,
    k, v, do and the Pallas forward's o and lse: GQA causal with a window,
    Sq not a tile multiple."""
    B, Hq, Hkv, S, D, window = 1, 4, 2, 96, 32, 40
    q, k, v, do = _operands(7, B, Hq, Hkv, S, S, D)
    o, lse = jax_flash(q, k, v, causal=True, window=window, block_q=64,
                       block_kv=128, return_lse=True)
    want = jax_flash_bwd(q, k, v, o, lse, do, causal=True, window=window,
                         block_q=64, block_kv=128)
    got = ops.attention_bwd(_t(q), _t(k), _t(v), _t(o), _t(lse), _t(do),
                            causal=True, window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, _t(w), **F32_TOL)


def test_rows_that_see_no_key_give_zero_gradients():
    """A window with a query offset past Skv leaves query rows with no
    visible key: the forward gives them o = 0 and lse -1e30, the backward
    dq = 0, and they add nothing to dk and dv (the gradients equal torch
    autograd through the plain forward)."""
    B, Hq, Hkv, Sq, Skv, D = 1, 4, 2, 24, 10, 16
    q, k, v, do = (_t(a) for a in _operands(3, B, Hq, Hkv, Sq, Skv, D))
    kw = dict(causal=True, window=4, q_offset=8)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = ref.flash_attention(*leaves, return_lse=True, **kw)
    empty = lse[0, 0] <= -1e30
    assert empty.sum() == 19
    (o * do).sum().backward()
    dq, dk, dv = fab_kernel.flash_attention_bwd(q, k, v, o.detach(),
                                                lse.detach(), do, **kw)
    assert torch.isfinite(dq).all() and not dq[:, :, empty].any()
    for g, leaf in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(g, leaf.grad, **F32_TOL)


def test_flash_function_matches_reference_and_autograd():
    """``run_attention(impl="pallas")`` (the autograd function) on the
    CPU: its output and the gradients of q, k and v equal the reference's
    ``run_attention(impl="pallas")`` (Pallas forward and backward in
    interpret mode) and torch autograd through ``full_attention``, in the
    callers' (B, S, H, D) layout."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    do = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(JATT.run_attention(q_, k_, v_, impl="pallas",
                                          causal=True) * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = ATT.run_attention(*leaves, impl="pallas")
    out.backward(_t(do))
    plain = [_t(a).requires_grad_() for a in (q, k, v)]
    ATT.full_attention(*plain).backward(_t(do))
    torch.testing.assert_close(out.detach(), ATT.full_attention(
        *(p.detach() for p in plain)), **F32_TOL)
    for leaf, w, p in zip(leaves, want, plain):
        assert leaf.grad.shape == leaf.shape
        torch.testing.assert_close(leaf.grad, _t(w), **F32_TOL)
        torch.testing.assert_close(leaf.grad, p.grad, **F32_TOL)
    with torch.no_grad():           # serving: the forward alone
        assert not ATT.run_attention(*leaves, impl="pallas").requires_grad


def test_space_bounds_and_heuristic():
    """The space's valid configs are the ones the kernels instantiate
    (the register fit of both kernels, shared memory within the card's
    limit, tiles within the sequences, two stages in f32), none at D past
    128; the heuristic is valid; the bound's formulas at ``train4k``."""
    chip = cpu_host()
    assert ops.FLASH_ATTENTION_BWD.space.version == 2
    for D, dt in ((128, "bfloat16"), (96, "bfloat16"), (64, "float32"),
                  (120, "float32")):
        ctx = ops.attention_context(chip, 4, 24, 8, 512, 512, D, dt)
        configs = ops.FLASH_ATTENTION_BWD.space.valid_configs(ctx)
        assert configs
        item = 2 if dt == "bfloat16" else 4
        for cfg in configs:
            assert fab_kernel.regs_fit(D, cfg["block_q"], cfg["block_kv"],
                                       cfg["num_warps"], item)
            assert fab_kernel.smem_bytes(
                D, item, cfg["block_q"], cfg["block_kv"],
                cfg["num_stages"]) <= chip.smem_per_block
            assert item == 2 or cfg["num_stages"] == 2
        heur = ops.FLASH_ATTENTION_BWD.default_config(ctx)
        assert heur in configs
    ctx = ops.attention_context(chip, 4, 24, 8, 512, 512, 128, "bfloat16")
    assert ops.FLASH_ATTENTION_BWD.default_config(ctx) == {
        "block_q": 64, "block_kv": 64, "num_warps": 4, "num_stages": 2}
    big = ops.attention_context(chip, 1, 2, 1, 64, 64, 160, "bfloat16")
    assert not ops.FLASH_ATTENTION_BWD.space.valid_configs(big)
    short = ops.attention_context(chip, 1, 2, 1, 20, 20, 64, "float32")
    assert all(c["block_q"] <= 32 and c["block_kv"] <= 32 for c in
               ops.FLASH_ATTENTION_BWD.space.valid_configs(short))
    short16 = ops.attention_context(chip, 1, 2, 1, 20, 20, 64, "bfloat16")
    assert {(c["block_q"], c["block_kv"]) for c in
            ops.FLASH_ATTENTION_BWD.space.valid_configs(short16)} == \
        {(64, 64)}
    pairs = ops.attention_pairs(4096, 4096, True)
    assert pairs == 8390656
    assert ops.flash_attention_bwd_flops(8, 32, 128, pairs) == \
        10 * 8 * 32 * 128 * 8390656
    assert ops.flash_attention_bwd_bytes(4, 24, 8, 512, 512, 128, 2) == \
        (3 * 4 * 24 + 4 * 4 * 8) * 512 * 128 * 2 + 8 * 4 * 24 * 512
    w = ops.FLASH_ATTENTION_BWD.workload_fn(
        {}, ops.attention_context(chip, 8, 32, 8, 4096, 4096, 128,
                                  "bfloat16", True, None))
    assert w.flops == 10 * 8 * 32 * 128 * 8390656


def test_registry_operands_feed_entry_point_and_reference():
    """The registry's operands at a small context on the CPU: q, k, v and
    do as (B, H, S, D) views of (B, S, H, D) tensors, o and lse from the
    forward, through the entry point and the plain version alike."""
    spec = registry.get_kernel("flash_attention_bwd")
    assert spec.reference is ref.flash_attention_bwd
    ctx = ops.attention_context(cpu_host(), 2, 4, 2, 33, 33, 16, "float32",
                                True, 8)
    cfg = spec.tunable.default_config(ctx)
    args, kw = spec.operands(ctx, cfg, "cpu")
    q, k, v, o, lse, do = args
    assert kw == {"causal": True, "window": 8}
    assert all(t.transpose(1, 2).is_contiguous() for t in (q, k, v, do))
    assert lse.shape == (2, 4, 33) and o.shape == q.shape
    got = spec.entry_point(*args, **kw, config=cfg)
    want = spec.reference(*args, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_wrapper_refuses_a_window_below_one():
    q, k, v, do = (_t(a) for a in _operands(0, 1, 2, 1, 8, 8, 16))
    o, lse = ref.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="window 0"):
        fab_kernel.flash_attention_bwd(q, k, v, o, lse, do, window=0)
