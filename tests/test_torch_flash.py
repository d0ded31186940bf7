"""The port's flash attention held against the JAX package's.

The plain ``attention`` against the reference's oracle
(``repro.kernels.ref.attention``); the kernel's plain version (what the
CUDA wrapper runs on the CPU, ``ref.flash_attention``) and ``ops.attention``
against the Pallas ``flash_attention`` in interpret mode (two cases, about
3 s each); the edges the kernel defines (rows with no visible key); the
prefill's ``run_attention(impl="pallas")`` against the reference's; and the
launcher's ``--attn-impl pallas`` tokens against the reference's
``serve_dense`` steps. Tolerance: the reference's f32 1e-4
(``tests/test_kernel_oracles.py`` ``_tol``); kv8 runs compare tokens. The
CUDA kernel itself is held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as JATT
from repro.models import lm as jlm
from repro.models.param import init_params as jax_init_params

from repro_torch.configs import get_config
from repro_torch.core import Autotuner
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import attention as ATT
from repro_torch.models.param import from_numpy_tree

ARCH = "phi4-mini-3.8b"
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


# (causal, window, q_offset, kv_len) of the oracle cases; Sq 24, Skv 40
ORACLE_CASES = [
    (True, None, 0, None),
    (True, 7, 0, None),
    (True, 5, 16, None),
    (False, None, 3, None),
    (False, 9, 11, None),
    (True, None, 16, (40, 23)),
]


@pytest.mark.parametrize("causal,window,q_offset,kv_len", ORACLE_CASES)
def test_plain_attention_matches_the_reference_oracle(causal, window,
                                                      q_offset, kv_len):
    """``ref.attention`` against ``repro.kernels.ref.attention`` on the same
    operands (group 3): o and lse at f32 1e-4, with and without
    ``return_lse``."""
    q, k, v = _qkv(len(ORACLE_CASES) + q_offset, 2, 6, 2, 24, 40, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    lens = None if kv_len is None else np.asarray(kv_len, np.int32)
    o, lse = ref.attention(_t(q), _t(k), _t(v), return_lse=True,
                           kv_len=None if lens is None else _t(lens), **kw)
    jo, jlse = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              return_lse=True,
                              kv_len=None if lens is None
                              else jnp.asarray(lens), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **F32_TOL)
    bare = ref.attention(_t(q), _t(k), _t(v),
                         kv_len=None if lens is None else _t(lens), **kw)
    torch.testing.assert_close(bare, o, rtol=0, atol=0)


# Two interpret-mode cases: (B, Hq, Hkv, Sq, Skv, D, causal, window,
# q_offset, block_q, block_kv). The first has rows 32-39 past the window's
# reach of the 24 keys, a whole q block of 8 whose key tiles the Pallas
# kernel skips, so it gives them zeros and lse -1e30 as the port does.
PALLAS_CASES = [(2, 4, 2, 40, 24, 16, True, 9, 0, 8, 8),
                (1, 3, 1, 20, 33, 24, True, None, 5, 8, 128)]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_flash_attention_matches_pallas(case):
    """``ops.attention`` on CPU tensors (the kernel's plain version, no
    tuning, no launch) against the TPU kernel in interpret mode: ragged
    Sq and Skv, a window, GQA, a query offset, lse, rows with no visible
    key."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, bq, bkv = case
    q, k, v = _qkv(Sq + Skv, B, Hq, Hkv, Sq, Skv, D)
    before = fa_kernel.flash_attention.launches
    o, lse = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                           q_offset=q_offset, return_lse=True,
                           tuner=Autotuner(on_miss="error"))
    assert fa_kernel.flash_attention.launches == before
    jo, jlse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, q_offset=q_offset,
                         block_q=bq, block_kv=bkv, interpret=True,
                         return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **F32_TOL)
    if window is not None:
        assert not o[:, :, 32:].any() and (lse[:, :, 32:] == -1e30).all()


def test_plain_flash_attention_defines_rows_with_no_visible_key():
    """``ref.flash_attention`` is ``ref.attention`` where a row sees a key,
    and zeros with lse -1e30 where it sees none (the oracle averages V
    there); in q's dtype, with or without lse."""
    q, k, v = (_t(a) for a in _qkv(5, 1, 4, 2, 16, 12, 8))
    kw = dict(causal=True, window=4, q_offset=10)     # rows 5+ see no key
    o, lse = ref.flash_attention(q, k, v, return_lse=True, **kw)
    want, want_lse = ref.attention(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(o[:, :, :5], want[:, :, :5], rtol=0, atol=0)
    torch.testing.assert_close(lse[:, :, :5], want_lse[:, :, :5], rtol=0,
                               atol=0)
    assert not o[:, :, 5:].any() and want[:, :, 5:].abs().sum() > 0
    assert (lse[:, :, 5:] == -1e30).all()
    assert torch.isfinite(o).all()
    half = ref.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                               **kw)
    assert half.dtype == torch.bfloat16 and not half[:, :, 5:].any()
    with pytest.raises(ValueError, match="window"):
        fa_kernel.flash_attention(q, k, v, window=0)


def test_run_attention_pallas_matches_jax_and_refuses_triangular():
    """The prefill's ``run_attention(impl="pallas")`` (q, k, v (B, S, H, D)
    handed over as views) against the reference's on the same operands,
    in (B, S, Hq, D); ``triangular`` stays refused by name."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 13, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
    o = ATT.run_attention(_t(q), _t(k), _t(v), impl="pallas")
    jo = JATT.run_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            impl="pallas")
    assert o.shape == (2, 13, 4, 16)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32_TOL)
    torch.testing.assert_close(
        o, ATT.run_attention(_t(q), _t(k), _t(v), impl="full"),
        **F32_TOL)
    with pytest.raises(NotImplementedError, match="triangular"):
        ATT.run_attention(_t(q), _t(k), _t(v), impl="triangular")
    with pytest.raises(ValueError, match="attention impl"):
        ATT.run_attention(_t(q), _t(k), _t(v), impl="flash")


@pytest.fixture(scope="module")
def both():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = jax_init_params(jax.random.PRNGKey(0), jlm.lm_specs(jcfg))
    cfg = get_config(ARCH, smoke=True)
    model = from_numpy_tree(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


@pytest.mark.parametrize("quant", ["none", "kv8"])
def test_serve_dense_attn_pallas_matches_jax(both, monkeypatch, quant):
    """The launcher's ``--attn-impl pallas`` run on the CPU (the kernel's
    plain version; bf16-free smoke weights) gives the reference's tokens:
    its ``serve_dense`` steps with ``ForwardOpts(attn_impl="pallas")`` on
    the prompts the launcher draws from the same seed; also under
    ``--quant kv8``."""
    jcfg, jparams, cfg, model = both
    monkeypatch.setattr(serve, "init_params",
                        lambda cfg_, gen, device: model)
    B, P, G = 3, 13, 5
    report = serve.main(["--decode-impl", "pallas", "--attn-impl", "pallas",
                         "--device", "cpu", "--quant", quant, "--requests",
                         str(B), "--prompt-len", str(P), "--gen", str(G)])
    assert report["attn_impl"] == "pallas" and report["quant"] == quant
    prompts = np.random.default_rng(0).integers(1, jcfg.vocab_size, (B, P))
    jopts = jlm.ForwardOpts(attn_impl="pallas", attn_chunk=64,
                            decode_impl="full",
                            quant=None if quant == "none" else quant)
    logits, cache = jlm.prefill(jparams, jcfg, jnp.asarray(prompts, jnp.int32),
                                max_len=P + G, opts=jopts)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    outs = [tok]
    for i in range(G - 1):
        logits, cache = jlm.decode_step(jparams, jcfg, tok, cache,
                                        jnp.int32(P + i), jopts)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        outs.append(tok)
    assert report["tokens"] == np.concatenate(outs, 1).tolist()
