"""The port's quantization subset (``repro_torch.quant``) held against the
JAX package's ``repro.quant``: the kv8 wire format byte for byte, the
calibration helpers it is built from, and the named policies. All on the
CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import lm as jlm
from repro.quant import calibrate as jcal
from repro.quant import policy as jpol

from repro_torch import quant
from repro_torch.models import lm
from repro_torch.quant import calibrate, policy


def _kv_inputs(seed):
    """(B, T, Hkv, D) f32 K and V with an all-zero row (the scale floor),
    rows whose absmax is 127 so x / scale lands exactly on .5 steps
    (rounding half to even), and rows of large and tiny magnitude."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((3, 7, 2, 16)).astype(np.float32)
    v = (rng.standard_normal((3, 7, 2, 16)) * 4).astype(np.float32)
    k[0, 0, 0] = 0.0
    v[1, 2, 1] = 0.0
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                       -126.5, 64.5, -64.5, 0.0, 7.5, -7.5, 100.5],
                      np.float32)
    k[2, 3, 0] = halves
    v[0, 5, 1] = -halves
    k[1, 6, 1] *= 1e4
    v[2, 1, 0] *= 1e-6
    return k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_the_reference_byte_for_byte(dtype):
    k, v = _kv_inputs(0)
    jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (k, v))
    tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (k, v))
    # the same bf16 inputs on both sides (both round f32 to nearest even)
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk.astype(jnp.float32)))
    ours = quant.quantize_kv(tk, tv)
    theirs = jcal.quantize_kv(jk, jv)
    for name, a, b in zip(("k", "k_scale", "v", "v_scale"), ours, theirs):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        assert a.shape == b.shape, name
        assert a.numpy().tobytes() == b.tobytes(), name
    kq, ks = ours[0], ours[1]
    assert not kq[0, 0, 0].any()                           # zero row
    assert float(ks[0, 0, 0]) == np.float32(1e-8) / np.float32(127.0)
    assert ks[2, 3, 0] == 1.0                              # absmax 127
    assert kq[2, 3, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    assert int(kq.abs().max()) == 127


@pytest.mark.parametrize("axis", [None, 0, -1, (1, 2)])
def test_calibration_helpers_match_the_reference(axis):
    x = np.random.default_rng(1).standard_normal((4, 5, 6)).astype(
        np.float32)
    x[1] = 0.0
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    s, js = calibrate.absmax_scale(tx, axis), jcal.absmax_scale(jx, axis)
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    q, jq = calibrate.quantize(tx, s), jcal.quantize(jx, js)
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        d = calibrate.dequantize(q, s, dt).float().numpy()
        jd = np.asarray(jcal.dequantize(jq, js, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(d, jd)
    if axis is not None:
        (q2, s2), (jq2, js2) = (calibrate.quantize_dynamic(tx, axis),
                                jcal.quantize_dynamic(jx, axis))
        assert q2.numpy().tobytes() == np.asarray(jq2).tobytes()
        assert s2.numpy().tobytes() == np.asarray(js2).tobytes()
    assert calibrate.QMAX == jcal.QMAX
    assert calibrate._SCALE_FLOOR == jcal._SCALE_FLOOR


def test_policies_match_the_reference():
    assert sorted(policy.POLICIES) == sorted(jpol.POLICIES)
    for name, pol in policy.POLICIES.items():
        assert dataclasses.asdict(pol) == dataclasses.asdict(
            jpol.POLICIES[name])
        ref = jpol.POLICIES[name]
        for prop in ("quantizes_weights", "quantizes_acts", "quantizes_kv",
                     "kv_dtype"):
            assert getattr(pol, prop) == getattr(ref, prop), (name, prop)
        assert policy.get_policy(name) is pol
        assert policy.get_policy(pol) is pol
    assert policy.get_policy(None) is None and \
        policy.get_policy("none") is None
    with pytest.raises(KeyError) as ours:
        policy.get_policy("fp4")
    with pytest.raises(KeyError) as theirs:
        jpol.get_policy("fp4")
    assert str(ours.value) == str(theirs.value)
    assert quant.get_policy is policy.get_policy


@pytest.mark.parametrize("name", [None, "none", "kv8", "w8a8", "w8a16"])
def test_forward_opts_kv_dtype(name):
    assert lm.ForwardOpts(quant=name).kv_dtype() == \
        jlm.ForwardOpts(quant=name).kv_dtype()
    assert lm.ForwardOpts(quant="kv8").kv_dtype() == "int8"
    assert lm.ForwardOpts().kv_dtype() is None
