"""The port's kernels held against the JAX package's.

On the CPU each wrapper runs its plain version (``repro_torch.kernels.ref``);
those are compared here with the Pallas kernels in interpret mode and the
jnp oracles on the same numpy operands, at the reference's f32 tolerance.
The kernels themselves are held against the plain versions on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.paged_decode import paged_decode as jax_paged_decode
from repro.kernels.paged_verify import paged_verify as jax_paged_verify
from repro.kernels.rms_norm import rms_norm as jax_rms_norm

from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_decode as pd_kernel
from repro_torch.kernels import paged_verify as pv_kernel
from repro_torch.kernels import rms_norm as rms_kernel

F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _paged_operands(seed, B, Hq, Hkv, D, page_size, max_pages, kv_len):
    """Pool with page 0 as scratch, each sequence on shuffled pages,
    trailing table entries on the scratch page."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_pages
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((Hkv, n_pages, page_size, D)).astype(np.float32)
    vp = rng.standard_normal((Hkv, n_pages, page_size, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = perm.reshape(B, max_pages).copy()
    for b, n in enumerate(kv_len):
        used = -(-min(max(n, 0), max_pages * page_size) // page_size)
        tables[b, used:] = 0
    return q, kp, vp, tables, np.asarray(kv_len, np.int32)


# group, page_size, pages per block_kv
PAGED_CASES = [(g, ps, ppb) for g in (1, 2, 4) for ps in (8, 16)
               for ppb in (1, 2)]


@pytest.mark.parametrize("group,page_size,ppb", PAGED_CASES)
def test_paged_decode_matches_pallas_and_oracle(group, page_size, ppb):
    Hkv, D, max_pages = 2, 16, 4
    cap = max_pages * page_size
    # inactive slot, ragged, exactly full, past capacity
    kv_len = [0, 5, cap - page_size + 3, cap, cap + 7]
    q, kp, vp, tables, lens = _paged_operands(
        group * 100 + page_size + ppb, len(kv_len), Hkv * group, Hkv, D,
        page_size, max_pages, kv_len)
    ours = pd_kernel.paged_decode(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, lens)),
        block_kv=ppb * page_size).numpy()
    pallas = np.asarray(jax_paged_decode(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lens)),
        block_kv=ppb * page_size, pack_gqa=group > 1, interpret=True))
    oracle = np.asarray(jref.paged_decode(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lens))))
    np.testing.assert_allclose(ours, pallas, **F32_TOL)
    np.testing.assert_allclose(ours, oracle, **F32_TOL)
    assert not ours[0].any(), "kv_len == 0 must give exact zeros"


def test_paged_decode_unpacked_pallas_agrees():
    kv_len = [3, 0, 40]
    q, kp, vp, tables, lens = _paged_operands(5, 3, 8, 2, 16, 8, 5, kv_len)
    ours = pd_kernel.paged_decode(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, lens))).numpy()
    pallas = np.asarray(jax_paged_decode(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lens)),
        block_kv=8, pack_gqa=False, interpret=True))
    np.testing.assert_allclose(ours, pallas, **F32_TOL)


def test_paged_decode_cpu_runs_plain_version_and_counts_nothing():
    q, kp, vp, tables, lens = _paged_operands(1, 2, 4, 2, 16, 8, 3, [4, 9])
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    before = pd_kernel.paged_decode.launches
    out = ops.paged_decode(*args)
    assert pd_kernel.paged_decode.launches == before
    torch.testing.assert_close(out, ref.paged_decode(*args), rtol=0, atol=0)


# group, draft_k, page_size, pages per block_kv, pack_gqa (a group of one
# packs to the unpacked kernel, so it runs once)
VERIFY_CASES = [(g, k, ps, ppb, pack) for g in (1, 2, 4) for k in (2, 4)
                for ps in (8, 16) for ppb in (1, 2)
                for pack in ((False,) if g == 1 else (True, False))]


@pytest.mark.parametrize("group,draft_k,page_size,ppb,pack", VERIFY_CASES)
def test_paged_verify_matches_pallas_and_oracle(group, draft_k, page_size,
                                                ppb, pack):
    Hkv, D, max_pages = 2, 16, 4
    cap = max_pages * page_size
    # inactive slot, a tail shorter than K, ragged, mid-page, exactly full,
    # past capacity
    kv_len = [0, draft_k - 1, draft_k + 3, cap - page_size + 3, cap,
              cap + 7]
    q, kp, vp, tables, lens = _paged_operands(
        group * 1000 + draft_k * 100 + page_size + ppb, len(kv_len),
        Hkv * group, Hkv, D, page_size, max_pages, kv_len)
    B = len(kv_len)
    q = np.random.default_rng(draft_k).standard_normal(
        (B, draft_k, Hkv * group, D)).astype(np.float32)
    ours = pv_kernel.paged_verify(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, lens)),
        block_kv=ppb * page_size, pack_gqa=pack).numpy()
    pallas = np.asarray(jax_paged_verify(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lens)),
        block_kv=ppb * page_size, pack_gqa=pack, interpret=True))
    oracle = np.asarray(jref.paged_verify(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lens))))
    assert ours.shape == (B, draft_k, Hkv * group, D)
    np.testing.assert_allclose(ours, pallas, **F32_TOL)
    np.testing.assert_allclose(ours, oracle, **F32_TOL)
    assert not ours[0].any(), "kv_len == 0 must give exact zeros"
    # kv_len K-1: query 0 has an empty window, query t sees t keys
    assert not ours[1, 0].any() and ours[1, 1:].any()


def test_paged_verify_cpu_runs_plain_version_and_counts_nothing():
    q, kp, vp, tables, lens = _paged_operands(2, 2, 4, 2, 16, 8, 3, [4, 9])
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    args[0] = torch.randn(2, 3, 4, 16, generator=torch.Generator()
                          .manual_seed(0))
    before = pv_kernel.paged_verify.launches
    out = ops.paged_verify(*args)
    assert pv_kernel.paged_verify.launches == before
    torch.testing.assert_close(out, ref.paged_verify(*args), rtol=0, atol=0)


def test_paged_verify_position_zero_of_k1_is_decode():
    """One draft position is exactly paged_decode's computation."""
    kv_len = [0, 5, 17, 40]
    q, kp, vp, tables, lens = _paged_operands(9, 4, 8, 2, 16, 8, 5, kv_len)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    verify = ref.paged_verify(args[0][:, None], *args[1:])[:, 0]
    torch.testing.assert_close(verify, ref.paged_decode(*args), **F32_TOL)


@pytest.mark.parametrize("n,d,block_rows", [(5, 64, 8), (16, 3072, 8),
                                            (3, 96, 16)])
def test_rms_norm_matches_pallas(n, d, block_rows):
    rng = np.random.default_rng(n + d)
    x = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    ours = rms_kernel.rms_norm(torch.from_numpy(x),
                               torch.from_numpy(w)).numpy()
    pallas = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w),
                                     block_rows=block_rows, interpret=True))
    np.testing.assert_allclose(ours, pallas, **F32_TOL)
    np.testing.assert_allclose(
        ours, np.asarray(jref.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        **F32_TOL)


def test_rms_norm_bf16_matches_oracle():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 3, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    ours = rms_kernel.rms_norm(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(w).bfloat16())
    want = np.asarray(jref.rms_norm(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(w, jnp.bfloat16)),
                      np.float32)
    assert ours.dtype == torch.bfloat16 and ours.shape == (4, 3, 128)
    np.testing.assert_allclose(ours.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)
