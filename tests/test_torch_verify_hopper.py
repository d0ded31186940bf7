"""The Hopper paged_verify's host-side rules and its split-KV algebra, on
the CPU.

The kernel (``csrc/paged_verify.cu``, version 2) carries paged_decode's
design over to K query positions: each (sequence, head) row is split over
a thread-block cluster of ``kv_splits`` blocks, each running the online
softmax of the row's K·g query rows (K unpacked) over an equal share of
its chunks of ``block_kv`` tokens, masking per query row only in the
chunk that reaches the causal tail, and rank 0 merges the blocks' partials
in rank order from distributed shared memory; the query rows and their
state live in registers, at most four to a row group. Here: the
version-2 space (valid configs against brute force at the serving, kv8
and deployment contexts, the new constraints, the heuristic's splits, the
fixed config), the shared-memory fit against the source's formula (read
out of the source and evaluated), the query sets, the path rule, and a
plain numpy model of the span cut, the causal tail and the merge held
against the reference's ``paged_verify`` oracle on the same numpy
operands, at the reference's tolerances (f32 1e-4, int8 2e-3, bf16 2e-2).
The kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref

from repro_torch.core.hardware import chip_from_properties
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pd_kernel
from repro_torch.kernels import paged_verify as pv_kernel
from repro_torch.quant import quantize_kv

from test_torch_flash_hopper import c_function

H100_SXM = chip_from_properties("NVIDIA H100 80GB HBM3", 132, 232448,
                                50 * 2**20, 80 * 2**30)
SOURCE = (pathlib.Path(pv_kernel.__file__).resolve().parents[1] / "csrc"
          / "paged_verify.cu").read_text()
SPACE = ops.PAGED_VERIFY.space


def _valid_by_brute_force(ctx):
    return [c for c in SPACE.iter_all() if SPACE.is_valid(c, ctx)]


def _chunks(c, ctx):
    cap = -(-ctx.shape("k")[2] // c["page_size"]) * c["page_size"]
    return -(-cap // c["block_kv"])


# (B, Hq, Hkv, D, capacity, pool dtype, page_size, draft_k, q dtype): the
# shipped deployments (page size and depth free), the serving layouts
# (pages of 128, 7 a table; the kv8 engine's), chip_smoke's pages of 16 at
# K 8 (24 query rows a block), a group of one in f32
CONTEXTS = [(16, 24, 8, 128, 32768, "bfloat16", None, None, None),
            (16, 24, 8, 128, 32768, "int8", None, None, "bfloat16"),
            (16, 32, 8, 160, 32768, "int8", None, None, "bfloat16"),
            (8, 24, 8, 128, 896, "bfloat16", 128, 2, None),
            (8, 24, 8, 128, 896, "int8", 128, 2, "bfloat16"),
            (8, 24, 8, 128, 576, "bfloat16", 16, 8, None),
            (4, 32, 32, 96, 64, "float32", 8, 2, None)]


@pytest.mark.parametrize("shape", CONTEXTS,
                         ids=lambda s: f"B{s[0]}-T{s[4]}-{s[5]}-K{s[7]}")
def test_version_2_space_against_brute_force(shape):
    ctx = ops.paged_verify_context(H100_SXM, *shape)
    valid = SPACE.valid_configs(ctx)
    assert valid == _valid_by_brute_force(ctx)
    assert valid and ops.PAGED_VERIFY.default_config(ctx) in valid
    for c in valid:
        assert c["kv_splits"] <= min(_chunks(c, ctx), pv_kernel.MAX_CLUSTER)
        assert c["block_kv"] % c["page_size"] == 0 or \
            c["page_size"] % c["block_kv"] == 0
        assert ops._verify_smem(c, ctx) <= H100_SXM.smem_per_block
    if shape[6] is None:        # deployment: every split and depth swept
        assert {c["kv_splits"] for c in valid} == set(pv_kernel.KV_SPLITS)
        assert {c["draft_k"] for c in valid} == set(pv_kernel.DRAFT_KS)
        # the DB's tune of a deployment entry stays one chip call
        assert len(valid) <= 1200
    assert "num_warps" not in {p.name for p in SPACE.params}
    assert SPACE.version == ops.PAGED_VERIFY.version == 2


def test_version_2_constraints_name_what_they_reject():
    serving = ops.paged_verify_context(H100_SXM, 8, 24, 8, 128, 896,
                                       "bfloat16", 128, 2)
    ok = {"draft_k": 2, "page_size": 128, "block_kv": 128, "pack_gqa": True,
          "kv_splits": 2}
    assert SPACE.is_valid(ok, serving)
    # a chunk is whole pages or a part of one page, both ways
    assert SPACE.is_valid(dict(ok, block_kv=32), serving)
    assert not dict(SPACE._constraints)["block_kv:page_size"](
        dict(ok, page_size=16, block_kv=24), serving)
    # 896 tokens are 4 chunks of 256 (int8 rows, whose two stages fit):
    # no fifth split
    kv8 = ops.paged_verify_context(H100_SXM, 8, 24, 8, 128, 896, "int8",
                                   128, 2, "bfloat16")
    assert SPACE.is_valid(dict(ok, block_kv=256), kv8)
    assert SPACE.why_invalid(dict(ok, block_kv=256, kv_splits=8), kv8) == \
        "kv_splits<=chunks"
    # 7 chunks of 128 take up to 4 splits of 2 chunks
    assert SPACE.is_valid(dict(ok, kv_splits=4), serving)
    # two stages of 256 bf16 rows of 128, K and V: 256 KB
    deploy = ops.paged_verify_context(H100_SXM, 16, 24, 8, 128, 32768,
                                      "bfloat16")
    assert SPACE.why_invalid(dict(ok, block_kv=256), deploy) == "smem"
    assert SPACE.is_valid(dict(ok, kv_splits=8, draft_k=8), deploy)
    # a cluster past the portable size could not be held resident
    assert not dict(SPACE._constraints)["cluster"](dict(ok, kv_splits=16),
                                                   deploy)
    # the layout pins of v1 stay
    assert SPACE.why_invalid(dict(ok, page_size=16, block_kv=16),
                             serving) == "page_size==pool"
    assert SPACE.why_invalid(dict(ok, draft_k=4), serving) == \
        "draft_k==request"


@pytest.mark.parametrize("B,Hq,Hkv,want", [(8, 24, 8, 4), (16, 24, 8, 2),
                                           (8, 32, 32, 1), (1, 24, 8, 4)])
def test_heuristic_takes_the_fewest_splits_that_fill_the_card(B, Hq, Hkv,
                                                              want):
    """The smallest kv_splits whose rows x kv_splits blocks reach the
    card's 132 SMs (packed rows B x Hkv; a group of one is unpacked), or
    the most that 7 chunks of 128 allow (4: one sequence of 8 rows); the
    chunk is paged_decode's heuristic's, the depth the engine's."""
    ctx = ops.paged_verify_context(H100_SXM, B, Hq, Hkv, 128, 896,
                                   "bfloat16", 128, 2)
    cfg = ops.PAGED_VERIFY.default_config(ctx)
    rows = B * (Hkv if cfg["pack_gqa"] else Hq)
    assert cfg["kv_splits"] == want and cfg["draft_k"] == 2
    assert cfg["pack_gqa"] == (Hq > Hkv)
    assert cfg["block_kv"] == ops._paged_heuristic(
        ops.paged_decode_context(H100_SXM, B, Hq, Hkv, 128, 896, "bfloat16",
                                 128))["block_kv"]
    assert rows * want >= H100_SXM.sm_count or 2 * want > 896 // 128
    assert want == 1 or rows * (want // 2) < H100_SXM.sm_count
    # no split smaller than a chunk: one chunk of capacity gives one block
    short = ops.paged_verify_context(H100_SXM, B, Hq, Hkv, 128, 64,
                                     "bfloat16", 16, 4)
    assert ops.PAGED_VERIFY.default_config(short)["kv_splits"] == 1


@pytest.mark.parametrize("K", [2, 5, 12])
def test_fixed_config_is_one_split_sized_by_the_pool(K):
    for ps, itemsize in ((4, 2), (256, 2), (256, 1), (6, 1), (256, 4)):
        cfg = ops.paged_verify_fixed_config(K, 3, 128, ps, itemsize)
        assert cfg["kv_splits"] == 1 and cfg["pack_gqa"]
        assert set(cfg) == {"block_kv", "pack_gqa", "kv_splits"}
        assert pv_kernel.smem_bytes(128, itemsize, cfg["block_kv"], K, 3,
                                    True) <= pv_kernel.MAX_SMEM_BYTES


def test_workload_is_the_same_whatever_the_split():
    """The partials stay in shared memory: kv_splits moves no byte."""
    for dtype, q_dtype in (("int8", "bfloat16"), ("bfloat16", None)):
        ctx = ops.paged_verify_context(H100_SXM, 8, 24, 8, 128, 896, dtype,
                                       128, 2, q_dtype)
        base = {"draft_k": 2, "page_size": 128, "block_kv": 128,
                "pack_gqa": True, "kv_splits": 1}
        want = ops._paged_verify_workload(base, ctx)
        for s in pv_kernel.KV_SPLITS:
            got = ops._paged_verify_workload(dict(base, kv_splits=s), ctx)
            assert (got.hbm_bytes, got.flops) == (want.hbm_bytes, want.flops)


def _source_constant(name: str) -> int:
    return int(re.search(r"constexpr int %s = (\d+);" % name, SOURCE)[1])


def _query_sets(rows):                  # the source's ceiling division
    return -(-rows // _source_constant("kMaxSet"))


def test_smem_formula_equals_the_source():
    """``smem_bytes`` is ``paged_verify_smem_bytes`` of the CUDA source:
    the mbarriers, the partial of every query row that rank 0 reads and
    the larger of the ring and the row groups' merge of one set each."""
    def lanes_per_row(D, vec):      # the source's doubling loop
        tpr = 1
        while tpr < D // vec and tpr < 32:
            tpr *= 2
        return tpr

    src = "paged_verify.cu"
    round_up = c_function(src, "round_up")
    scope = {name: _source_constant(name)
             for name in ("kBarBytes", "kWarp", "kStages")}
    scope.update(lanes_per_row=lanes_per_row,
                 lane_vec=c_function(src, "lane_vec"),
                 query_rows=c_function(src, "query_rows"),
                 set_rows=c_function(src, "set_rows",
                                     {"query_sets": _query_sets}),
                 partial_bytes=c_function(src, "partial_bytes",
                                          {"round_up": round_up}))
    c_smem = c_function(src, "paged_verify_smem_bytes", scope)
    assert "return (rows + kMaxSet - 1) / kMaxSet;" in SOURCE
    assert scope["kBarBytes"] == pv_kernel.BAR_BYTES
    assert scope["kStages"] == pv_kernel.STAGES
    assert _source_constant("kMaxSet") == pv_kernel.MAX_SET <= \
        pd_kernel.MAX_PACKED_GROUP
    assert _source_constant("kMaxWarps") == pv_kernel.MAX_WARPS
    assert pv_kernel.NUM_WARPS <= pv_kernel.MAX_WARPS
    assert _source_constant("kMaxSplits") == pv_kernel.MAX_CLUSTER == \
        max(pv_kernel.KV_SPLITS)
    for D in (64, 96, 128, 160, 256):
        for item in (1, 2, 4):
            for bkv in (4, 16, 128, 256):
                for K in (2, 5, 8):
                    for g, pack in ((1, False), (3, True), (8, True),
                                    (4, False)):
                        for warps in (1, 4, 8):
                            assert pv_kernel.smem_bytes(
                                D, item, bkv, K, g, pack, warps) == c_smem(
                                D, item, bkv, K, g, int(pack), warps)


def test_query_sets_cover_every_row_once():
    """A block's rows are cut into the fewest sets of at most four rows
    (the rows a row group holds in registers), as even as the count
    allows, each set reading the same staged chunk; no set is empty, and
    the last may hold padding rows, which score and are dropped."""
    assert pv_kernel.MAX_SET == 4
    for rows in range(1, 130):
        sets = pv_kernel.query_sets(rows)
        assert sets == _query_sets(rows)
        G = -(-rows // sets)
        assert G <= pv_kernel.MAX_SET and sets * G >= rows
        assert (sets - 1) * G < rows                    # no empty set
        assert sets == 1 or rows > (sets - 1) * pv_kernel.MAX_SET
    # the serving depth: two sets of 3 (K 2 x group 3); K 8 x group 3: six
    # of 4; unpacked, K 8: two of 4
    assert pv_kernel.query_sets(pv_kernel.query_rows(2, 3, True)) == 2
    assert pv_kernel.query_sets(pv_kernel.query_rows(8, 3, True)) == 6
    assert pv_kernel.query_rows(8, 3, False) == 8


def test_path_is_bulk_wherever_the_runs_are_16_byte_multiples():
    for item in (2, 4):
        for ps, bkv in ((16, 64), (6, 6), (128, 2), (256, 125)):
            assert pv_kernel.path(item, ps, bkv) == "bulk"
    for ps, bkv in ((16, 64), (128, 128), (4, 4), (256, 128), (8, 12)):
        assert pv_kernel.path(1, ps, bkv) == "bulk"
    for ps, bkv in ((6, 6), (16, 2), (16, 18), (10, 20)):
        assert pv_kernel.path(1, ps, bkv) == "cp_async"
    assert "page_size % 4 == 0 && block_kv % 4 == 0" in SOURCE


# ----------------------------------- the split, the causal tail, the merge

def spans(L: int, block_kv: int, splits: int):
    """[start, end) of each cluster rank, cut as the kernel cuts them: an
    equal share of the row's chunks of block_kv tokens."""
    n = -(-L // block_kv)
    per = -(-n // splits)
    out = []
    for s in range(splits):
        c0 = min(s * per, n)
        c1 = min(c0 + per, n)
        out.append((min(c0 * block_kv, L), min(c1 * block_kv, L)))
    return out


def split_verify(q, kp, vp, tables, kv_len, *, block_kv, splits,
                 k_scales=None, v_scales=None):
    """A plain model of the kernel's arithmetic in f32: each rank's online
    softmax over its span, chunk by chunk, for each of the K query rows
    (query t attends k_pos <= L - K + t, masked only in a chunk that
    reaches past L - K; int8: the key's scale on the finished q.k, then
    the softmax scale, the value's on the probability), then rank 0's
    merge in rank order. Rows whose window is empty give zeros."""
    B, K, Hq, D = q.shape
    Hkv, _, ps, _ = kp.shape
    cap = tables.shape[1] * ps
    f32 = np.float32
    out = np.zeros((B, K, Hq, D), f32)
    for b in range(B):
        L = min(max(int(kv_len[b]), 0), cap)
        pos = np.arange(L)
        pages, slots = tables[b][pos // ps], pos % ps
        lim = L - K + np.arange(K)          # the last key each row attends
        for h in range(Hq):
            kvh = h // (Hq // Hkv)
            k = kp[kvh, pages, slots].astype(f32)
            v = vp[kvh, pages, slots].astype(f32)
            s = (q[b, :, h].astype(f32) @ k.T).astype(f32)     # (K, L)
            if k_scales is not None:
                s = s * k_scales[kvh, pages, slots]
            s = s * f32(D ** -0.5)
            pv_scale = (np.ones(L, f32) if v_scales is None
                        else v_scales[kvh, pages, slots])
            for t in range(K):
                parts = []
                for t0, t1 in spans(L, block_kv, splits):
                    m, l, acc = -np.inf, f32(0), np.zeros(D, f32)
                    for c0 in range(t0, t1, block_kv):
                        c1 = min(c0 + block_kv, t1)
                        keys = np.arange(c0, c1)
                        if c1 > L - K + 1:          # the causal tail's chunk
                            ok = keys <= lim[t]
                        else:
                            ok = np.ones(c1 - c0, bool)
                            assert (keys <= lim[0]).all()
                        if not ok.any():
                            continue
                        m_new = max(m, s[t, c0:c1][ok].max())
                        alpha = f32(np.exp(f32(m - m_new)))
                        p = np.where(ok, np.exp(s[t, c0:c1] - m_new),
                                     0).astype(f32)
                        l = l * alpha + p.sum(dtype=f32)
                        acc = acc * alpha + (p * pv_scale[c0:c1]) @ v[c0:c1]
                        m = m_new
                    parts.append((m, l, acc))
                M = max(m for m, _, _ in parts)
                if M == -np.inf:
                    continue
                w = [f32(0) if m == -np.inf else np.exp(f32(m - M))
                     for m, _, _ in parts]
                l_sum = sum(wi * li for wi, (_, li, _) in zip(w, parts))
                acc = sum(wi * ai for wi, (_, _, ai) in zip(w, parts))
                out[b, t, h] = acc / l_sum
    return out


def _operands(seed, pool, K):
    """Seeded numpy q (B, K, Hq, D) and pools (page 0 scratch, shuffled
    pages, unused table entries on the scratch page), a group of 4 (K·g
    = 8 or 12 query rows a block), with lengths 0, 1 (shorter than K), K,
    past the capacity and two ragged ones; int8 pools quantized by the
    kv8 wire format."""
    B, Hq, Hkv, D, ps, max_pages = 6, 8, 2, 32, 8, 6
    cap = ps * max_pages
    kv_len = [0, 1, K, cap + 1, cap // 2 + 3, 13]
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_pages
    q = rng.standard_normal((B, K, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((Hkv, n_pages, ps, D)).astype(np.float32)
    vp = rng.standard_normal((Hkv, n_pages, ps, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = tables.reshape(B, max_pages).copy()
    for b, n in enumerate(kv_len):
        tables[b, -(-min(n, cap) // ps):] = 0
    scales = {}
    if pool == "int8":
        kq, ks, vq, vs = quantize_kv(torch.from_numpy(kp),
                                     torch.from_numpy(vp))
        kp, vp = kq.numpy(), vq.numpy()
        scales = {"k_scales": ks.numpy(), "v_scales": vs.numpy()}
    elif pool == "bf16":
        q, kp, vp = (torch.from_numpy(a).bfloat16().float().numpy()
                     for a in (q, kp, vp))
    return (q, kp, vp, tables, np.asarray(kv_len, np.int32)), scales


TOLS = {"f32": 1e-4, "int8": 2e-3, "bf16": 2e-2}


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("block_kv", [4, 16])
@pytest.mark.parametrize("splits", pv_kernel.KV_SPLITS)
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_split_tail_and_merge_match_the_reference(pool, splits, block_kv,
                                                  K):
    args, scales = _operands(splits * 10 + block_kv + K, pool, K)
    got = split_verify(*args, block_kv=block_kv, splits=splits, **scales)
    jargs = [jnp.asarray(a) for a in args]
    if pool == "bf16":
        jargs[:3] = [a.astype(jnp.bfloat16) for a in jargs[:3]]
    want = np.asarray(jref.paged_verify(
        *jargs, **{k: jnp.asarray(v) for k, v in scales.items()}),
        np.float32)
    tol = TOLS[pool]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert not got[0].any(), "kv_len == 0 must give exact zeros"
    assert not got[1, 0].any(), "an empty causal window gives zeros"
    # every rank's span is whole chunks but the last, they tile [0, L),
    # and with one key and eight splits seven ranks find none
    for L in (0, 1, splits - 1, 48, 49):
        cut = spans(L, block_kv, splits)
        assert cut[0][0] == 0 and cut[-1][1] == L
        assert all(a[1] == b[0] for a, b in zip(cut, cut[1:]))
        assert all(t0 % block_kv == 0 for t0, t1 in cut if t0 < t1)
    assert sum(t0 == t1 for t0, t1 in spans(1, block_kv, splits)) == \
        splits - 1
