"""The Hopper paged_decode's host-side rules and its split-KV algebra, on
the CPU.

The kernel (``csrc/paged_decode.cu``) splits each (sequence, head) row
over a thread-block cluster of ``kv_splits`` blocks, each running the
online softmax over an equal share of the row's chunks of ``block_kv``
tokens, and rank 0 merges the blocks' partials in rank order from
distributed shared memory; a ring of two chunks is fed by bulk copies
where the layout allows (``paged_decode.path``). Here: the version-2
space (valid configs against brute force, the new constraints, the
heuristic's splits, the fixed config), the shared-memory fit against the
source's formula (read out of the source and evaluated), the path rule,
and a plain numpy model of the split and the merge held against the
reference's ``paged_decode`` oracle on the same numpy operands, at the
reference's tolerances (f32 1e-4, int8 2e-3, bf16 2e-2). The kernel itself
is held against the plain version on the card (``tests/test_torch_gpu.py``).
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
from repro_torch.quant import quantize_kv

from test_torch_flash_hopper import c_function

H100_SXM = chip_from_properties("NVIDIA H100 80GB HBM3", 132, 232448,
                                50 * 2**20, 80 * 2**30)
SOURCE = (pathlib.Path(pd_kernel.__file__).resolve().parents[1] / "csrc"
          / "paged_decode.cu").read_text()
SPACE = ops.PAGED_DECODE.space


def _valid_by_brute_force(ctx):
    return [c for c in SPACE.iter_all() if SPACE.is_valid(c, ctx)]


def _chunks(c, ctx):
    cap = -(-ctx.shape("k")[2] // c["page_size"]) * c["page_size"]
    return -(-cap // c["block_kv"])


# (B, Hq, Hkv, D, capacity, pool dtype, page_size, q dtype): the shipped
# deployments (page size free), the serving layouts (pages of 128, 7 a
# table; the kv8 engine's), chip_smoke's pages of 16, a group of one in f32
CONTEXTS = [(16, 24, 8, 128, 32768, "bfloat16", None, None),
            (16, 32, 32, 96, 32768, "int8", None, "bfloat16"),
            (8, 24, 8, 128, 896, "bfloat16", 128, None),
            (8, 24, 8, 128, 896, "int8", 128, "bfloat16"),
            (8, 24, 8, 128, 576, "bfloat16", 16, None),
            (4, 32, 32, 96, 64, "float32", 8, None)]


@pytest.mark.parametrize("shape", CONTEXTS,
                         ids=lambda s: f"B{s[0]}-T{s[4]}-{s[5]}")
def test_version_2_space_against_brute_force(shape):
    ctx = ops.paged_decode_context(H100_SXM, *shape)
    valid = SPACE.valid_configs(ctx)
    assert valid == _valid_by_brute_force(ctx)
    assert valid and ops.PAGED_DECODE.default_config(ctx) in valid
    for c in valid:
        chunks = _chunks(c, ctx)
        assert c["kv_splits"] <= min(chunks, pd_kernel.MAX_CLUSTER)
        assert ops._paged_smem(c, ctx) <= H100_SXM.smem_per_block
    if shape[6] is None:        # deployment: every split is swept
        assert {c["kv_splits"] for c in valid} == set(pd_kernel.KV_SPLITS)
    assert SPACE.version == ops.PAGED_DECODE.version == 2


def test_version_2_constraints_name_what_they_reject():
    serving = ops.paged_decode_context(H100_SXM, 8, 24, 8, 128, 896,
                                       "bfloat16", 128)
    ok = {"page_size": 128, "block_kv": 128, "pack_gqa": True,
          "num_warps": 4, "kv_splits": 2}
    assert SPACE.is_valid(ok, serving)
    # 896 tokens are 4 chunks of 256 (int8 rows, whose two stages fit):
    # no fifth split
    kv8 = ops.paged_decode_context(H100_SXM, 8, 24, 8, 128, 896, "int8",
                                   128, "bfloat16")
    assert SPACE.is_valid(dict(ok, block_kv=256), kv8)
    assert SPACE.why_invalid(dict(ok, block_kv=256, kv_splits=8), kv8) == \
        "kv_splits<=chunks"
    # 7 chunks of 128 take up to 4 splits of 2 chunks
    assert SPACE.is_valid(dict(ok, kv_splits=4), serving)
    # two stages of 256 bf16 rows of 128, K and V: 256 KB
    deploy = ops.paged_decode_context(H100_SXM, 16, 24, 8, 128, 32768,
                                      "bfloat16")
    assert SPACE.why_invalid(dict(ok, block_kv=256), deploy) == "smem"
    assert SPACE.is_valid(dict(ok, kv_splits=8), deploy)
    # a cluster past the portable size could not be held resident
    assert not dict(SPACE._constraints)["cluster"](dict(ok, kv_splits=16),
                                                   deploy)


@pytest.mark.parametrize("B,Hq,Hkv,want", [(8, 24, 8, 4), (16, 24, 8, 2),
                                           (8, 32, 32, 1), (1, 24, 8, 4)])
def test_heuristic_takes_the_fewest_splits_that_fill_the_card(B, Hq, Hkv,
                                                              want):
    """The smallest kv_splits whose rows x kv_splits blocks reach the
    card's 132 SMs (packed rows B x Hkv; a group of one is unpacked), or
    the most that 7 chunks of 128 allow (4: one sequence of 8 rows)."""
    ctx = ops.paged_decode_context(H100_SXM, B, Hq, Hkv, 128, 896,
                                   "bfloat16", 128)
    cfg = ops.PAGED_DECODE.default_config(ctx)
    rows = B * (Hkv if cfg["pack_gqa"] else Hq)
    assert cfg["kv_splits"] == want
    assert rows * want >= H100_SXM.sm_count or 2 * want > 896 // 128
    assert want == 1 or rows * (want // 2) < H100_SXM.sm_count
    # no split smaller than a chunk: one chunk of capacity gives one block
    short = ops.paged_decode_context(H100_SXM, B, Hq, Hkv, 128, 64,
                                     "bfloat16", 16)
    assert ops.PAGED_DECODE.default_config(short)["kv_splits"] == 1


def test_fixed_config_is_one_split_of_two_stages():
    assert pd_kernel.STAGES == 2
    for ps, itemsize in ((4, 2), (256, 2), (256, 1), (6, 1)):
        cfg = ops.paged_decode_fixed_config(3, 128, ps, itemsize)
        assert cfg["kv_splits"] == 1
        assert pd_kernel.smem_bytes(128, itemsize, cfg["block_kv"], 3, True,
                                    4) <= pd_kernel.MAX_SMEM_BYTES


def test_workload_is_the_same_whatever_the_split():
    """The partials stay in shared memory: kv_splits moves no byte."""
    ctx = ops.paged_decode_context(H100_SXM, 8, 24, 8, 128, 896, "int8",
                                   128, "bfloat16")
    base = {"page_size": 128, "block_kv": 128, "pack_gqa": True,
            "num_warps": 4, "kv_splits": 1}
    want = ops._paged_workload(base, ctx)
    for s in pd_kernel.KV_SPLITS:
        got = ops._paged_workload(dict(base, kv_splits=s), ctx)
        assert (got.hbm_bytes, got.flops) == (want.hbm_bytes, want.flops)


def _source_constant(name: str) -> int:
    return int(re.search(r"constexpr int %s = (\d+);" % name, SOURCE)[1])


def test_smem_formula_equals_the_source():
    """``smem_bytes`` is ``paged_decode_smem_bytes`` of the CUDA source:
    the mbarriers, the partial rank 0 reads and the larger of the ring and
    the row-group merge."""
    def lanes_per_row(D, vec):      # the source's doubling loop
        tpr = 1
        while tpr < D // vec and tpr < 32:
            tpr *= 2
        return tpr

    src = "paged_decode.cu"
    round_up = c_function(src, "round_up")
    scope = {name: _source_constant(name)
             for name in ("kBarBytes", "kWarp", "kStages")}
    scope.update(lanes_per_row=lanes_per_row,
                 lane_vec=c_function(src, "lane_vec"),
                 partial_bytes=c_function(src, "partial_bytes",
                                          {"round_up": round_up}))
    c_smem = c_function(src, "paged_decode_smem_bytes", scope)
    assert scope["kBarBytes"] == pd_kernel.BAR_BYTES
    assert scope["kStages"] == pd_kernel.STAGES
    assert _source_constant("kMaxSplits") == pd_kernel.MAX_CLUSTER == \
        max(pd_kernel.KV_SPLITS)
    for D in (64, 96, 128, 160, 256):
        for item in (1, 2, 4):
            for bkv in (4, 16, 128, 256):
                for g, pack in ((1, False), (3, True), (8, True), (4, False)):
                    for warps in (2, 4, 8):
                        assert pd_kernel.smem_bytes(
                            D, item, bkv, g, pack, warps) == c_smem(
                            D, item, bkv, g, int(pack), warps)


def test_path_is_bulk_wherever_the_runs_are_16_byte_multiples():
    for item in (2, 4):                  # float rows: always
        for ps, bkv in ((16, 64), (6, 6), (128, 2), (256, 125)):
            assert pd_kernel.path(item, ps, bkv) == "bulk"
    for ps, bkv in ((16, 64), (128, 128), (4, 4), (256, 128), (8, 12)):
        assert pd_kernel.path(1, ps, bkv) == "bulk"
    # int8 scale runs of 4-byte rows: a page or a block not a multiple of 4
    for ps, bkv in ((6, 6), (16, 2), (16, 18), (10, 20)):
        assert pd_kernel.path(1, ps, bkv) == "cp_async"
    assert "page_size % 4 == 0 && block_kv % 4 == 0" in SOURCE


# -------------------------------------------------- the split and the merge

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


def split_decode(q, kp, vp, tables, kv_len, *, block_kv, splits,
                 k_scales=None, v_scales=None):
    """A plain model of the kernel's arithmetic in f32: each rank's online
    softmax partial (m, l, acc) over its span (int8: the key's scale on
    the finished q.k, the value's on the probability), then rank 0's merge
    in rank order. Rows of kv_len 0 give zeros."""
    B, Hq, D = q.shape
    Hkv, _, ps, _ = kp.shape
    cap = tables.shape[1] * ps
    f32 = np.float32
    out = np.zeros((B, Hq, D), f32)
    for b in range(B):
        L = min(max(int(kv_len[b]), 0), cap)
        pos = np.arange(L)
        pages, slots = tables[b][pos // ps], pos % ps
        for h in range(Hq):
            kvh = h // (Hq // Hkv)
            k = kp[kvh, pages, slots].astype(f32)
            v = vp[kvh, pages, slots].astype(f32)
            s = (k @ (q[b, h].astype(f32) * f32(D ** -0.5))).astype(f32)
            if k_scales is not None:
                s = s * k_scales[kvh, pages, slots]
            parts = []
            for t0, t1 in spans(L, block_kv, splits):
                if t0 == t1:
                    parts.append((-np.inf, f32(0), np.zeros(D, f32)))
                    continue
                m = s[t0:t1].max()
                p = np.exp(s[t0:t1] - m).astype(f32)
                pv = p if v_scales is None else \
                    p * v_scales[kvh, pages[t0:t1], slots[t0:t1]]
                parts.append((m, p.sum(dtype=f32), pv @ v[t0:t1]))
            M = max(m for m, _, _ in parts)
            if M == -np.inf:
                continue
            w = [f32(0) if m == -np.inf else np.exp(f32(m - M))
                 for m, _, _ in parts]
            l_sum = sum(wi * li for wi, (_, li, _) in zip(w, parts))
            acc = sum(wi * ai for wi, (_, _, ai) in zip(w, parts))
            out[b, h] = acc / l_sum
    return out


def _operands(seed, pool, splits, block_kv):
    """Seeded numpy q and pools (page 0 scratch, shuffled pages, unused
    table entries on the scratch page) with lengths 0, 1, fewer rows than
    splits, past the capacity and two ragged ones; int8 pools quantized
    by the kv8 wire format."""
    B, Hq, Hkv, D, ps, max_pages = 6, 8, 2, 32, 8, 6
    cap = ps * max_pages
    kv_len = [0, 1, max(splits - 1, 2), cap + 1, cap // 2 + 3, 13]
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_pages
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
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


@pytest.mark.parametrize("block_kv", [4, 16])
@pytest.mark.parametrize("splits", pd_kernel.KV_SPLITS)
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_split_and_merge_match_the_reference(pool, splits, block_kv):
    args, scales = _operands(splits * 10 + block_kv, pool, splits, block_kv)
    got = split_decode(*args, block_kv=block_kv, splits=splits, **scales)
    jargs = [jnp.asarray(a) for a in args]
    if pool == "bf16":
        jargs[:3] = [a.astype(jnp.bfloat16) for a in jargs[:3]]
    want = np.asarray(jref.paged_decode(
        *jargs, **{k: jnp.asarray(v) for k, v in scales.items()}),
        np.float32)
    tol = TOLS[pool]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert not got[0].any(), "kv_len == 0 must give exact zeros"
    # every rank's span is whole chunks but the last, and they tile [0, L)
    for L in (0, 1, splits - 1, 48, 49):
        cut = spans(L, block_kv, splits)
        assert cut[0][0] == 0 and cut[-1][1] == L
        assert all(a[1] == b[0] for a, b in zip(cut, cut[1:]))
        assert all(t0 % block_kv == 0 for t0, t1 in cut if t0 < t1)
