"""The Hopper float dense decode's host-side rules and its split-KV algebra,
on the CPU.

The kernel (``csrc/gqa_decode.cu``, behind ``gqa_decode_ragged`` and
``decode_attention``) splits each row over a thread-block cluster of
``k_splits`` blocks in one launch: rank s runs the online softmax over an
equal share of the row's chunks of ``block_kv`` keys of min(kv_len, T),
cut on the device, its warps taking 32 keys of a chunk at a time, and rank
0 merges the blocks' partials in rank order from distributed shared
memory. Here: the float spaces (valid configs against brute force at the
serving contexts and the four deployment contexts, the constraints, the
heuristic's splits), the shared-memory fit against the source's formula
(read out of the source and evaluated), a workload that no split moves, a
plain numpy model of the cut and the merges held against the reference's
``gqa_decode`` and ``decode_attention`` oracles on the same numpy
operands at the reference's tolerances (f32 1e-4, bf16 2e-2), and
``gqa_decode_kv8``, which keeps the template of ``csrc/gqa_decode.cuh``,
as it was. The kernel itself is held against the plain version on the
card (``tests/test_torch_gpu.py``).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref

from repro_torch.core.hardware import chip_from_properties
from repro_torch.kernels import gqa_decode as gqa_kernel
from repro_torch.kernels import ops

from test_torch_flash_hopper import c_function

H100_SXM = chip_from_properties("NVIDIA H100 80GB HBM3", 132, 232448,
                                50 * 2**20, 80 * 2**30)
SOURCE = (pathlib.Path(gqa_kernel.__file__).resolve().parents[1] / "csrc"
          / "gqa_decode.cu").read_text()
KERNELS = {"gqa_decode_ragged": (ops.GQA_DECODE_RAGGED,
                                 ops.gqa_decode_context),
           "decode_attention": (ops.DECODE_ATTENTION,
                                ops.decode_attention_context)}


def _valid_by_brute_force(space, ctx):
    return [c for c in space.iter_all() if space.is_valid(c, ctx)]


# (B, Hq, Hkv, D, T, dtype): the serving cache (prompts of 512 + 32 new
# tokens) in bf16 and f32, and the shipped deployments of phi4-mini,
# phi3-mini, stablelm-12b and olmoe (16 requests of 32,768 slots)
CONTEXTS = [(8, 24, 8, 128, 544, "bfloat16"),
            (8, 24, 8, 128, 544, "float32"),
            (16, 24, 8, 128, 32768, "bfloat16"),
            (16, 32, 32, 96, 32768, "bfloat16"),
            (16, 32, 8, 160, 32768, "bfloat16"),
            (16, 16, 16, 128, 32768, "bfloat16")]


@pytest.mark.parametrize(
    "shape", CONTEXTS, ids=lambda s: f"H{s[1]}-{s[2]}-D{s[3]}-T{s[4]}-{s[5]}")
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_float_space_against_brute_force(kernel, shape):
    tunable, make = KERNELS[kernel]
    ctx = make(H100_SXM, *shape)
    space = tunable.space
    valid = space.valid_configs(ctx)
    assert valid == _valid_by_brute_force(space, ctx)
    assert valid and tunable.default_config(ctx) in valid
    T = shape[4]
    for c in valid:
        block = gqa_kernel.clamp_block_kv(c["block_kv"], T)
        assert c["k_splits"] <= min(-(-T // block), 8)
        assert c["num_warps"] * 32 <= block
        assert ops._float_dense_smem(c, ctx) <= H100_SXM.smem_per_block
    if T == 32768:              # deployment: every split is swept
        assert {c["k_splits"] for c in valid} == set(gqa_kernel.KV_SPLITS)
    assert space.version == tunable.version == \
        {"gqa_decode_ragged": 2, "decode_attention": 3}[kernel]
    assert {p.name for p in space.params} == {"block_kv", "k_splits",
                                              "num_warps"} | (
        {"pack_gqa"} if kernel == "gqa_decode_ragged" else set())


def test_float_constraints_name_what_they_reject():
    space = ops.GQA_DECODE_RAGGED.space
    serving = ops.gqa_decode_context(H100_SXM, 8, 24, 8, 128, 544,
                                     "bfloat16")
    ok = {"block_kv": 64, "k_splits": 4, "pack_gqa": True, "num_warps": 2}
    assert space.is_valid(ok, serving)
    # 544 keys are 5 chunks of 128: no eighth split
    assert space.why_invalid(dict(ok, block_kv=128, k_splits=8),
                             serving) == "k_splits<=chunks"
    assert space.is_valid(dict(ok, block_kv=128, k_splits=4), serving)
    # four warps of 32 keys would leave two of a 64-key chunk idle
    assert space.why_invalid(dict(ok, num_warps=4), serving) == \
        "warps<=block_kv/32"
    # two stages of 256 bf16 rows of 128, K and V: 256 KB
    assert space.why_invalid(dict(ok, block_kv=256), serving) == "smem"
    # f32 rows of 256 take twice the ring: 64 keys already overflow
    f32 = ops.gqa_decode_context(H100_SXM, 2, 16, 2, 256, 300, "float32")
    assert space.why_invalid(dict(ok, k_splits=1), f32) == "smem"
    assert space.is_valid(dict(ok, block_kv=32, k_splits=1, num_warps=1),
                          f32)
    # a cluster past the portable size of 8 could not be held resident
    assert max(gqa_kernel.KV_SPLITS) == 8
    # packing a group of one is the unpacked kernel; past eight heads the
    # packed kernel is not instantiated
    mha = ops.gqa_decode_context(H100_SXM, 4, 32, 32, 96, 200, "bfloat16")
    assert space.why_invalid(ok, mha) == "pack_gqa:group"
    assert space.is_valid(dict(ok, pack_gqa=False), mha)
    wide = ops.decode_attention_context(H100_SXM, 4, 48, 4, 128, 200,
                                        "bfloat16")
    cfg = {k: v for k, v in ok.items() if k != "pack_gqa"}
    assert ops.DECODE_ATTENTION.space.why_invalid(cfg, wide) == "group"


@pytest.mark.parametrize("B,Hq,Hkv,T,want", [
    (8, 24, 8, 544, 4),          # 64 packed rows: 4 splits reach 132 SMs
    (16, 24, 8, 32768, 2),       # 128 rows
    (16, 32, 32, 32768, 1),      # 512 unpacked rows fill the card
    (1, 24, 8, 544, 8),          # 8 rows: the most the cluster takes
    (1, 24, 8, 100, 2)])         # 2 chunks of 64: no split past a chunk
def test_heuristic_takes_the_fewest_splits_that_fill_the_card(B, Hq, Hkv,
                                                              T, want):
    """Packed heads where the group allows, 64 keys a chunk for two warps,
    and the smallest k_splits whose rows x k_splits blocks reach the
    card's 132 SMs, or the most the chunks and the cluster allow."""
    for kernel in sorted(KERNELS):
        tunable, make = KERNELS[kernel]
        ctx = make(H100_SXM, B, Hq, Hkv, 128, T, "bfloat16")
        cfg = tunable.default_config(ctx)
        pack = 1 < Hq // Hkv and kernel == "gqa_decode_ragged"
        assert cfg == dict({"block_kv": 64, "k_splits": want,
                            "num_warps": 2},
                           **({"pack_gqa": pack}
                              if kernel == "gqa_decode_ragged" else {}))
        rows = B * (Hkv if Hq > Hkv else Hq)
        assert rows * want >= H100_SXM.sm_count or \
            want == min(8, -(-T // 64))
        assert want == 1 or rows * (want // 2) < H100_SXM.sm_count
    # a short cache stages one clamped chunk with one warp
    short = ops.gqa_decode_context(H100_SXM, 2, 4, 2, 16, 20, "float32")
    assert ops.GQA_DECODE_RAGGED.default_config(short) == {
        "block_kv": 32, "k_splits": 1, "pack_gqa": True, "num_warps": 1}


def _source_constant(name: str) -> int:
    return int(re.search(r"constexpr int %s = (\d+);" % name, SOURCE)[1])


def test_smem_formula_equals_the_source():
    """``float_smem_bytes`` is ``gqa_decode_smem_bytes`` of the CUDA
    source: the alignment slack, the larger of the ring and the warps'
    merge, q, the probability scratch, the partial and the mbarriers."""
    src = "gqa_decode.cu"
    round_up = c_function(src, "round_up")
    scope = {name: _source_constant(name)
             for name in ("kAlign", "kWarp", "kStages", "kBarBytes")}
    scope.update(round_up=round_up,
                 tile_bytes=c_function(src, "tile_bytes"),
                 partial_bytes=c_function(src, "partial_bytes",
                                          {"round_up": round_up}))
    c_smem = c_function(src, "gqa_decode_smem_bytes", scope)
    assert scope["kAlign"] == gqa_kernel.ALIGN_BYTES
    assert scope["kStages"] == gqa_kernel.STAGES
    assert scope["kBarBytes"] == gqa_kernel.BAR_BYTES
    assert _source_constant("kMaxSplits") == max(gqa_kernel.KV_SPLITS)
    assert _source_constant("kMaxWarps") == gqa_kernel.MAX_WARPS
    assert _source_constant("kMaxBlockKv") == gqa_kernel.MAX_BLOCK_KV
    for D in (16, 64, 80, 96, 120, 128, 160, 256):
        for item in (2, 4):
            for bkv in (16, 32, 64, 128, 256):
                for g, pack in ((1, False), (3, True), (8, True), (4, False)):
                    for warps in (1, 2, 4, 8):
                        rows = g if pack else 1
                        assert gqa_kernel.float_smem_bytes(
                            D, item, bkv, g, pack, warps) == c_smem(
                            D, item, bkv, rows, warps)


def test_workload_is_the_same_whatever_the_split():
    """The partials stay in shared memory: k_splits moves no byte."""
    for kernel in sorted(KERNELS):
        tunable, make = KERNELS[kernel]
        ctx = make(H100_SXM, 8, 24, 8, 128, 544, "bfloat16")
        base = tunable.default_config(ctx)
        want = tunable.workload_fn(dict(base, k_splits=1), ctx)
        for s in gqa_kernel.KV_SPLITS:
            got = tunable.workload_fn(dict(base, k_splits=s), ctx)
            assert (got.hbm_bytes, got.flops) == (want.hbm_bytes, want.flops)
    # every request at T: the bytes of the cache, q and o
    ctx = ops.decode_attention_context(H100_SXM, 8, 24, 8, 128, 544,
                                       "bfloat16")
    assert ops.DECODE_ATTENTION.workload_fn(
        ops.DECODE_ATTENTION.default_config(ctx), ctx).hbm_bytes == \
        ops.dense_decode_bytes(8, 24, 8, 128, 8 * 544, 2)


# ------------------------------------------- the cut, the warps, the merges

def spans(L: int, block_kv: int, splits: int):
    """[start, end) of each cluster rank, cut as the kernel cuts them:
    chunks [s n / S, (s + 1) n / S) of the n chunks of block_kv keys."""
    n = -(-L // block_kv)
    return [(min(s * n // splits * block_kv, L),
             min((s + 1) * n // splits * block_kv, L))
            for s in range(splits)]


def _merge(parts):
    """Online-softmax partials (m, l, acc) merged in order; (-inf, 0, 0)
    weighs nothing."""
    f32 = np.float32
    M = max(m for m, _, _ in parts)
    if M == -np.inf:
        return M, f32(0), np.zeros_like(parts[0][2])
    w = [f32(0) if m == -np.inf else np.exp(f32(m - M)) for m, _, _ in parts]
    l_sum, acc = f32(0), np.zeros_like(parts[0][2])
    for wi, (_, li, ai) in zip(w, parts):
        l_sum = f32(l_sum + li * wi)
        acc = (acc + ai * wi).astype(f32)
    return M, l_sum, acc


def split_decode(q, k, v, kv_len, *, block_kv, splits, warps):
    """A plain model of the kernel's arithmetic in f32: each rank's span
    of chunks, each chunk's passes of 32 keys taken by the warps in turn
    (one online-softmax update a pass), the warps' states merged in warp
    order into the rank's partial, the ranks' partials merged in rank
    order. kv_len is clamped to [0, T]; rows of kv_len 0 give zeros."""
    B, Hq, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    f32 = np.float32
    scale = f32(D ** -0.5)
    out = np.zeros((B, Hq, D), f32)
    for b in range(B):
        L = min(max(int(kv_len[b]), 0), T)
        for h in range(Hq):
            kvh = h // (Hq // Hkv)
            s = (k[b, kvh].astype(f32) @ q[b, h].astype(f32)) * scale
            vb = v[b, kvh].astype(f32)
            ranks = []
            for t0, t1 in spans(L, block_kv, splits):
                st = [(-np.inf, f32(0), np.zeros(D, f32))] * warps
                for c0 in range(t0, t1, block_kv):
                    rows = min(block_kv, t1 - c0)
                    for j0 in range(0, rows, 32):
                        w = (j0 // 32) % warps
                        keys = slice(c0 + j0, c0 + min(j0 + 32, rows))
                        m, l_, acc = st[w]
                        m_new = max(m, s[keys].max())
                        alpha = np.exp(f32(m - m_new))
                        p = np.exp(s[keys] - m_new).astype(f32)
                        st[w] = (m_new, f32(l_ * alpha + p.sum(dtype=f32)),
                                 (acc * alpha + p @ vb[keys]).astype(f32))
                ranks.append(_merge(st))
            M, l_sum, acc = _merge(ranks)
            if M != -np.inf:
                out[b, h] = acc / l_sum
    return out


def _operands(seed, dtype):
    """Seeded numpy q and a (B, Hkv, T, D) cache with lengths 0, 1, fewer
    keys than a chunk, past T, T and two ragged ones; bf16 operands are
    rounded to bf16."""
    B, Hq, Hkv, D, T = 7, 6, 2, 16, 150
    kv_len = np.array([0, 1, 20, T + 9, T, 97, 65], np.int32)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    if dtype == "bf16":
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (q, k, v))
    return q, k, v, kv_len


TOLS = {"f32": 1e-4, "bf16": 2e-2}


@pytest.mark.parametrize("block_kv,warps", [(32, 1), (64, 2)])
@pytest.mark.parametrize("splits", gqa_kernel.KV_SPLITS)
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_split_and_merge_match_the_reference(kernel, dtype, splits,
                                             block_kv, warps):
    q, k, v, kv_len = _operands(splits * 100 + block_kv, dtype)
    T = k.shape[2]
    if kernel == "decode_attention":
        kv_len = np.full_like(kv_len, T)   # the reference's runner: all T
    got = split_decode(q, k, v, kv_len, block_kv=block_kv, splits=splits,
                       warps=warps)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if dtype == "bf16":
        jq, jk, jv = (a.astype(jnp.bfloat16) for a in (jq, jk, jv))
    oracle = {"gqa_decode_ragged": jref.gqa_decode,
              "decode_attention": jref.decode_attention}[kernel]
    # the oracle averages V where no key is valid; the kernel gives zeros
    want = np.array(oracle(jq, jk, jv, kv_len=jnp.asarray(
        np.maximum(kv_len, 1))), np.float32)
    empty = kv_len == 0
    want[empty] = 0.0
    tol = TOLS[dtype]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert not got[empty].any(), "kv_len == 0 must give exact zeros"
    # the ranks' spans tile [0, L) on chunk boundaries, and where a row has
    # fewer chunks than splits some ranks find no key
    for L in (0, 1, 20, T, 97):
        cut = spans(L, block_kv, splits)
        assert cut[0][0] == 0 and cut[-1][1] == L
        assert all(a[1] == b[0] for a, b in zip(cut, cut[1:]))
        assert all(t0 % block_kv == 0 for t0, t1 in cut if t0 < t1)
        n = -(-L // block_kv)
        assert sum(t0 < t1 for t0, t1 in cut) == min(n, splits)


# ------------------------------------------ gqa_decode_kv8, left as it was

def test_kv8_keeps_its_space_heuristic_and_smem():
    """The int8 kernel keeps the v1 template (``csrc/gqa_decode.cuh``),
    its space (hash 2b40bafe4893739d), its heuristic and its shared-memory
    formula (the header's, which ``kernels.gqa_decode.smem_bytes``
    mirrors), its splits on a grid axis and their combine's bytes."""
    space = ops.GQA_DECODE_KV8.space
    assert space.space_hash() == "2b40bafe4893739d"
    assert ops.GQA_DECODE_KV8.version == space.version == 1
    params = {p.name: p.values for p in space.params}
    assert params == {"block_kv": (32, 64, 128, 256),
                      "k_splits": (1, 2, 4, 8, 16, 32),
                      "pack_gqa": (True, False), "num_warps": (2, 4, 8)}
    ctx = ops.gqa_decode_kv8_context(H100_SXM, 8, 24, 8, 128, 544,
                                     "bfloat16")
    heur = ops.GQA_DECODE_KV8.default_config(ctx)
    assert heur == {"block_kv": 128, "k_splits": 1, "pack_gqa": True,
                    "num_warps": 4}
    assert ops._gqa_decode_heuristic(ctx) == {
        "block_kv": 64, "k_splits": 1, "pack_gqa": True, "num_warps": 4}
    c_smem = c_function("gqa_decode.cuh", "smem_bytes")
    for D in (64, 96, 128, 160):
        for bkv in (32, 128, 256):
            for g, pack in ((1, False), (3, True), (8, True)):
                for warps in (2, 4, 8):
                    assert gqa_kernel.smem_bytes(D, 1, bkv, g, pack, warps) \
                        == c_smem(D, 1, bkv, g if pack else 1, warps)
    assert ops._dense_smem(heur, ctx) == 3 * 128 * 4 + 4 * 128 * 144
    split = dict(heur, k_splits=4)
    assert ops.GQA_DECODE_KV8.workload_fn(split, ctx).hbm_bytes > \
        ops.GQA_DECODE_KV8.workload_fn(heur, ctx).hbm_bytes
    assert ops._dense_canonical(dict(heur, block_kv=256), ops.
                                gqa_decode_kv8_context(H100_SXM, 2, 4, 2, 16,
                                                       40))["block_kv"] == 64
