"""The port's tuning core: config spaces, search, cache, tuner, the card's
spec and the Hopper spaces of the ported kernels. All on the CPU with
synthetic objectives; timing on the card is ``chip_smoke.py``'s job."""

import math

import pytest
import torch

from repro_torch.core import (
    Autotuner, ConfigSpace, ExhaustiveSearch, Param, TunableKernel,
    TuningCache, TuningContext, cpu_host,
)
from repro_torch.core import cache as cache_lib
from repro_torch.core.costmodel import KernelWorkload, roofline_seconds
from repro_torch.core.hardware import chip_from_properties
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pd_kernel
from repro_torch.kernels import paged_verify as pv_kernel

H100_SXM = chip_from_properties("NVIDIA H100 80GB HBM3", 132, 232448,
                                50 * 2**20, 80 * 2**30)


def _threshold_space(th):
    sp = ConfigSpace("s", [Param("a", (1, 2, 3))])
    sp.constrain("shared-name", lambda c, x, th=th: c["a"] != th)
    return sp


def _valid_by_brute_force(space, ctx):
    return [c for c in space.iter_all() if space.is_valid(c, ctx)]


def test_valid_configs_keyed_on_constraint_identity():
    """Same params, same constraint name, different predicates: each space
    enumerates its own valid set (the reference's memo mixes them up)."""
    ctx = TuningContext(chip=cpu_host())
    one, two = _threshold_space(1), _threshold_space(2)
    assert one.space_hash() == two.space_hash()
    for sp in (one, two, one, two):
        assert sp.valid_configs(ctx) == _valid_by_brute_force(sp, ctx)
    assert [c["a"] for c in one.valid_configs(ctx)] == [2, 3]
    assert [c["a"] for c in two.valid_configs(ctx)] == [1, 3]


def test_valid_configs_of_the_hopper_spaces():
    ctxs = [
        ops.paged_decode_context(H100_SXM, 16, 24, 8, 128, 32768, "bfloat16"),
        ops.paged_decode_context(H100_SXM, 8, 24, 8, 128, 576, "bfloat16",
                                 page_size=16),
        ops.paged_decode_context(H100_SXM, 4, 32, 32, 96, 64, "float32",
                                 page_size=8),
    ]
    for ctx in ctxs:
        valid = ops.PAGED_DECODE.space.valid_configs(ctx)
        assert valid == _valid_by_brute_force(ops.PAGED_DECODE.space, ctx)
        assert valid and ops.PAGED_DECODE.default_config(ctx) in valid
        for c in valid:
            # whole pages, or a part of one page
            assert c["block_kv"] % c["page_size"] == 0 or \
                c["page_size"] % c["block_kv"] == 0
            assert ops._paged_smem(c, ctx) <= H100_SXM.smem_per_block
    deploy, pinned, mha = ctxs
    assert {c["page_size"] for c in
            ops.PAGED_DECODE.space.valid_configs(deploy)} == set(
        ops.PAGE_SIZES)
    assert {c["page_size"] for c in
            ops.PAGED_DECODE.space.valid_configs(pinned)} == {16}
    # group 1: packing is the unpacked kernel, so only one of the two
    assert not any(c["pack_gqa"] for c in
                   ops.PAGED_DECODE.space.valid_configs(mha))
    # 256 bf16 rows of 128 in a ring of two stage 256 KB: over the 227 KB
    # a block may use
    big = {"page_size": 16, "block_kv": 256, "pack_gqa": True, "num_warps": 4,
           "kv_splits": 1}
    assert ops.PAGED_DECODE.space.why_invalid(big, deploy) == "smem"


def test_valid_configs_of_the_verify_space():
    deploy = ops.paged_verify_context(H100_SXM, 16, 24, 8, 128, 32768,
                                      "bfloat16")
    pinned = ops.paged_verify_context(H100_SXM, 8, 24, 8, 128, 896,
                                      "bfloat16", page_size=128, draft_k=4)
    mha = ops.paged_verify_context(H100_SXM, 4, 32, 32, 96, 64, "float32",
                                   page_size=8, draft_k=2)
    space = ops.PAGED_VERIFY.space
    for ctx in (deploy, pinned, mha):
        valid = space.valid_configs(ctx)
        assert valid == _valid_by_brute_force(space, ctx)
        assert valid and ops.PAGED_VERIFY.default_config(ctx) in valid
        for c in valid:
            # whole pages, or a part of one page
            assert c["block_kv"] % c["page_size"] == 0 or \
                c["page_size"] % c["block_kv"] == 0
            assert ops._verify_smem(c, ctx) <= H100_SXM.smem_per_block
    # deployment tuning sweeps the depth and the page; a pinned context
    # keeps the pool's page and the engine's depth
    dep = space.valid_configs(deploy)
    assert {c["draft_k"] for c in dep} == set(pv_kernel.DRAFT_KS)
    assert {c["page_size"] for c in dep} == set(ops.PAGE_SIZES)
    assert {(c["draft_k"], c["page_size"])
            for c in space.valid_configs(pinned)} == {(4, 128)}
    assert not any(c["pack_gqa"] for c in space.valid_configs(mha))
    # 256 bf16 rows of 128 stage 256 KB: over the 227 KB a block may use
    big = {"draft_k": 2, "page_size": 16, "block_kv": 256, "pack_gqa": True,
           "kv_splits": 1}
    assert space.why_invalid(big, deploy) == "smem"
    ok = {"draft_k": 4, "page_size": 128, "block_kv": 128, "pack_gqa": True,
          "kv_splits": 1}
    assert space.is_valid(ok, pinned)
    assert space.why_invalid(dict(ok, page_size=16), pinned) == \
        "page_size==pool"
    assert space.why_invalid(dict(ok, draft_k=3), pinned) == \
        "draft_k==request"


def test_verify_smem_bytes_and_workload():
    # the mbarriers, the partial of 12 query rows (K 4, group 3: f32 m, l
    # and acc each), then the larger of a ring of two chunks of 64 bf16 K
    # and V rows of 128 and the merge of 16 row groups (8 warps of two
    # 16-lane groups) of one set of 4 rows each (12 rows: three sets)
    assert pv_kernel.query_sets(12) == 3
    assert pv_kernel.smem_bytes(128, 2, 64, 4, 3, True, 8) == (
        64 + 12 * (128 + 2) * 4 + max(2 * 2 * 64 * 128 * 2,
                                      16 * 4 * (128 + 2) * 4))
    # 4 rows (unpacked): one set of 4; K 8 x group 3 = 24 rows: six sets
    # of 4; at most 4 rows a set
    assert [pv_kernel.query_sets(r) for r in (2, 4, 6, 8, 9, 18, 24, 27,
                                             64, 65)] == \
        [1, 1, 2, 2, 3, 5, 6, 7, 16, 17]
    assert pv_kernel.smem_bytes(128, 2, 64, 4, 3, False, 8) == (
        64 + 4 * (128 + 2) * 4 + 2 * 2 * 64 * 128 * 2)
    B, K, Hq, Hkv, D, max_pages = 8, 4, 24, 8, 128, 36
    # the verify call moves decode's K/V bytes with K query rows
    assert ops.paged_verify_bytes(B, 1, Hq, Hkv, D, 3000, max_pages, 2) \
        == ops.paged_decode_bytes(B, Hq, Hkv, D, 3000, max_pages, 2)
    assert ops.paged_verify_bytes(B, K, Hq, Hkv, D, 3000, max_pages, 2) \
        - ops.paged_verify_bytes(B, 1, Hq, Hkv, D, 3000, max_pages, 2) \
        == 2 * B * (K - 1) * Hq * D * 2
    # row t of a sequence of L tokens attends L - K + t + 1 keys
    lens = torch.tensor([0, 2, 10, 99], dtype=torch.int32)
    assert ops.verify_attended(lens, 4, 64) == (0 + (0 + 0 + 1 + 2)
                                                + (7 + 8 + 9 + 10)
                                                + (61 + 62 + 63 + 64))
    ctx = ops.paged_verify_context(H100_SXM, 4, 8, 2, 64, 256, "bfloat16",
                                   draft_k=4)
    cfg = {"draft_k": 4, "page_size": 16, "block_kv": 64, "pack_gqa": True,
           "kv_splits": 1}
    packed = ops._paged_verify_workload(cfg, ctx)
    unpacked = ops._paged_verify_workload(dict(cfg, pack_gqa=False), ctx)
    assert unpacked.hbm_bytes > packed.hbm_bytes   # the group re-reads KV
    assert packed.flops == unpacked.flops > 0
    assert (ops._verify_lens(ctx, 4) >= 4).all()


def test_rms_norm_space_limits_registers():
    ctx = ops.rmsnorm_context(H100_SXM, (8, 1, 3072), "bfloat16")
    valid = ops.RMS_NORM.space.valid_configs(ctx)
    assert valid == _valid_by_brute_force(ops.RMS_NORM.space, ctx)
    assert 1 < len(valid) <= 8
    assert {"block_rows": 8, "num_warps": 4} not in valid
    assert ops.RMS_NORM.default_config(ctx) == {"block_rows": 1,
                                                "num_warps": 4}


def test_smem_formula_matches_staging_and_merge():
    # the mbarriers, the partial of 3 heads (m, l, acc of 128), then the
    # ring: two stages of K and V dominate at 64 bf16 rows of 128
    partial = 3 * 130 * 4 + 8            # rounded up to 16 bytes
    assert pd_kernel.smem_bytes(128, 2, 64, 3, True, 4) == \
        64 + partial + 2 * 2 * 64 * 128 * 2
    # the row-group merge dominates with tiny staging and many warps
    n_rg = 8 * 32 // 16
    assert pd_kernel.smem_bytes(128, 2, 16, 3, True, 8) == 64 + partial + \
        max(2 * 2 * 16 * 128 * 2, n_rg * 3 * 130 * 4)


def test_workloads_count_bytes_and_bound():
    B, Hq, Hkv, D, max_pages = 8, 24, 8, 128, 36
    kv_tokens = 3000
    want = 2 * kv_tokens * Hkv * D * 2 + 2 * B * Hq * D * 2 + 4 * B * (
        max_pages + 1)
    assert ops.paged_decode_bytes(B, Hq, Hkv, D, kv_tokens, max_pages,
                                  2) == want
    t, by = roofline_seconds(KernelWorkload(
        ops.paged_decode_flops(Hq, D, kv_tokens), want), H100_SXM)
    assert by == "bytes" and t == pytest.approx(want / 3.35e12)
    assert ops.rms_norm_bytes(8, 3072, 2) == 2 * 8 * 3072 * 2 + 3072 * 2
    ctx = ops.paged_decode_context(H100_SXM, 4, 8, 2, 64, 256, "bfloat16")
    cfg = {"page_size": 16, "block_kv": 64, "pack_gqa": True, "num_warps": 4}
    packed = ops._paged_workload(cfg, ctx)
    unpacked = ops._paged_workload(dict(cfg, pack_gqa=False), ctx)
    assert unpacked.hbm_bytes > packed.hbm_bytes   # the group re-reads KV


def test_chip_spec_from_properties():
    assert H100_SXM.name.endswith("(SXM)") and H100_SXM.hbm_bandwidth == 3.35e12
    assert H100_SXM.flops_for_dtype("bfloat16") == 989e12
    pcie = chip_from_properties("NVIDIA H100 PCIe", 114, 232448, 50 << 20,
                                80 << 30)
    assert pcie.name.endswith("(PCIe)") and pcie.hbm_bandwidth == 2.0e12
    with pytest.raises(KeyError):
        chip_from_properties("NVIDIA A100-SXM4-80GB", 108, 166912, 40 << 20,
                             80 << 30)


def _quadratic_space():
    sp = ConfigSpace("quad", [Param("x", tuple(range(-4, 5))),
                              Param("y", (1, 2, 4, 8))])
    sp.constrain("x+y odd", lambda c, _: (c["x"] + c["y"]) % 2 == 1)
    return sp


def test_exhaustive_search_finds_the_minimum():
    sp = _quadratic_space()
    ctx = TuningContext(chip=cpu_host())
    f = lambda c: (c["x"] - 1) ** 2 + abs(c["y"] - 4) + 0.5   # noqa: E731
    res = ExhaustiveSearch().run(sp, ctx, f)
    valid = _valid_by_brute_force(sp, ctx)
    assert res.evaluations == len(valid)
    assert res.best == min(valid, key=f)
    assert res.best_metric == f(res.best)
    failing = ExhaustiveSearch().run(sp, ctx, lambda c: math.inf)
    assert failing.best is None and math.isinf(failing.best_metric)


class _FakeBackend:
    """Synthetic timing: seconds = a function of the config."""

    name = "fake"

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def evaluator(self, kernel, ctx):
        def evaluate(cfg):
            self.calls += 1
            return self.fn(cfg)
        return evaluate


def _kernel():
    return TunableKernel(name="quad", space=_quadratic_space(),
                         heuristic=lambda ctx: {"x": 0, "y": 1})


def test_cache_round_trip(tmp_path):
    sp = _quadratic_space()
    ctx = TuningContext(chip=cpu_host(), shapes={"x": (4, 8)})
    entry = cache_lib.make_entry({"x": 1, "y": 4}, 2e-6, 18, "exhaustive",
                                 "fake", measure_s=0.5)
    mem = TuningCache()
    assert mem.get("quad", 1, sp, ctx) is None
    mem.put("quad", 1, sp, ctx, entry)
    assert mem.get("quad", 1, sp, ctx).config == {"x": 1, "y": 4}

    disk = TuningCache(cache_dir=str(tmp_path / "tuning"))
    disk.put("quad", 1, sp, ctx, entry)
    again = TuningCache(cache_dir=str(tmp_path / "tuning"))
    got = again.get("quad", 1, sp, ctx,
                    require_fingerprint=cache_lib.env_fingerprint("fake"))
    assert got == entry
    for key in ("gpu", "driver", "cuda", "torch", "triton"):
        assert key in got.fingerprint
    # another environment, another kernel version, another shape: misses
    assert again.get("quad", 1, sp, ctx,
                     require_fingerprint={"torch": "0.0"}) is None
    assert again.get("quad", 2, sp, ctx) is None
    assert again.get("quad", 1, sp, TuningContext(chip=cpu_host())) is None


def test_autotuner_tunes_on_miss_then_hits():
    f = lambda c: (c["x"] + 2) ** 2 + c["y"] * 1e-3   # noqa: E731
    backend = _FakeBackend(f)
    tuner = Autotuner(backend=backend)
    ctx = TuningContext(chip=cpu_host(), shapes={"x": (3,)})
    k = _kernel()
    best = tuner.best_config(k, ctx)
    assert best == {"x": -2, "y": 1} and backend.calls > 0
    calls = backend.calls
    assert tuner.best_config(k, ctx) == best
    assert backend.calls == calls
    assert tuner.stats() == {"hits": 1, "misses": 1, "tunes": 1,
                             "heuristic_uses": 0}


def test_autotuner_miss_policies():
    ctx = TuningContext(chip=cpu_host())
    k = _kernel()
    heur = Autotuner(backend=_FakeBackend(lambda c: 1.0), on_miss="heuristic")
    assert heur.best_config(k, ctx) == {"x": 0, "y": 1}
    assert heur.stats()["heuristic_uses"] == 1
    strict = Autotuner(backend=_FakeBackend(lambda c: 1.0), on_miss="error")
    with pytest.raises(LookupError):
        strict.best_config(k, ctx)
    # a search where nothing ran is stored as failed and never served
    broken = Autotuner(backend=_FakeBackend(lambda c: math.inf))
    entry = broken.tune(k, ctx)
    assert entry.failed() and entry.config == {"x": 0, "y": 1}
    with pytest.raises(ValueError):
        Autotuner(on_miss="sometimes")


def test_dispatch_memo_follows_new_tunes():
    scores = {"x": 3}
    backend = _FakeBackend(lambda c: abs(c["x"] - scores["x"]) + c["y"] * 1e-2)
    tuner = Autotuner(backend=backend)
    ctx = TuningContext(chip=cpu_host())
    k = _kernel()
    built = []

    def make_ctx():
        built.append(1)
        return ctx

    first = tuner.dispatch_config(k, ("key",), make_ctx)
    assert first["x"] == 3
    assert tuner.dispatch_config(k, ("key",), make_ctx) == first
    assert len(built) == 1
    scores["x"] = -3
    tuner.tune(k, ctx)
    assert tuner.dispatch_config(k, ("key",), make_ctx)["x"] == -3


def test_entry_points_skip_tuning_for_cpu_tensors():
    tuner = Autotuner(backend=_FakeBackend(lambda c: 1.0), on_miss="error")
    x = torch.randn(3, 16)
    out = ops.rmsnorm(x, torch.ones(16), tuner=tuner)
    assert out.shape == x.shape and tuner.stats()["misses"] == 0
    pool = torch.randn(2, 5, 8, 16)
    out = ops.paged_verify(torch.randn(2, 4, 4, 16), pool, pool,
                           torch.tensor([[1, 2], [3, 4]]),
                           torch.tensor([6, 12]), tuner=tuner)
    assert out.shape == (2, 4, 4, 16) and tuner.stats()["misses"] == 0


def test_off_space_layouts_dispatch_a_fixed_config(monkeypatch):
    """A pool whose page size is outside the space, or a verify at a depth
    outside ``DRAFT_KS``, dispatches a fixed config with no tuning (the
    reference's one page per step, packed), halved to fit in shared
    memory; in-space layouts still tune. Timed by a stub backend."""
    monkeypatch.setattr(ops, "device_chip", lambda index: H100_SXM)
    backend = _FakeBackend(lambda c: c["block_kv"] * 1e-6 + c["kv_splits"])
    tuner = Autotuner(backend=backend, on_miss="tune")
    # the smallest input that raised before: no config of depth 5 to tune
    with pytest.raises(ValueError, match="no valid config"):
        Autotuner(backend=backend).best_config(
            ops.PAGED_VERIFY, ops.paged_verify_context(
                H100_SXM, 8, 24, 8, 128, 896, "bfloat16", 16, 5))
    backend.calls = 0
    bf16 = torch.bfloat16
    tables = torch.zeros(8, 7, dtype=torch.int32)

    def pool(ps, dtype=bf16):
        return torch.zeros(8, 3, ps, 128, dtype=dtype)

    q = torch.zeros(8, 24, 128, dtype=bf16)
    for ps, dtype, block in ((4, bf16, 4), (256, bf16, 128),
                             (256, torch.float32, 64)):
        cfg = ops.paged_decode_config(q.to(dtype), pool(ps, dtype), tables,
                                      tuner)
        assert cfg == {"block_kv": block, "pack_gqa": True, "num_warps": 4,
                       "kv_splits": 1}
        assert pd_kernel.smem_bytes(128, dtype.itemsize, block, 3, True,
                                    4) <= pd_kernel.MAX_SMEM_BYTES
    for K, ps in ((5, 16), (5, 4), (2, 256), (12, 128)):
        qk = torch.zeros(8, K, 24, 128, dtype=bf16)
        cfg = ops.paged_verify_config(qk, pool(ps), tables, tuner)
        assert cfg["pack_gqa"] and cfg["block_kv"] <= ps
        assert pv_kernel.smem_bytes(128, 2, cfg["block_kv"], K, 3,
                                    True) <= pv_kernel.MAX_SMEM_BYTES
    assert backend.calls == 0 and tuner.stats()["misses"] == 0
    tuned = ops.paged_verify_config(torch.zeros(8, 4, 24, 128, dtype=bf16),
                                    pool(16), tables, tuner)
    assert backend.calls > 0 and tuned["draft_k"] == 4
    assert tuned["page_size"] == 16


H100_DENSE = (8, 24, 8, 128, 544)   # B, Hq, Hkv, D, T at the serving shape


@pytest.mark.parametrize("kernel", ["decode_attention", "gqa_decode_ragged"])
def test_dense_decode_spaces(kernel):
    tunable = {"decode_attention": ops.DECODE_ATTENTION,
               "gqa_decode_ragged": ops.GQA_DECODE_RAGGED}[kernel]
    make = {"decode_attention": ops.decode_attention_context,
            "gqa_decode_ragged": ops.gqa_decode_context}[kernel]
    ctx = make(H100_SXM, *H100_DENSE, "bfloat16")
    valid = tunable.space.valid_configs(ctx)
    assert valid == _valid_by_brute_force(tunable.space, ctx)
    for c in valid:
        assert c["k_splits"] <= -(-544 // c["block_kv"])    # k_splits<=chunks
        assert c["k_splits"] <= 8 and c["num_warps"] * 32 <= c["block_kv"]
        assert ops._float_dense_smem(c, ctx) <= H100_SXM.smem_per_block
    # 256 bf16 rows of 128, a ring of two stages of K and V: 256 KB, over
    # 227 KB
    assert {c["block_kv"] for c in valid} == {32, 64, 128}
    big = dict(valid[0], block_kv=256)
    assert tunable.space.why_invalid(big, ctx) == "smem"
    assert tunable.space.why_invalid(dict(valid[0], block_kv=128,
                                          k_splits=8), ctx) == \
        "k_splits<=chunks"
    assert tunable.default_config(ctx) in valid
    # a short cache clamps the block: 256 rows stage as 64 at T 40
    short = make(H100_SXM, 2, 4, 2, 16, 40, "float32")
    c = dict(tunable.default_config(short), block_kv=256)
    assert tunable.canonicalize(c, short)["block_kv"] == 64
    assert tunable.space.is_valid(c, short)
    if kernel == "gqa_decode_ragged":
        assert ops.GQA_DECODE_RAGGED.default_config(ctx)["pack_gqa"]
        mha = make(H100_SXM, 4, 32, 32, 96, 200, "bfloat16")
        assert not any(c["pack_gqa"] for c in
                       tunable.space.valid_configs(mha))
        wide = make(H100_SXM, 4, 48, 4, 128, 200, "bfloat16")   # group 12
        assert not any(c["pack_gqa"] for c in
                       tunable.space.valid_configs(wide))
    else:
        assert not tunable.space.valid_configs(
            make(H100_SXM, 4, 48, 4, 128, 200, "bfloat16"))


def test_dense_workloads_and_canonical_dedupe():
    ctx = ops.gqa_decode_context(H100_SXM, *H100_DENSE, "bfloat16")
    cfg = {"block_kv": 64, "k_splits": 1, "pack_gqa": True, "num_warps": 4}
    packed = ops._dense_workload(cfg, ctx, None)
    assert packed.hbm_bytes == ops.dense_decode_bytes(8, 24, 8, 128, 8 * 544,
                                                      2)
    assert ops.dense_decode_bytes(8, 24, 8, 128, 8 * 544, 2) == \
        2 * 8 * 544 * 8 * 128 * 2 + 2 * 8 * 24 * 128 * 2 + 4 * 8
    unpacked = ops._dense_workload(dict(cfg, pack_gqa=False), ctx, None)
    split = ops._dense_workload(dict(cfg, k_splits=4), ctx, None)
    assert unpacked.hbm_bytes > packed.hbm_bytes     # the group re-reads
    # the float kernel merges its splits in shared memory; the int8 kernel
    # writes f32 partials that its combine reads back
    assert split.hbm_bytes == packed.hbm_bytes
    combined = ops._dense_workload(dict(cfg, k_splits=4), ctx, None,
                                   combine=True)
    assert combined.hbm_bytes == packed.hbm_bytes + \
        2 * (8 * 24 // 3) * 4 * 3 * (128 + 1) * 4
    ragged = ops.GQA_DECODE_RAGGED.workload_fn(cfg, ctx)
    assert ragged.hbm_bytes < packed.hbm_bytes       # lengths below T
    # configs that clamp to the same block are timed once
    backend = _FakeBackend(lambda c: 1.0 + c["k_splits"])
    short = ops.decode_attention_context(H100_SXM, 2, 4, 2, 16, 40,
                                         "float32")
    entry = Autotuner(backend=backend).tune(ops.DECODE_ATTENTION, short)
    canon = {tuple(sorted(ops._dense_canonical(c, short).items()))
             for c in ops.DECODE_ATTENTION.space.valid_configs(short)}
    assert backend.calls == len(canon) < entry.n_evaluated


def test_dispatch_keys_separate_dtypes(monkeypatch):
    """The dtype is part of the dense entry points' dispatch key and of the
    tuning context, so a float32 and a bfloat16 cache (and int8 under kv8)
    tune apart."""
    monkeypatch.setattr(ops, "device_chip", lambda index: H100_SXM)
    seen = []

    class Recording(Autotuner):
        def dispatch_config(self, kernel, key, make_ctx):
            seen.append((key, make_ctx().signature()))
            return super().dispatch_config(kernel, key, make_ctx)

    tuner = Recording(backend=_FakeBackend(lambda c: 1.0), on_miss="heuristic")

    class FakeCuda:
        """Only what the config resolution reads off a tensor."""

        def __init__(self, t):
            self.t = t
            self.shape, self.dtype = t.shape, t.dtype
            self.is_cuda = True
            self.device = torch.device("cuda", 0)

    monkeypatch.setattr(ops.gqa_kernel, "gqa_decode", lambda *a, **k: k)
    monkeypatch.setattr(ops.kv8_kernel, "gqa_decode_kv8", lambda *a, **k: k)
    for dtype in (torch.float32, torch.bfloat16):
        q = FakeCuda(torch.zeros(2, 4, 16, dtype=dtype))
        k = FakeCuda(torch.zeros(2, 2, 40, 16, dtype=dtype))
        cfg = ops.ragged_decode(q, k, k, kv_len=None, tuner=tuner)
        assert set(cfg) >= {"block_kv", "k_splits", "pack_gqa", "num_warps"}
    # kv8: an int8 cache of the same shapes, q in bf16 and in f32
    k8 = FakeCuda(torch.zeros(2, 2, 40, 16, dtype=torch.int8))
    s8 = FakeCuda(torch.zeros(2, 2, 40))
    for dtype in (torch.bfloat16, torch.float32):
        q = FakeCuda(torch.zeros(2, 4, 16, dtype=dtype))
        cfg = ops.ragged_decode_kv8(q, k8, k8, s8, s8, kv_len=None,
                                    tuner=tuner)
        assert set(cfg) >= {"block_kv", "k_splits", "pack_gqa", "num_warps"}
    (k32, s32), (k16, s16), (k8b, s8b), (k8f, s8f) = seen
    assert k32 != k16 and s32 != s16
    assert "float32" in k32 and "bfloat16" in k16
    # the int8 context: dtype "int8" as the reference keys it, so kv8 and
    # the float caches of the same shapes never share an entry
    assert len({k32, k16, k8b, k8f}) == len({s32, s16, s8b, s8f}) == 4
    assert "int8" in k8b and "int8" in k8f
    assert all('"dtype": "int8"' in sig for sig in (s8b, s8f))
    assert '"q_dtype": "bfloat16"' in s8b and "q_dtype" not in s8f
    assert tuner.stats()["misses"] == 4


def test_kv8_space_workload_and_operands():
    """The int8 kernel's Hopper space: the dense space's constraints on its
    own shared-memory formula with int8 rows (so 256-key blocks fit where
    bf16's do not), the reference's splits<=blocks; a workload of int8
    rows plus f32 scales (about half of bf16's bytes); operands quantized
    through the port's wire format."""
    from repro_torch.quant import quantize_kv
    ctx = ops.gqa_decode_kv8_context(H100_SXM, *H100_DENSE, "bfloat16")
    space = ops.GQA_DECODE_KV8.space
    valid = space.valid_configs(ctx)
    assert valid == _valid_by_brute_force(space, ctx)
    assert {c["block_kv"] for c in valid} == {32, 64, 128, 256}
    for c in valid:
        assert c["k_splits"] <= -(-544 // c["block_kv"])
        assert ops._dense_smem(c, ctx) <= H100_SXM.smem_per_block
    assert space.why_invalid(dict(valid[0], block_kv=128, k_splits=8),
                             ctx) == "splits<=blocks"
    heur = ops.GQA_DECODE_KV8.default_config(ctx)
    assert heur == {"block_kv": 128, "k_splits": 1, "pack_gqa": True,
                    "num_warps": 4}
    # 128 int8 rows of 128 (+16 padding), double-buffered K and V
    assert ops._dense_smem(heur, ctx) == 3 * 128 * 4 + 4 * 128 * 144
    # bytes at the serving shape, every request at 528 of 544 (PERF.md)
    assert ops.dense_decode_bytes(8, 24, 8, 128, 8 * 528, 1, q_itemsize=2,
                                  scale_bytes=4) == \
        2 * 8 * 528 * 8 * (128 + 4) + 2 * 8 * 24 * 128 * 2 + 4 * 8
    float_ctx = ops.gqa_decode_context(H100_SXM, *H100_DENSE, "bfloat16")
    w8 = ops.GQA_DECODE_KV8.workload_fn(heur, ctx)
    w16 = ops.GQA_DECODE_RAGGED.workload_fn(heur, float_ctx)
    assert 0.5 < w8.hbm_bytes / w16.hbm_bytes < 0.55
    assert w8.flops == w16.flops and w8.dtype == "bfloat16"
    # operands: the reference's f32 q in a bench case, serving's bf16 q
    small = ops.gqa_decode_kv8_context(H100_SXM, 2, 4, 2, 16, 40)
    (q, k, v, ks, vs), kw = ops._kv8_operands(small, "cpu")
    assert q.dtype == torch.float32 and k.dtype == torch.int8
    assert k.shape == (2, 2, 40, 16) and ks.shape == (2, 2, 40)
    kq, ksq = quantize_kv(k.transpose(1, 2).float() * ks.transpose(
        1, 2)[..., None], v.transpose(1, 2).float())[:2]
    assert int((kq - k.transpose(1, 2)).abs().max()) <= 1
    assert kw["kv_len"].shape == (2,)
    (qb, *_), _ = ops._kv8_operands(ops.gqa_decode_kv8_context(
        H100_SXM, 2, 4, 2, 16, 40, "bfloat16"), "cpu")
    assert qb.dtype == torch.bfloat16


def test_paged_kv8_context_workload_smem_and_operands():
    """The int8 scenario of paged_decode: a context of its own (dtype
    int8, q's dtype in extra), a workload of int8 rows plus f32 scales
    (q and o in q's dtype), the shared-memory formula of the int8 rows
    with their staged scales (the one ``smem_fits`` filters on), and
    operands quantized through the wire format."""
    from repro_torch.quant import quantize_kv
    B, Hq, Hkv, D, cap = 8, 24, 8, 128, 576
    bf16 = ops.paged_decode_context(H100_SXM, B, Hq, Hkv, D, cap,
                                    "bfloat16", 16)
    kv8 = ops.paged_decode_context(H100_SXM, B, Hq, Hkv, D, cap, "int8", 16,
                                   "bfloat16")
    kv8_f32 = ops.paged_decode_context(H100_SXM, B, Hq, Hkv, D, cap, "int8",
                                       16, "float32")
    assert kv8.extra == {"page_size": 16, "q_dtype": "bfloat16"}
    assert kv8_f32.extra == {"page_size": 16}
    assert len({c.signature() for c in (bf16, kv8, kv8_f32)}) == 3
    # bytes: 2·Σ min(kv_len, cap)·Hkv·(D + 4) + 2·B·Hq·D·q_item + 4·B·(pages+1)
    assert ops.paged_decode_bytes(B, Hq, Hkv, D, 3000, 36, 1, q_itemsize=2,
                                  scale_bytes=4) == \
        2 * 3000 * Hkv * (D + 4) + 2 * B * Hq * D * 2 + 4 * B * 37
    cfg = {"page_size": 16, "block_kv": 64, "pack_gqa": True, "num_warps": 4}
    tokens = float(torch.clamp(ops._ragged_lens(kv8), max=cap).sum())
    w8, w16 = (ops._paged_workload(cfg, c) for c in (kv8, bf16))
    assert w8.hbm_bytes == ops.paged_decode_bytes(
        B, Hq, Hkv, D, tokens, 36, 1, q_itemsize=2, scale_bytes=4)
    assert w8.dtype == "bfloat16" and w8.flops == w16.flops
    assert 0.5 < w8.hbm_bytes / w16.hbm_bytes < 0.55
    assert ops._paged_workload(cfg, kv8_f32).dtype == "float32"
    # shared memory: int8 rows of D plus two f32 scales in the ring
    for c in ops.PAGED_DECODE.space.valid_configs(kv8):
        assert ops._paged_smem(c, kv8) == pd_kernel.smem_bytes(
            D, 1, c["block_kv"], 3, c["pack_gqa"], c["num_warps"])
        assert ops._paged_smem(c, kv8) <= H100_SXM.smem_per_block
    assert pd_kernel.smem_bytes(D, 1, 256, 3, True, 4) == \
        64 + 3 * (D + 2) * 4 + 8 + 2 * 2 * 256 * (D + 4)
    big = dict(cfg, block_kv=256, kv_splits=1)
    assert ops.PAGED_DECODE.space.is_valid(big, kv8)
    assert ops.PAGED_DECODE.space.why_invalid(big, bf16) == "smem"
    # operands: the seeded f32 pools quantized by the wire format
    small = ops.paged_decode_context(H100_SXM, 2, 8, 2, 16, 40, "int8", 8,
                                     "bfloat16")
    (q, kq, vq, tbl, lens), kw = ops._pool_operands(
        small, 8, ops._ragged_lens(small), "cpu")
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(q, ops._randn((2, 8, 16), torch.bfloat16, gen))
    kp = ops._randn(kq.shape, torch.float32, gen)
    vp = ops._randn(vq.shape, torch.float32, gen)
    want = quantize_kv(kp, vp)
    for got, ref_ in zip((kq, kw["k_scales"], vq, kw["v_scales"]), want):
        assert torch.equal(got, ref_)
    assert kq.dtype == torch.int8 and kw["k_scales"].shape == (2, 11, 8)


def test_paged_decode_dispatch_key_and_fixed_config_follow_the_pool(
        monkeypatch):
    """Under int8 pools the dispatch key holds q's dtype as well as the
    pool's, so bf16 and f32 queries tune apart; an off-space int8 pool's
    fixed config is sized by the pool's rows (1 byte and its scales),
    not by q's, and fits in shared memory."""
    monkeypatch.setattr(ops, "device_chip", lambda index: H100_SXM)
    seen = []

    class Recording(Autotuner):
        def dispatch_config(self, kernel, key, make_ctx):
            seen.append((key, make_ctx().signature()))
            return super().dispatch_config(kernel, key, make_ctx)

    tuner = Recording(backend=_FakeBackend(lambda c: 1.0), on_miss="heuristic")
    tables = torch.zeros(8, 7, dtype=torch.int32)
    pool8 = torch.zeros(8, 3, 16, 128, dtype=torch.int8)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(8, 24, 128, dtype=dtype)
        cfg = ops.paged_decode_config(q, pool8, tables, tuner)
        assert cfg["page_size"] == 16
    (kb, sb), (kf, sf) = seen
    assert kb != kf and sb != sf
    assert "int8" in kb and "bfloat16" in kb and "float32" in kf
    assert '"q_dtype": "bfloat16"' in sb and "q_dtype" not in sf
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(8, 24, 128, dtype=dtype)
        for ps in (4, 256):
            pool = torch.zeros(8, 3, ps, 128, dtype=torch.int8)
            cfg = ops.paged_decode_config(q, pool, tables, tuner)
            # 256 int8 rows with their scales stage in 134 KB: a whole page
            assert cfg == {"block_kv": ps, "pack_gqa": True, "num_warps": 4,
                           "kv_splits": 1}
            assert pd_kernel.smem_bytes(128, 1, ps, 3, True, 4) <= \
                pd_kernel.MAX_SMEM_BYTES
    assert tuner.stats()["misses"] == 2


def test_paged_verify_kv8_context_workload_smem_and_operands():
    """The int8 scenario of paged_verify: a context of its own (dtype
    int8, q's dtype in extra), a workload of int8 rows plus f32 scales
    with K query rows in and out in q's dtype, the shared-memory formula
    with two itemsizes (int8 staging rows with their scales, query rows
    in q's dtype: the one ``smem_fits`` filters on), and K-position
    operands quantized through the wire format."""
    from repro_torch.quant import quantize_kv
    B, Hq, Hkv, D, cap, K = 8, 24, 8, 128, 576, 4
    bf16 = ops.paged_verify_context(H100_SXM, B, Hq, Hkv, D, cap,
                                    "bfloat16", 16, K)
    kv8 = ops.paged_verify_context(H100_SXM, B, Hq, Hkv, D, cap, "int8", 16,
                                   K, "bfloat16")
    kv8_f32 = ops.paged_verify_context(H100_SXM, B, Hq, Hkv, D, cap, "int8",
                                       16, K, "float32")
    assert kv8.extra == {"page_size": 16, "draft_k": K, "q_dtype": "bfloat16"}
    assert kv8_f32.extra == {"page_size": 16, "draft_k": K}
    assert len({c.signature() for c in (bf16, kv8, kv8_f32)}) == 3
    # bytes: 2·Σ L·Hkv·(D + 4) + 2·B·K·Hq·D·q_item + 4·B·(pages + 1)
    assert ops.paged_verify_bytes(B, K, Hq, Hkv, D, 3000, 36, 1,
                                  q_itemsize=2, scale_bytes=4) == \
        2 * 3000 * Hkv * (D + 4) + 2 * B * K * Hq * D * 2 + 4 * B * 37
    cfg = {"draft_k": K, "page_size": 16, "block_kv": 64, "pack_gqa": True,
           "kv_splits": 1}
    lens = ops._verify_lens(kv8, K)
    tokens = float(torch.clamp(lens, max=cap).sum())
    w8, w16 = (ops._paged_verify_workload(cfg, c) for c in (kv8, bf16))
    assert w8.hbm_bytes == ops.paged_verify_bytes(
        B, K, Hq, Hkv, D, tokens, 36, 1, q_itemsize=2, scale_bytes=4)
    assert w8.dtype == "bfloat16" and w8.flops == w16.flops
    assert w8.hbm_bytes < w16.hbm_bytes
    assert ops._paged_verify_workload(cfg, kv8_f32).dtype == "float32"
    # shared memory: the partial of the K·g = 12 query rows, then the
    # larger of the ring (int8 staging rows of D plus two f32 scales) and
    # the merge of 16 row groups of 4 rows; q stays in registers, so its
    # dtype takes none
    assert pv_kernel.smem_bytes(D, 1, 64, K, 3, True) == (
        64 + 12 * (D + 2) * 4 + max(2 * 2 * 64 * (D + 4),
                                    16 * 4 * (D + 2) * 4))
    for ctx in (kv8, kv8_f32):
        valid = ops.PAGED_VERIFY.space.valid_configs(ctx)
        assert valid
        for c in valid:
            assert ops._verify_smem(c, ctx) == pv_kernel.smem_bytes(
                D, 1, c["block_kv"], K, 3, c["pack_gqa"]) == \
                ops._verify_smem(c, kv8)
            assert ops._verify_smem(c, ctx) <= H100_SXM.smem_per_block
    big = dict(cfg, block_kv=256)
    assert ops.PAGED_VERIFY.space.is_valid(big, kv8)
    assert ops.PAGED_VERIFY.space.why_invalid(big, bf16) == "smem"
    # operands: the seeded f32 pools quantized by the wire format, a
    # (B, K, Hq, D) q in q's dtype, lengths >= K
    small = ops.paged_verify_context(H100_SXM, 2, 8, 2, 16, 40, "int8", 8,
                                     3, "bfloat16")
    (q, kq, vq, tbl, lens), kw = ops._paged_verify_operands(small,
                                                            device="cpu")
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(q, ops._randn((2, 3, 8, 16), torch.bfloat16, gen))
    kp = ops._randn(kq.shape, torch.float32, gen)
    vp = ops._randn(vq.shape, torch.float32, gen)
    want = quantize_kv(kp, vp)
    for got, ref_ in zip((kq, kw["k_scales"], vq, kw["v_scales"]), want):
        assert torch.equal(got, ref_)
    assert kq.dtype == torch.int8 and kw["k_scales"].shape == (2, 11, 8)
    assert (lens >= 3).all()


def test_paged_verify_dispatch_key_and_fixed_config_follow_the_pool(
        monkeypatch):
    """Under int8 pools the verify's dispatch key holds q's dtype as well
    as the pool's, so bf16 and f32 queries tune apart; a verify at an
    off-space depth or page size over int8 pools dispatches the fixed
    config sized by the pool's rows (1 byte and their scales), which fits
    in shared memory where q's itemsize for the staging would not have
    given the same block."""
    monkeypatch.setattr(ops, "device_chip", lambda index: H100_SXM)
    seen = []

    class Recording(Autotuner):
        def dispatch_config(self, kernel, key, make_ctx):
            seen.append((key, make_ctx().signature()))
            return super().dispatch_config(kernel, key, make_ctx)

    tuner = Recording(backend=_FakeBackend(lambda c: 1.0), on_miss="heuristic")
    tables = torch.zeros(8, 7, dtype=torch.int32)
    pool8 = torch.zeros(8, 3, 16, 128, dtype=torch.int8)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(8, 4, 24, 128, dtype=dtype)
        cfg = ops.paged_verify_config(q, pool8, tables, tuner)
        assert cfg["page_size"] == 16 and cfg["draft_k"] == 4
    (kb, sb), (kf, sf) = seen
    assert kb != kf and sb != sf
    assert "int8" in kb and "bfloat16" in kb and "float32" in kf
    assert '"q_dtype": "bfloat16"' in sb and "q_dtype" not in sf
    for dtype in (torch.bfloat16, torch.float32):
        for K, ps in ((5, 16), (5, 4), (4, 256), (12, 128)):
            q = torch.zeros(8, K, 24, 128, dtype=dtype)
            pool = torch.zeros(8, 3, ps, 128, dtype=torch.int8)
            cfg = ops.paged_verify_config(q, pool, tables, tuner)
            assert cfg["pack_gqa"] and cfg["kv_splits"] == 1
            assert cfg == ops.paged_verify_fixed_config(K, 3, 128, ps, 1)
            smem = pv_kernel.smem_bytes(128, 1, cfg["block_kv"], K, 3, True)
            assert smem <= pv_kernel.MAX_SMEM_BYTES
            # halved only while the int8 rows do not fit
            if cfg["block_kv"] < ps:
                assert pv_kernel.smem_bytes(
                    128, 1, 2 * cfg["block_kv"], K, 3,
                    True) > pv_kernel.MAX_SMEM_BYTES
    # pages of 256 at K 4: a whole page of int8 rows fits, where staging
    # bf16 rows would have halved the block
    assert ops.paged_verify_fixed_config(4, 3, 128, 256, 1)[
        "block_kv"] == 256
    assert ops.paged_verify_fixed_config(4, 3, 128, 256, 2)[
        "block_kv"] == 128
    assert tuner.stats()["misses"] == 2


def test_chip_spec_prices_int8_work():
    """The int8 tensor-core peak from the data sheets: ``flops_for_dtype``
    takes "int8", as the reference's does, so an int8 GEMM workload has a
    bound."""
    pcie = chip_from_properties("NVIDIA H100 PCIe", 114, 232448, 50 << 20,
                                80 << 30)
    assert H100_SXM.flops_for_dtype("int8") == H100_SXM.peak_int8_ops \
        == 1979e12
    assert pcie.flops_for_dtype("int8") == 1513e12
    assert cpu_host().flops_for_dtype("int8") > 0
    with pytest.raises(KeyError, match="int4"):
        H100_SXM.flops_for_dtype("int4")


# phi4-mini's four w8a8 serving GEMMs: (M, K, N) of decode wi and wo (8
# rows) and prefill wi and wo (8 prompts of 512)
W8A8_SERVING = [(8, 3072, 16384), (8, 8192, 3072), (4096, 3072, 16384),
                (4096, 8192, 3072)]


def test_matmul_w8a8_space_workload_and_canonical_dedupe():
    """The w8a8 GEMM's Hopper space (version 2): at decode wi 100 valid
    configs of the wgmma kernel (the operands swapped, x's 8 rows as
    wgmma's N, split-K), each within shared memory and the registers the
    source instantiates; a workload of 2·M·K·N int8 operations over the
    bytes each operand needs once; the roofline bounds of the serving
    GEMMs (decode by bytes, prefill by operations); on the mma.sync path
    (K 200) configs clamping to one tile timed once."""
    from repro_torch.kernels import matmul_w8a8 as mm8_kernel
    space = ops.MATMUL_W8A8.space
    assert space.version == ops.MATMUL_W8A8.version == 2
    ctx = ops.matmul_w8a8_context(H100_SXM, 8, 3072, 16384)
    valid = space.valid_configs(ctx)
    assert valid == _valid_by_brute_force(space, ctx)
    assert len(valid) == 100
    for c in valid:
        assert c["scale_gran"] == "per_channel" and c["block_m"] == 8
        assert mm8_kernel.wgmma_regs_fit(c["block_m"], c["block_n"],
                                         c["dequant"])
        assert ops._w8a8_smem(c, ctx) <= H100_SXM.smem_per_block
    assert space.why_invalid(dict(valid[0], block_m=128, block_n=256,
                                  num_warps=4), ctx) == "tile"
    prefill = ops.matmul_w8a8_context(H100_SXM, 4096, 3072, 16384)
    cfg = {"block_m": 128, "block_n": 256, "block_k": 128, "num_warps": 8,
           "num_stages": 4, "split_k": 1, "dequant": "inline",
           "scale_gran": "per_channel"}
    assert space.why_invalid(cfg, prefill) == "registers"
    assert space.is_valid(dict(cfg, dequant="epilogue"), prefill)
    assert space.why_invalid(dict(cfg, dequant="epilogue", split_k=2),
                             prefill) == "tile"
    assert mm8_kernel.smem_bytes(128, 256, 128) == 2 * 384 * 144
    assert mm8_kernel.wgmma_smem_bytes(128, 256, 4) == 1280 + 4 * 128 * 384
    heur = ops.MATMUL_W8A8.default_config(ctx)
    assert heur in valid and heur["dequant"] == "epilogue"
    assert heur["split_k"] == 4
    # bytes and bounds of the serving GEMMs (PERF.md row 4)
    want_bytes = [50946080, 25341984, 331431936, 109080576]
    want_ms = [50946080 / 3.35e9, 25341984 / 3.35e9,
               2 * 4096 * 3072 * 16384 / 1979e9,
               2 * 4096 * 8192 * 3072 / 1979e9]
    for (M, K, N), nbytes, ms in zip(W8A8_SERVING, want_bytes, want_ms):
        assert ops.matmul_w8a8_bytes(M, K, N, "per_channel") == \
            M * K + K * N + 4 * M * N + 4 * (M + N) == nbytes
        w = ops.MATMUL_W8A8.workload_fn(
            heur, ops.matmul_w8a8_context(H100_SXM, M, K, N))
        assert w.flops == 2 * M * K * N and w.dtype == "int8"
        t, by = roofline_seconds(w, H100_SXM)
        assert by == ("bytes" if M == 8 else "operations")
        assert t * 1e3 == pytest.approx(ms)
    assert ops.matmul_w8a8_bytes(8, 64, 32, "per_tensor") == \
        8 * 64 + 64 * 32 + 4 * 8 * 32 + 8
    # decode's 8 rows at K 200 (mma.sync) clamp every block_m to 16: 16
    # programs of 86
    ragged = ops.matmul_w8a8_context(H100_SXM, 8, 200, 96)
    rvalid = space.valid_configs(ragged)
    canon = {tuple(sorted(ops._w8a8_canonical(c, ragged).items()))
             for c in rvalid}
    assert len(rvalid) == 86 and len(canon) == 16
    assert {dict(c)["block_m"] for c in canon} == {16}
    backend = _FakeBackend(lambda c: 1.0 + c["block_k"])
    entry = Autotuner(backend=backend).tune(ops.MATMUL_W8A8, ragged)
    assert backend.calls == len(canon) < entry.n_evaluated == 86
    assert mm8_kernel.clamp_blocks(128, 256, 128, 100, 96, 200) == \
        (128, 128, 128)
    assert mm8_kernel.clamp_blocks(64, 256, 128, 8, 3072, 16) == \
        (16, 256, 32)
    assert mm8_kernel.clamp_blocks(64, 256, 128, 8, 3072, 16, "wgmma") == \
        (8, 128, 128)


def test_matmul_w8a8_operands_and_the_scale_gran_pin(monkeypatch):
    """Operands at the config's granularity, w K-major; the operands pin
    scale_gran (a deployment sweep without the pin takes both); the
    dispatch key and the context are the weight scale's granularity and
    dtype "int8", so per-channel and per-tensor operands tune apart."""
    free = TuningContext(chip=H100_SXM, shapes={"x": (64, 96), "y": (96, 32)},
                         dtype="int8")
    space = ops.MATMUL_W8A8.space
    grans = {c["scale_gran"] for c in space.valid_configs(free)}
    assert grans == {"per_channel", "per_tensor"}
    pinned = ops.matmul_w8a8_context(H100_SXM, 64, 96, 32, "per_tensor")
    valid = space.valid_configs(pinned)
    assert {c["scale_gran"] for c in valid} == {"per_tensor"}
    assert space.why_invalid(dict(valid[0], scale_gran="per_channel"),
                             pinned) == "scale_gran==operands"
    assert ops.MATMUL_W8A8.default_config(pinned)["scale_gran"] == \
        "per_tensor"
    for gran, n in (("per_channel", None), ("per_tensor", 1)):
        (x, w, xs, ws), kw = ops._w8a8_operands(
            free, {"scale_gran": gran}, "cpu")
        assert not kw and x.dtype == w.dtype == torch.int8
        assert x.shape == (64, 96) and w.shape == (96, 32)
        assert w.stride() == (1, 96) and x.is_contiguous()
        assert xs.numel() == (n or 64) and ws.numel() == (n or 32)
        assert int(x.abs().max()) == int(w.abs().max()) == 127
    monkeypatch.setattr(ops, "device_chip", lambda index: H100_SXM)
    seen = []

    class Recording(Autotuner):
        def dispatch_config(self, kernel, key, make_ctx):
            seen.append((key, make_ctx()))
            return super().dispatch_config(kernel, key, make_ctx)

    class FakeCuda:
        """Only what the config resolution reads off a tensor."""

        def __init__(self, *shape):
            self.shape = shape
            self.is_cuda = True
            self.device = torch.device("cuda", 0)

    calls = []
    monkeypatch.setattr(ops.mm8_kernel, "matmul_w8a8",
                        lambda *a, **k: calls.append(k))
    tuner = Recording(backend=_FakeBackend(lambda c: 1.0),
                      on_miss="heuristic")
    x, w = FakeCuda(8, 96), FakeCuda(96, 32)
    for ws in (torch.ones(1, 32), torch.ones(1, 1)):
        ops.matmul_w8a8(x, w, torch.ones(8, 1), ws, tuner=tuner)
    (k_ch, c_ch), (k_t, c_t) = seen
    assert k_ch != k_t and c_ch.signature() != c_t.signature()
    assert c_ch.dtype == c_t.dtype == "int8"
    assert c_ch.extra == {"scale_gran": "per_channel"}
    assert c_t.extra == {"scale_gran": "per_tensor"}
    assert [k["scale_gran"] for k in calls] == ["per_channel", "per_tensor"]
    # a config handed in takes the operands' granularity where it names
    # none, and no lookup is made
    ops.matmul_w8a8(x, w, torch.ones(8, 1), torch.ones(1, 1),
                    config={"block_m": 16, "block_n": 64, "block_k": 64,
                            "num_warps": 4, "dequant": "inline"},
                    tuner=tuner)
    assert calls[-1]["scale_gran"] == "per_tensor" and len(seen) == 2


def test_flash_attention_space_workload_and_bound():
    """flash_attention's Hopper space (version 2): at the serving prefill
    (B 8, 24/8 heads of 128, 512 tokens, bf16) 10 valid configs of the
    wgmma kernel (a consumer warpgroup per 64 rows, 64- or 128-key tiles,
    2-4 stages), each within shared memory and the registers the source
    instantiates; the byte bound of 0.0201 ms and 12.91 GFLOP the causal
    mask admits (PERF.md row 9); f32 (one warp per 16 or 32 rows, two
    stages) and D 96, 120, 160 and 256 contexts; blocks past short
    sequences pruned down to the dtype's smallest tile."""
    from repro_torch.kernels import flash_attention as fa_kernel
    space = ops.FLASH_ATTENTION.space
    assert space.version == ops.FLASH_ATTENTION.version == 2
    ctx = ops.attention_context(H100_SXM, 8, 24, 8, 512, 512, 128,
                                "bfloat16")
    assert ctx.extra == {"causal": True, "window": 0}
    valid = space.valid_configs(ctx)
    assert valid == _valid_by_brute_force(space, ctx)
    assert len(valid) == 10
    for c in valid:
        assert ops._flash_smem(c, ctx) <= H100_SXM.smem_per_block
        assert fa_kernel.regs_fit(128, c["block_q"], c["block_kv"],
                                  c["num_warps"], 2)
        assert c["num_warps"] == c["block_q"] // 16
    assert {c["block_kv"] for c in valid} == {64, 128}
    assert {c["num_stages"] for c in valid} == {2, 3, 4}
    heur = ops.FLASH_ATTENTION.default_config(ctx)
    assert heur == {"block_q": 128, "block_kv": 128, "num_warps": 8,
                    "num_stages": 2}
    assert space.why_invalid(dict(heur, num_stages=4), ctx) == "smem"
    assert space.why_invalid(dict(heur, num_warps=4), ctx) == "registers"
    assert space.why_invalid(dict(heur, block_kv=32), ctx) == "registers"
    assert fa_kernel.smem_bytes(128, 2, 128, 128, 3) == \
        1280 + 2 * 128 * (128 + 6 * 128) == 230656
    assert fa_kernel.smem_bytes(128, 4, 64, 64) == (64 + 256) * 528
    assert fa_kernel.smem_bytes(120, 4, 16, 32) == (16 + 128) * 528
    w = ops.FLASH_ATTENTION.workload_fn(heur, ctx)
    assert w.hbm_bytes == ops.flash_attention_bytes(8, 24, 8, 512, 512, 128,
                                                    2) == 67502080
    assert ops.attention_pairs(512, 512, True) == 512 * 513 // 2
    assert w.flops == 4 * 8 * 24 * 128 * 131328 == 12910067712
    t, by = roofline_seconds(w, H100_SXM)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.0201498, rel=1e-5)
    # the registry's f32 s512 case, the head dims of phi3-mini (96) and
    # h2o-danube (120), unpadded, stablelm's 160 and 256 (64-key tiles
    # only: the o accumulators leave no room for 128)
    for shapes, dtype, n in (((1, 4, 512, 128, 1), "float32", 11),
                             ((8, 32, 512, 96, 32), "bfloat16", 10),
                             ((2, 32, 300, 120, 8), "bfloat16", 10),
                             ((8, 32, 4096, 160, 8), "bfloat16", 5),
                             ((1, 8, 64, 256, 8), "float32", 3),
                             ((1, 8, 512, 256, 8), "bfloat16", 3)):
        B, Hq, S, D, Hkv = shapes
        c2 = ops.attention_context(H100_SXM, B, Hq, Hkv, S, S, D, dtype)
        got = space.valid_configs(c2)
        assert len(got) == n, (shapes, dtype, got)
        assert got == _valid_by_brute_force(space, c2)
        assert ops.FLASH_ATTENTION.default_config(c2) in got
        if dtype == "float32":
            assert {c["num_stages"] for c in got} == {2}
    short = ops.attention_context(H100_SXM, 1, 4, 1, 20, 40, 64, "float32",
                                  window=8)
    assert short.extra == {"causal": True, "window": 8}
    assert {(c["block_q"], c["block_kv"])
            for c in space.valid_configs(short)} <= {(16, 32), (16, 64),
                                                     (32, 32), (32, 64)}
    short16 = ops.attention_context(H100_SXM, 1, 4, 1, 20, 40, 64,
                                    "bfloat16", window=8)
    assert {(c["block_q"], c["block_kv"])
            for c in space.valid_configs(short16)} == {(64, 64)}


@pytest.mark.parametrize("Sq,Skv,causal,window,q_offset", [
    (512, 512, True, None, 0), (200, 333, True, 100, 0),
    (77, 300, True, None, 211), (64, 40, True, 8, 40),
    (30, 50, False, 7, 5), (40, 24, False, None, 0)])
def test_attention_pairs_count_the_mask(Sq, Skv, causal, window, q_offset):
    """The operations a call needs count exactly the (query, key) pairs
    the plain version's mask admits."""
    from repro_torch.kernels import ref
    mask = ref._attn_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=None, device="cpu")
    assert ops.attention_pairs(Sq, Skv, causal, window, q_offset) == \
        int(mask.sum())


def test_attention_dispatch_key_and_context(monkeypatch):
    """The dispatch key and the tuning context carry the dtype, the mask
    and the shapes, so a window or a dtype tunes apart; a config handed in
    makes no lookup; CPU tensors make none either."""
    monkeypatch.setattr(ops, "device_chip", lambda index: H100_SXM)
    seen = []

    class Recording(Autotuner):
        def dispatch_config(self, kernel, key, make_ctx):
            seen.append((key, make_ctx()))
            return super().dispatch_config(kernel, key, make_ctx)

    class FakeCuda:
        """Only what the config resolution reads off a tensor."""

        def __init__(self, *shape, dtype=torch.bfloat16):
            self.shape, self.dtype = shape, dtype
            self.is_cuda = True
            self.device = torch.device("cuda", 0)

    calls = []
    monkeypatch.setattr(ops.fa_kernel, "flash_attention",
                        lambda *a, **k: calls.append(k))
    tuner = Recording(backend=_FakeBackend(lambda c: 1.0),
                      on_miss="heuristic")
    k = FakeCuda(2, 2, 48, 64)
    for q, window in ((FakeCuda(2, 4, 48, 64), None),
                      (FakeCuda(2, 4, 48, 64), 16),
                      (FakeCuda(2, 4, 48, 64, dtype=torch.float32), None)):
        ops.attention(q, k, k, window=window, tuner=tuner)
    keys = [key for key, _ in seen]
    assert len(set(keys)) == 3 and len({c.signature() for _, c in seen}) == 3
    (_, c0), (_, c1), (_, c2) = seen
    assert c0.shapes == {"q": (2, 4, 48, 64), "k": (2, 2, 48, 64)}
    assert c0.extra == {"causal": True, "window": 0}
    assert c1.extra == {"causal": True, "window": 16}
    assert c2.dtype == "float32" and c0.dtype == "bfloat16"
    assert all(set(kw) >= {"block_q", "block_kv", "num_warps", "window",
                           "causal", "q_offset", "return_lse"}
               for kw in calls)
    ops.attention(FakeCuda(2, 4, 48, 64), k, k, tuner=tuner,
                  config={"block_q": 16, "block_kv": 32, "num_warps": 1})
    assert len(seen) == 3 and calls[-1]["block_q"] == 16
    monkeypatch.undo()
    cpu = Autotuner(backend=_FakeBackend(lambda c: 1.0), on_miss="error")
    out = ops.attention(torch.randn(1, 2, 8, 16), torch.randn(1, 1, 8, 16),
                        torch.randn(1, 1, 8, 16), tuner=cpu)
    assert out.shape == (1, 2, 8, 16) and cpu.stats()["misses"] == 0


def test_mla_decode_space_workload_and_bound():
    """mla_decode's Hopper space: at deepseek-v2-lite's serving decode (B 8,
    H 16, C 512, R 64, T 544, bf16) 30 valid configs, each within shared
    memory (two stages of block_kv rows of C + R: 128 rows do not fit) and
    the reference's splits<=blocks; 22 in f32; the registry's cases; the
    byte bound of 1.575 us at every request at 528 keys (PERF.md row 8),
    the workload's partials, the block clamp and the splits' span."""
    from repro_torch.kernels import mla_decode as mla_kernel
    space = ops.MLA_DECODE.space
    ctx = ops.mla_decode_context(H100_SXM, 8, 16, 512, 64, 544, "bfloat16")
    valid = space.valid_configs(ctx)
    assert valid == _valid_by_brute_force(space, ctx)
    assert len(valid) == 30
    assert {c["block_kv"] for c in valid} == {16, 32, 64}
    for c in valid:
        assert ops._mla_smem(c, ctx) <= H100_SXM.smem_per_block
        assert c["k_splits"] <= -(-544 // c["block_kv"])
    heur = ops.MLA_DECODE.default_config(ctx)
    assert heur == {"block_kv": 64, "k_splits": 1, "num_warps": 4}
    assert space.why_invalid(dict(heur, block_kv=128), ctx) == "smem"
    assert space.why_invalid(dict(heur, k_splits=16), ctx) == \
        "splits<=blocks"
    assert mla_kernel.smem_bytes(576, 2, 64, 8) == \
        (16 + 128) * 1168 + 9 * 16 * 72 * 4 + 192 == 209856
    for shapes, dtype, n, bk in (((8, 16, 512, 64, 544), "float32", 22, 32),
                                 ((2, 4, 256, 64, 1024), "float32", 34, 64),
                                 ((8, 16, 512, 64, 32768), "bfloat16", 36,
                                  64),
                                 ((2, 4, 32, 8, 40), "float32", 12, 128)):
        c2 = ops.mla_decode_context(H100_SXM, *shapes, dtype)
        got = space.valid_configs(c2)
        assert len(got) == n, (shapes, dtype)
        assert got == _valid_by_brute_force(space, c2)
        assert ops.MLA_DECODE.default_config(c2)["block_kv"] == bk
    w = ops.MLA_DECODE.workload_fn(heur, ctx)
    assert w.flops == 2 * 16 * 8 * 544 * (2 * 512 + 64)
    assert w.hbm_bytes == (8 * 544 + 8 * 16) * 576 * 2 + 4 * 8 * 16 * 512 \
        + 4 * 8 + 4 * 8 * 16
    split = ops.MLA_DECODE.workload_fn(dict(heur, k_splits=8), ctx)
    assert split.hbm_bytes - w.hbm_bytes == 2 * 4 * 8 * 8 * 16 * 513 \
        - 4 * 8 * 16
    served = KernelWorkload(ops.mla_decode_flops(16, 512, 64, 8 * 528),
                            ops.mla_decode_bytes(8, 16, 512, 64, 8 * 528, 2),
                            "bfloat16")
    assert served.hbm_bytes == 5275680
    t, by = roofline_seconds(served, H100_SXM)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.00157483, rel=1e-5)
    # the block the kernel stages, and the keys a split covers
    assert mla_kernel.clamp_block_kv(128, 40) == 64
    assert mla_kernel.clamp_block_kv(32, 16) == 16
    assert mla_kernel.clamp_block_kv(64, 544) == 64
    small = ops.mla_decode_context(H100_SXM, 2, 4, 32, 8, 40, "float32")
    assert ops.MLA_DECODE.canonicalize(dict(heur, block_kv=128), small) == \
        dict(heur, block_kv=64)
    assert mla_kernel.split_span(544, 64, 8) == 128
    assert mla_kernel.split_span(544, 16, 32) == 32
    assert mla_kernel.split_span(200, 128, 2) == 128


def test_latent_decode_dispatch_key_and_context(monkeypatch):
    """The dispatch key and the tuning context carry the dtype and the
    shapes (a longer cache tunes apart); a config handed in makes no
    lookup; CPU tensors make none either; the launcher's MLA context is
    the decode step's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    monkeypatch.setattr(ops, "device_chip", lambda index: H100_SXM)
    seen = []

    class Recording(Autotuner):
        def dispatch_config(self, kernel, key, make_ctx):
            seen.append((key, make_ctx()))
            return super().dispatch_config(kernel, key, make_ctx)

    class FakeCuda:
        """Only what the config resolution reads off a tensor."""

        def __init__(self, *shape, dtype=torch.bfloat16):
            self.shape, self.dtype = shape, dtype
            self.is_cuda = True
            self.device = torch.device("cuda", 0)

    calls = []
    monkeypatch.setattr(ops.mla_kernel, "mla_decode",
                        lambda *a, **k: calls.append(k))
    tuner = Recording(backend=_FakeBackend(lambda c: 1.0),
                      on_miss="heuristic")
    for T, dtype in ((544, torch.bfloat16), (1024, torch.bfloat16),
                     (544, torch.float32)):
        ops.latent_decode(FakeCuda(8, 16, 512, dtype=dtype),
                          FakeCuda(8, 16, 64, dtype=dtype),
                          FakeCuda(8, T, 512, dtype=dtype),
                          FakeCuda(8, T, 64, dtype=dtype), tuner=tuner)
    keys = [key for key, _ in seen]
    assert len(set(keys)) == 3 and len({c.signature() for _, c in seen}) == 3
    (_, c0), (_, c1), (_, c2) = seen
    assert c0.shapes == {"q_abs": (8, 16, 512), "q_rope": (8, 16, 64),
                         "ckv": (8, 544, 512), "krope": (8, 544, 64)}
    assert c1.shapes["ckv"] == (8, 1024, 512)
    assert c2.dtype == "float32" and c0.dtype == "bfloat16"
    assert all(set(kw) >= {"block_kv", "k_splits", "num_warps", "kv_len",
                           "scale"} for kw in calls)
    ops.latent_decode(*(FakeCuda(8, 16, 512),) * 4, tuner=tuner,
                      config={"block_kv": 16, "k_splits": 4,
                              "num_warps": 8})
    assert len(seen) == 3 and calls[-1]["k_splits"] == 4
    cfg = get_config("deepseek-v2-lite-16b")
    kernel, ctx = serve.decode_context(cfg, 8, 544, torch.device("cuda"))
    assert kernel is ops.MLA_DECODE and ctx.signature() == c0.signature()
    monkeypatch.undo()
    cpu = Autotuner(backend=_FakeBackend(lambda c: 1.0), on_miss="error")
    out = ops.latent_decode(torch.randn(1, 4, 32), torch.randn(1, 4, 8),
                            torch.randn(1, 6, 32), torch.randn(1, 6, 8),
                            tuner=cpu)
    assert out.shape == (1, 4, 32) and cpu.stats()["misses"] == 0
