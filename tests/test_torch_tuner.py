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
            assert c["block_kv"] % c["page_size"] == 0
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
    # 256 bf16 rows of 128 stage 256 KB: over the 227 KB a block may use
    big = {"page_size": 16, "block_kv": 256, "pack_gqa": True, "num_warps": 4}
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
            assert c["block_kv"] % c["page_size"] == 0
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
           "num_warps": 4}
    assert space.why_invalid(big, deploy) == "smem"
    ok = {"draft_k": 4, "page_size": 128, "block_kv": 128, "pack_gqa": True,
          "num_warps": 4}
    assert space.is_valid(ok, pinned)
    assert space.why_invalid(dict(ok, page_size=16), pinned) == \
        "page_size==pool"
    assert space.why_invalid(dict(ok, draft_k=3), pinned) == \
        "draft_k==request"


def test_verify_smem_bytes_and_workload():
    # staging of 64 bf16 rows of 128, then 12 query rows (K 4, group 3)
    # in bf16 and their f32 accumulators and (m, l): one warp a row
    assert pv_kernel.smem_bytes(128, 2, 64, 4, 3, True, 8) == (
        4 * 64 * 128 * 2 + 12 * 128 * 2 + 12 * (128 + 2) * 4)
    # 4 rows (unpacked) and 8 warps: two warps split each row's keys, so
    # each row keeps two running states
    assert pv_kernel.key_splits(4, 8) == 2 and pv_kernel.key_splits(4, 4) == 1
    assert pv_kernel.smem_bytes(128, 2, 64, 4, 3, False, 8) == (
        4 * 64 * 128 * 2 + 4 * 128 * 2 + 8 * (128 + 2) * 4)
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
           "num_warps": 4}
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
    # double-buffered K and V staging dominates at 64 bf16 rows of 128
    assert pd_kernel.smem_bytes(128, 2, 64, 3, True, 4) == 4 * 64 * 128 * 2
    # the row-group merge dominates with tiny staging and many warps
    n_rg = 8 * 32 // 16
    assert pd_kernel.smem_bytes(128, 2, 16, 3, True, 8) == max(
        4 * 16 * 128 * 2, n_rg * 3 * 130 * 4)


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
