"""The port's shipped H100 tuning DB and the read-only overlay that serves
it, the counterpart of ``tests/test_shipped_db.py``.

The committed ``src/repro_torch/configs/shipped_tuning_db.json`` (written
on the card by ``python -m repro_torch.configs.gen_shipped_db``) loads, is
not tiny, and every entry parses against the current spaces — kernel,
version, space hash, a config valid for the context rebuilt from its key
through ``core.get_chip``, the signature round trip — and names an H100.
The serve launcher's deployment lookups of every arch the port pages
(plain, ``--speculative``, under ``--quant kv8`` and both) and the
``mm8k`` matmul rebuild shipped keys; the generator's scenarios equal the
contexts the runtime's own functions give, and are exactly the DB's keys. The
overlay is read-only and comes after the process's own entries, under its
own environment rule. ``registry.tuning_pairs`` labels equal the
reference's, and ``warm_start`` tunes them over a stub backend. All on the
CPU; a fresh ``default_tuner()`` hitting the DB on the card is in
``tests/test_torch_gpu.py``.
"""

import dataclasses
import hashlib
import json
import math
import pathlib
import re
import zlib

import pytest
import torch

from repro.core import get_chip as jax_get_chip
from repro.kernels import registry as jreg

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import gen_shipped_db as gen
from repro_torch.core import (
    Autotuner, TuningCache, TuningContext, cpu_host, get_chip,
    set_default_tuner,
)
from repro_torch.core import cache as cache_lib
from repro_torch.core import tuner as tuner_lib
from repro_torch.kernels import ops, registry
from repro_torch.launch import serve

PAGED_ARCHS = ["phi4-mini-3.8b", "phi3-mini-3.8b", "stablelm-12b"]


@pytest.fixture(scope="module")
def db():
    with open(tuner_lib.SHIPPED_DB) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def chip(db):
    """The card the DB was tuned on, rebuilt from its keys' chip name."""
    names = {json.loads(json.loads(k)["ctx"])["chip"] for k in db}
    assert len(names) == 1, names
    return get_chip(names.pop())


def _parse_key(key):
    k = json.loads(key)
    c = json.loads(k["ctx"])
    ctx = TuningContext(chip=get_chip(c["chip"]),
                        shapes={n: tuple(v) for n, v in c["shapes"].items()},
                        dtype=c["dtype"], extra=c["extra"])
    return k, ctx


def _key(name, ctx):
    t = registry.get_kernel(name).tunable
    return cache_lib.cache_key(t.name, t.version, t.space, ctx)


def test_shipped_db_loads_and_is_not_tiny(db):
    assert len(db) >= 30
    kernels = {json.loads(k)["kernel"] for k in db}
    assert kernels == set(registry.kernel_names()) - {"flash_attention_bwd"}
    for raw in db.values():
        entry = cache_lib.CacheEntry.from_json(raw)
        assert math.isfinite(entry.metric) and entry.metric > 0
        assert entry.n_evaluated > 0 and entry.strategy == "exhaustive"


def test_every_entry_parses_against_the_current_spaces(db):
    for key, raw in db.items():
        k, ctx = _parse_key(key)
        tunable = registry.get_kernel(k["kernel"]).tunable
        assert k["kernel_version"] == tunable.version, key
        assert k["space"] == tunable.space.space_hash(), key
        assert ctx.signature() == k["ctx"], key
        assert _key(k["kernel"], ctx) == key
        entry = cache_lib.CacheEntry.from_json(raw)
        assert tunable.space.is_valid(entry.config, ctx), (key, entry.config)
        assert "H100" in ctx.chip.name and "H100" in entry.fingerprint["gpu"]
        assert ctx.chip.name.startswith(entry.fingerprint["gpu"])
        assert entry.fingerprint["backend"] == "cuda_events"


# Each registered kernel's version, its sources (relative to
# src/repro_torch; a CUDA source's quoted #includes are followed) and their
# sha256 (``_sources_digest``). A shipped key holds the kernel's version,
# not its code, so an edit to a kernel that leaves its version alone would
# keep serving the winner tuned for the old code. Editing a source fails
# ``test_kernel_versions_track_their_sources`` until the row is updated:
# bump the version and regenerate that kernel's entries
# (``gen_shipped_db --kernels NAME``), or, for an edit that cannot change
# which config wins (a comment), update the digest alone.
KERNEL_SOURCES = {
    "decode_attention": (3, ("csrc/gqa_decode.cu",), "93f24af3d786d271"),
    "flash_attention": (2, ("csrc/flash_attention.cu",), "077db1659d4c7cc7"),
    "flash_attention_bwd": (2, ("csrc/flash_attention_bwd.cu",),
                            "e30dcb0c97bd53a2"),
    "gqa_decode_kv8": (1, ("csrc/gqa_decode_kv8.cu",), "119b40526bc0644d"),
    "gqa_decode_ragged": (2, ("csrc/gqa_decode.cu",), "93f24af3d786d271"),
    "matmul": (2, ("csrc/matmul.cu",), "68f21caaa118627a"),
    "matmul_w8a8": (2, ("csrc/matmul_w8a8.cu",), "a4952bcb68e9f36b"),
    "mla_decode": (1, ("csrc/mla_decode.cu",), "19cece73424a9f20"),
    "paged_decode": (2, ("csrc/paged_decode.cu",), "a825b751267cc3e2"),
    "paged_verify": (2, ("csrc/paged_verify.cu",), "c0a2209aa61086eb"),
    "rms_norm": (1, ("kernels/rms_norm.py",), "2c72f964811bb574"),
}

PORT_DIR = pathlib.Path(tuner_lib.__file__).resolve().parents[1]


def _sources_digest(paths):
    """sha256 of the files and the headers they include, in path order."""
    todo, seen = list(paths), set()
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.add(rel)
        text = (PORT_DIR / rel).read_text()
        todo += [str(pathlib.PurePosixPath(rel).parent / inc) for inc in
                 re.findall(r'^#include "([^"]+)"', text, re.M)]
    h = hashlib.sha256()
    for rel in sorted(seen):
        h.update(rel.encode() + b"\0" + (PORT_DIR / rel).read_bytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(KERNEL_SOURCES))
def test_kernel_versions_track_their_sources(name):
    version, paths, digest = KERNEL_SOURCES[name]
    assert registry.get_kernel(name).tunable.version == version, name
    assert _sources_digest(paths) == digest, (
        f"{name}'s sources changed: bump its version and regenerate its "
        f"shipped entries, or update the digest if no winner can change")


def test_every_registered_kernel_has_its_sources_tracked():
    assert set(KERNEL_SOURCES) == set(registry.kernel_names())


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_deployment_lookups_rebuild_a_shipped_key(db, chip, arch):
    """What ``serve.prepare`` looks up before it lays out the pool, for
    plain, --speculative, --quant kv8 and both, is shipped: a fresh
    launcher tunes none of it."""
    full = get_config(arch)
    for quant in (None, "kv8"):
        ctx = serve.deployment_context(full, chip, quant)
        assert ctx.extra.get("q_dtype", gen.SHIP_DTYPE) == gen.SHIP_DTYPE
        assert ctx.shapes == gen.paged_deployment_shapes(full)
        entry = db[_key("paged_decode", ctx)]
        assert entry["config"]["page_size"] in ops.PAGE_SIZES
        vctx = serve.verify_deployment_context(full, chip, quant)
        entry = db[_key("paged_verify", vctx)]
        assert entry["config"]["draft_k"] >= 2


def test_mm8k_is_shipped(db, chip):
    (case,) = [c for c in registry.get_kernel("matmul").bench_cases
               if c.label == "mm8k"]
    ctx = ops.matmul_context(chip, 8192, 8192, 8192, "bfloat16")
    assert ctx.signature() == case.context(chip).signature()
    assert _key("matmul", ctx) in db


def test_scenarios_are_the_runtime_lookups_and_the_db(db, chip,
                                                      monkeypatch):
    """Each scenario's context is the one the runtime's function gives (the
    dense path's functions read the card through ``ops.device_chip``,
    pointed at the DB's card here), and the scenarios' keys are exactly
    the DB's."""
    assert [a for a in ARCHS if gen._pages(get_config(a))] == PAGED_ARCHS
    monkeypatch.setattr(ops, "device_chip", lambda index: chip)
    dev = torch.device("cpu")
    B, T = gen.DEPLOY_BATCH, gen.DEPLOY_TOKENS
    scen = list(gen.scenarios(chip))
    want = []
    for arch in ARCHS:
        cfg = get_config(arch)
        if cfg.mla is None:
            for b, s in ((8, 4096), (1, 32768)):
                want.append(serve.flash_context(cfg, b, s, dev))
            want.append((ops.DECODE_ATTENTION, ops.decode_attention_context(
                chip, B, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, T,
                cfg.dtype)))
            want.append(serve.dense_context(cfg, B, T, dev))
            want.append(serve.dense_context(cfg, B, T, dev, "kv8"))
        if arch in PAGED_ARCHS:
            for quant in (None, "kv8"):
                want.append((ops.PAGED_DECODE,
                             serve.deployment_context(cfg, chip, quant)))
                want.append((ops.PAGED_VERIFY,
                             serve.verify_deployment_context(cfg, chip,
                                                             quant)))
        if cfg.mla is not None:
            want.append(serve.mla_context(cfg, B, T, dev))
        want.append((ops.RMS_NORM, ops.rmsnorm_context(
            chip, (8192, cfg.d_model), cfg.dtype)))
    mm8k = registry.get_kernel("matmul").bench_cases[1]
    want.append((ops.MATMUL, mm8k.context(chip)))
    want += [(ops.MATMUL_W8A8, ops.matmul_w8a8_context(chip, M, K, N))
             for M, K, N in ((8192, 8192, 8192), (512, 4096, 4096))]
    assert [(n, c.signature()) for n, c in scen] == \
        [(k.name, c.signature()) for k, c in want]
    # phi3-mini shares phi4-mini's rms_norm scenario, deepseek olmoe's
    assert {_key(n, c) for n, c in scen} == set(db)
    assert len(scen) == len(db) + 2


def _entry(config, fingerprint):
    e = cache_lib.make_entry(config, 2e-6, 3, "exhaustive", "cuda_events")
    return dataclasses.replace(e, fingerprint=dict(e.fingerprint,
                                                   **fingerprint))


def test_overlay_is_read_only_and_comes_after_own_entries(tmp_path):
    kernel = ops.RMS_NORM
    ctx = ops.rmsnorm_context(cpu_host(), (8, 64), "float32")
    env = cache_lib.env_fingerprint("cuda_events")
    shipped = _entry({"block_rows": 4, "num_warps": 8}, {})
    path = tmp_path / "shipped.json"
    key = cache_lib.cache_key(kernel.name, kernel.version, kernel.space, ctx)
    path.write_text(json.dumps({key: shipped.to_json()}))
    before = path.read_bytes()
    cache = TuningCache(overlay_path=str(path))
    assert len(cache) == 0 and set(cache.entries()) == {key}
    got = cache.get(kernel.name, kernel.version, kernel.space, ctx,
                    require_fingerprint=env)
    assert got.config == shipped.config
    own = _entry({"block_rows": 2, "num_warps": 4}, {})
    cache.put(kernel.name, kernel.version, kernel.space, ctx, own)
    got = cache.get(kernel.name, kernel.version, kernel.space, ctx,
                    require_fingerprint=env)
    assert got.config == own.config
    assert cache.entries()[key].config == own.config and len(cache) == 1
    assert path.read_bytes() == before
    # a missing overlay file is an empty overlay
    assert not TuningCache(overlay_path=str(tmp_path / "no.json")).entries()


def test_overlay_matches_the_card_and_backend_not_the_versions(tmp_path):
    """A version mismatch hits for an overlay entry (its card is in the key)
    and misses for an entry the process tuned; another backend misses
    for both."""
    kernel = ops.RMS_NORM
    ctx = ops.rmsnorm_context(cpu_host(), (8, 64), "float32")
    env = cache_lib.env_fingerprint("cuda_events")
    key = cache_lib.cache_key(kernel.name, kernel.version, kernel.space, ctx)
    cfg = {"block_rows": 4, "num_warps": 8}
    older = {"driver": "0.0", "cuda": "0.0", "torch": "0.0",
             "triton": "0.0"}
    for fields, hit in ((older, True), ({"backend": "fake"}, False)):
        path = tmp_path / f"{hit}.json"
        path.write_text(json.dumps({key: _entry(cfg, fields).to_json()}))
        overlay = TuningCache(overlay_path=str(path))
        got = overlay.get(kernel.name, kernel.version, kernel.space, ctx,
                          require_fingerprint=env)
        assert (got is not None) == hit
        own = TuningCache()
        own.put(kernel.name, kernel.version, kernel.space, ctx,
                _entry(cfg, fields))
        assert own.get(kernel.name, kernel.version, kernel.space, ctx,
                       require_fingerprint=env) is None
    # the stored config must still be valid for the context
    path = tmp_path / "invalid.json"
    path.write_text(json.dumps(
        {key: _entry({"block_rows": 3, "num_warps": 8}, {}).to_json()}))
    assert TuningCache(overlay_path=str(path)).get(
        kernel.name, kernel.version, kernel.space, ctx,
        require_fingerprint=env) is None


def test_default_tuner_reads_the_shipped_db(db):
    set_default_tuner(None)
    try:
        tuner = tuner_lib.default_tuner()
        assert set(tuner.cache.entries()) == set(db)
        assert len(tuner.cache) == 0
    finally:
        set_default_tuner(None)


@pytest.mark.parametrize("scale", [None, "host", "paper"])
def test_tuning_pairs_labels_equal_the_reference(scale):
    ours = registry.tuning_pairs(cpu_host(), scale=scale)
    theirs = jreg.tuning_pairs(jax_get_chip("tpu_v5e"), scale=scale)
    assert [label for label, _, _ in ours] == \
        [label for label, _, _ in theirs]
    for (label, tunable, ctx), (_, _, jctx) in zip(ours, theirs):
        assert tunable is registry.get_kernel(label.split("/")[0]).tunable
        assert ctx.chip == cpu_host()
        assert {k: tuple(v) for k, v in ctx.shapes.items()} == \
            {k: tuple(v) for k, v in jctx.shapes.items()}
        assert ctx.dtype == jctx.dtype and dict(ctx.extra) == \
            dict(jctx.extra)
    assert [label for label, _, _ in registry.tuning_pairs(
        cpu_host(), scenario="training")] == \
        [label for label, _, _ in jreg.tuning_pairs(
            jax_get_chip("tpu_v5e"), scenario="training")]


class _StubBackend:
    """Synthetic timing: a function of the config's values; a kernel named
    in ``fail`` raises."""

    name = "stub"

    def __init__(self, fail=()):
        self.fail = fail

    def evaluator(self, kernel, ctx):
        if kernel.name in self.fail:
            raise RuntimeError(f"{kernel.name} does not run here")

        def evaluate(cfg):
            return 1e-6 * (1 + zlib.crc32(repr(sorted(cfg.items()))
                                          .encode()) % 997)
        return evaluate


def test_warm_start_tunes_every_bench_case_over_a_stub_backend():
    tuner = Autotuner(backend=_StubBackend(), on_miss="error")
    out = registry.warm_start(tuner, cpu_host(), scale="host")
    pairs = registry.tuning_pairs(cpu_host(), scale="host")
    assert list(out) == [label for label, _, _ in pairs]
    for (label, tunable, ctx) in pairs:
        entry = out[label]
        assert isinstance(entry, cache_lib.CacheEntry), (label, entry)
        assert math.isfinite(entry.metric)
        assert tunable.space.is_valid(entry.config, ctx)
        assert tuner.best_config(tunable, ctx) == entry.config
    assert tuner.stats()["tunes"] == len(pairs)
    assert tuner.stats()["hits"] == len(pairs)


def test_tune_many_aligns_results_and_returns_exceptions():
    tuner = Autotuner(backend=_StubBackend(fail=("rms_norm",)))
    items = [(ops.RMS_NORM, ops.rmsnorm_context(cpu_host(), (8, 64),
                                                "float32")),
             (ops.MATMUL, ops.matmul_context(cpu_host(), 64, 64, 64,
                                             "float32"))]
    rms, mm = tuner.tune_many(items, return_exceptions=True)
    assert isinstance(rms, RuntimeError)
    assert isinstance(mm, cache_lib.CacheEntry)
    assert mm.config == tuner.best_config(*items[1])
    with pytest.raises(RuntimeError, match="does not run here"):
        tuner.tune_many(items)
