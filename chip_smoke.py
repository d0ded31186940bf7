#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository around it; builds every kernel from
the sources in the checkout and never imports JAX or the JAX package.
Phases, each failing loudly:

  1. the card (``nvidia-smi`` name and power limit) and tool versions;
  2. the build of both kernels, started together: ``nvcc`` for the CUDA
     ``paged_decode`` and the Triton compile of ``rms_norm``;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes, for every valid config of its space, with its time, the
     plain version's, a yardstick library call's and the roofline bound;
  4. tuning: the serve entry point's deployment lookup and the contexts the
     engine will dispatch, tuned on the card; then every valid
     ``paged_decode`` config at the pool layout the tuning chose (the
     tuned one among them) against the plain version;
  5. serving phi4-mini-3.8b at full width (32 layers, bf16, random weights
     from a seed): 8 requests of 128-512 prompt tokens and 32 new tokens,
     prefill chunks of 256, with both kernels' launch counts read around
     the run;
  6. one full-width decode step through the kernels against the same step
     through the plain versions on the same cache, and a profiled window of
     decode steps (wall time, device time, device busy share);
  7. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import argparse
import functools
import importlib.metadata
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 2e-2
F32_TOL = 1e-4


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def versions() -> dict:
    from repro_torch.kernels import paged_decode as pd_kernel
    nvcc = subprocess.run([pd_kernel._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "none"
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "triton": triton,
            "nvcc": nvcc.stdout.strip().splitlines()[-1]}


def build_kernels() -> dict:
    """nvcc for the CUDA kernel and Triton's compile of rms_norm (on its
    first launch), started together; returns seconds per build."""
    from repro_torch.kernels import paged_decode as pd_kernel
    from repro_torch.kernels import rms_norm as rms_kernel
    secs, errors = {}, []

    def nvcc():
        t = time.perf_counter()
        try:
            pd_kernel._load()
        except Exception as e:          # noqa: BLE001 — re-raised below
            errors.append(e)
        secs["paged_decode"] = time.perf_counter() - t

    t0 = time.perf_counter()
    th = threading.Thread(target=nvcc)
    th.start()
    x = torch.ones(8, 3072, device="cuda", dtype=torch.bfloat16)
    rms_kernel.rms_norm(x, x[0])
    torch.cuda.synchronize()
    secs["rms_norm"] = time.perf_counter() - t0
    th.join()
    if errors:
        raise errors[0]
    lines = [ln for ln in pd_kernel.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"ptxas (16 paged_decode instantiations): "
          f"{max(int(ln.split('Used ')[1].split()[0]) for ln in lines if 'Used ' in ln)}"
          f" registers at most; spills: "
          f"{sorted({ln.strip() for ln in lines if 'spill' in ln})}")
    return secs


@functools.lru_cache(maxsize=1)
def timer():
    """One timer (and one L2-flush buffer) for every measurement here."""
    from repro_torch.core import CudaEventTimer
    return CudaEventTimer(reps=50, warmup=5)


def bound(workload, chip):
    from repro_torch.core import roofline_seconds
    t, by = roofline_seconds(workload, chip)
    return t * 1e3, by


def paged_case(seed, B, Hq, Hkv, D, ps, max_pages, kv_len, dtype):
    """Pool with page 0 as scratch and each sequence on shuffled pages."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_pages
    tables = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = tables.reshape(B, max_pages).copy()
    for b, n in enumerate(kv_len):
        tables[b, -(-min(max(n, 0), max_pages * ps) // ps):] = 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
    return (rand(B, Hq, D), rand(Hkv, n_pages, ps, D),
            rand(Hkv, n_pages, ps, D), torch.from_numpy(tables).cuda(),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"))


def time_paged_decode(chip, args, cfg, ps, max_pages) -> dict:
    """Kernel (under ``cfg``), plain version, library yardstick and the
    roofline bound for one input set; the bound counts the resident
    tokens these inputs have."""
    from repro_torch.core import KernelWorkload
    from repro_torch.kernels import ops, ref
    q, kp = args[0], args[1]
    B, Hq, D = q.shape
    cap = ps * max_pages
    kv_tokens = int(torch.clamp(args[4], 0, cap).sum())
    w = KernelWorkload(
        ops.paged_decode_flops(Hq, D, kv_tokens),
        ops.paged_decode_bytes(B, Hq, kp.shape[0], D, kv_tokens, max_pages,
                               q.element_size()),
        ops.dtype_name(q.dtype))
    bound_ms, by = bound(w, chip)
    return {"kernel_ms": timer().time_runner(
                lambda: ops.paged_decode(*args, config=cfg)) * 1e3,
            "plain_ms": timer().time_runner(
                lambda: ref.paged_decode(*args)) * 1e3,
            "library_ms": sdpa_ms(args, cap), "bound_ms": bound_ms,
            "bound_by": by, "kv_tokens": kv_tokens}


def ragged_lens(cap: int, group: int) -> list:
    """Eight lengths: empty, one past capacity, short, mid-page tails and
    near or at capacity."""
    if group > 1:
        return [0, cap + 1, 1, cap // 7, cap // 2 - 1, (5 * cap) // 7,
                (8 * cap) // 9 + 1, cap - 1]
    return [0, cap + 1, cap // 9, cap // 6, cap // 3 + 8, cap // 2,
            (8 * cap) // 9 - 1, cap]


def check_paged_layout(chip, name, args, ps, max_pages):
    """Every valid config of the context these inputs give, against the
    plain version on the same inputs; returns (context, configs checked,
    worst max abs error)."""
    from repro_torch.kernels import ops, ref
    q, kp = args[0], args[1]
    B, Hq, D = q.shape
    ctx = ops.paged_decode_context(chip, B, Hq, kp.shape[0], D,
                                   ps * max_pages, ops.dtype_name(q.dtype),
                                   ps)
    tol = BF16_TOL if q.dtype == torch.bfloat16 else F32_TOL
    want = ref.paged_decode(*args).float()
    configs = ops.PAGED_DECODE.space.valid_configs(ctx)
    if not configs:
        raise AssertionError(f"paged_decode {name}: no valid config")
    worst = 0.0
    for cfg in configs:
        got = ops.paged_decode(*args, config=cfg).float()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            raise AssertionError(f"paged_decode {name} {cfg}: max abs "
                                 f"err {err} over tolerance {tol}")
        worst = max(worst, err)
    print(f"paged_decode {name} (pages of {ps}, {max_pages} a table, "
          f"lengths {args[4].tolist()}): {len(configs)} configs ok, "
          f"max_abs_err {worst:.3g} (tol {tol})")
    return ctx, configs, worst


def check_paged_decode(chip) -> dict:
    """Every valid config against the plain version at pages of 16, on
    phi4-mini's heads (bf16 and f32 pools) and on phi3-mini's (group 1,
    D 96). The serving layout is checked in phase 4, once it is known."""
    from repro_torch.kernels import ops
    ps, max_pages = 16, 36
    cases = [("phi4-mini bf16", 8, 24, 8, 128, torch.bfloat16),
             ("phi4-mini f32", 8, 24, 8, 128, torch.float32),
             ("phi3-mini bf16", 8, 32, 32, 96, torch.bfloat16)]
    out = {"max_abs_err": 0.0}
    for name, B, Hq, Hkv, D, dtype in cases:
        args = paged_case(D, B, Hq, Hkv, D, ps, max_pages,
                          ragged_lens(ps * max_pages, Hq // Hkv), dtype)
        ctx, _, worst = check_paged_layout(chip, name, args, ps, max_pages)
        out["max_abs_err"] = max(out["max_abs_err"], worst)
        heur = ops.PAGED_DECODE.default_config(ctx)
        tm = time_paged_decode(chip, args, heur, ps, max_pages)
        print(f"  heuristic {heur}: kernel_ms {tm['kernel_ms']:.4f} plain_ms "
              f"{tm['plain_ms']:.4f} library_ms {tm['library_ms']:.4f} "
              f"bound_ms {tm['bound_ms']:.5f} ({tm['bound_by']}, "
              f"{tm['kv_tokens']} resident tokens)")
    return out


def sdpa_ms(args, cap) -> float:
    """Yardstick only: PyTorch's SDPA with GQA over K/V already gathered
    dense, masked to each row's length. The port never calls it."""
    from repro_torch.kernels import ref
    q, kp, vp, tables, kv_len = args
    k = ref.gather_pages(kp, tables)
    v = ref.gather_pages(vp, tables)
    mask = (torch.arange(k.shape[2], device="cuda")[None, :]
            < torch.clamp(kv_len, 1, cap)[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    fn = torch.nn.functional.scaled_dot_product_attention
    return timer().time_runner(
        lambda: fn(qs, k, v, attn_mask=mask, enable_gqa=True)) * 1e3


def check_rms_norm(chip) -> dict:
    from repro_torch.kernels import ops, ref
    out = {"max_abs_err": 0.0}
    g = torch.Generator(device="cuda").manual_seed(1)
    for rows, dtype in ((8, torch.bfloat16), (512, torch.bfloat16),
                        (8, torch.float32)):
        x = (torch.randn(rows, 3072, generator=g, device="cuda") * 3).to(dtype)
        w = torch.randn(3072, generator=g, device="cuda").to(dtype)
        want = ref.rms_norm(x, w).float()
        ctx = ops.rmsnorm_context(chip, x.shape, ops.dtype_name(dtype))
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        worst = 0.0
        configs = ops.RMS_NORM.space.valid_configs(ctx)
        for cfg in configs:
            got = ops.rmsnorm(x, w, config=cfg).float()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                raise AssertionError(f"rms_norm ({rows}, 3072) {dtype} {cfg}: "
                                     f"max abs err {err} over tolerance {tol}")
            worst = max(worst, err)
        out["max_abs_err"] = max(out["max_abs_err"], worst)
        heur = ops.RMS_NORM.default_config(ctx)
        bound_ms, by = bound(ops._rms_workload(heur, ctx), chip)
        kernel_ms = timer().time_runner(
            lambda: ops.rmsnorm(x, w, config=heur)) * 1e3
        plain_ms = timer().time_runner(lambda: ref.rms_norm(x, w)) * 1e3
        library_ms = timer().time_runner(
            lambda: torch.nn.functional.rms_norm(x, (3072,), w, 1e-6)) * 1e3
        print(f"rms_norm ({rows}, 3072) {ops.dtype_name(dtype)}: "
              f"{len(configs)} configs ok, max_abs_err {worst:.3g} (tol "
              f"{tol}); heuristic {heur}: kernel_ms {kernel_ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
              f"{bound_ms:.5f} ({by})")
        if rows == 8 and dtype == torch.bfloat16:
            out.update(args=(x, w), kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms, bound_by=by,
                       config=heur)
    return out


def decode_state(engine, steps: int):
    """A fresh cache holding 8 prefilled sequences of 96-255 tokens (plain
    prefill), laid out like the engine's pool, ready for ``steps`` decode
    steps: (cache, tables, lens, first tokens)."""
    from repro_torch.models import lm
    cfg, model = engine.cfg, engine.model
    ps = engine.pool.page_size
    B, max_pages = engine.scheduler.max_batch, engine.scheduler.max_pages
    rng = np.random.default_rng(5)
    lens = rng.integers(96, 256, B)
    need = -(-(int(lens.max()) + steps + 1) // ps)
    assert need <= max_pages
    tables = np.zeros((B, max_pages), np.int32)
    for b in range(B):
        tables[b, :need] = 1 + b * need + np.arange(need)
    tables_d = torch.from_numpy(tables).cuda()
    cache = lm.init_paged_cache(cfg, 1 + B * need, ps, device="cuda")
    plain = lm.ForwardOpts(decode_impl="plain", norm_impl="plain")
    for b in range(B):
        prompt = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (1, int(lens[b]))).astype(np.int64)).cuda()
        lm.prefill_paged(model, cfg, prompt, cache, tables_d[b:b + 1],
                         torch.zeros(1, dtype=torch.int32, device="cuda"),
                         plain)
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, 1))).cuda()
    return cache, tables_d, torch.from_numpy(lens.astype(np.int32)).cuda(), tok


def full_width_check(engine, steps: int = 16) -> None:
    """One decode step through both kernels against the same step through
    the plain versions on clones of one cache (logits within the bf16
    tolerance in relative L2 norm, the same greedy tokens up to ties), then
    a short greedy continuation on each path (agreement printed)."""
    from repro_torch.models import lm
    cfg, model = engine.cfg, engine.model
    cache, tables_d, lens_d, tok = decode_state(engine, steps)
    B = tok.shape[0]
    caches = {"kernel": [{k: v.clone() for k, v in layer.items()}
                         for layer in cache], "plain": cache}
    opts = {"kernel": lm.ForwardOpts(decode_impl="kernel",
                                     norm_impl="kernel"),
            "plain": lm.ForwardOpts(decode_impl="plain", norm_impl="plain")}
    first, toks = {}, {}
    for path in ("kernel", "plain"):
        t, seq = tok, []
        for i in range(steps):
            logits, _ = lm.decode_step_paged(model, cfg, t, caches[path],
                                             tables_d, lens_d + i,
                                             opts[path])
            if i == 0:
                first[path] = logits
            t = torch.argmax(logits, -1, keepdim=True)
            seq.append(t[:, 0].cpu().numpy())
        toks[path] = np.stack(seq, 1)
    a, b = first["kernel"], first["plain"]
    assert torch.isfinite(a).all() and a.shape == (B, cfg.vocab_size)
    err = float((a - b).abs().max())
    # Held at the logits' typical scale, not their tail: the error's norm
    # against the plain logits' norm. Elementwise, 32 bf16 layers scatter
    # every logit a little, so over 1.6M logits the largest error is a
    # tail value of that scatter.
    rel = float((a - b).norm() / b.norm())
    std = float(b.std())
    # The first step's greedy tokens agree, or the plain path scores the
    # kernel path's token within the tolerance of its own best (a tie).
    pick_a, pick_b = a.argmax(-1), b.argmax(-1)
    gap = (b.gather(-1, pick_b[:, None])
           - b.gather(-1, pick_a[:, None]))[:, 0]
    lens = lens_d.cpu().numpy()
    print(f"decode step, kernels vs plain, {B} sequences of {lens.min()}-"
          f"{lens.max()} tokens: logits relative L2 error {rel:.4g} (tol "
          f"{BF16_TOL}), max_abs_err {err:.4g}, logit std {std:.4g}, max "
          f"|logit| {float(b.abs().max()):.4g}; first-step argmax agreement "
          f"{int((pick_a == pick_b).sum())}/{B} (largest plain-logit gap "
          f"at a disagreement {float(gap.max()):.4g}, tol "
          f"{BF16_TOL * std:.4g}); greedy agreement over {steps} steps "
          f"{float((toks['kernel'] == toks['plain']).mean()):.3f}")
    if rel > BF16_TOL:
        raise AssertionError(f"full-width decode step: relative L2 logits "
                             f"error {rel} over {BF16_TOL}")
    if float(gap.max()) > BF16_TOL * std:
        raise AssertionError(f"full-width decode step: argmax differs where "
                             f"the plain logits differ by {float(gap.max())}"
                             f", over {BF16_TOL} of their std {std}")


def profile_decode(engine, steps: int = 8) -> None:
    """Where a full-width decode step's time goes: the step's wall time
    unprofiled, then the device time of its kernels under
    ``torch.profiler``; the device busy share is their ratio."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    cfg, model = engine.cfg, engine.model
    opts = lm.ForwardOpts(decode_impl="kernel", norm_impl="kernel")
    cache, tables_d, lens_d, tok = decode_state(engine, 2 * steps + 2)

    def run(i0):
        for i in range(steps):
            lm.decode_step_paged(model, cfg, tok, cache, tables_d,
                                 lens_d + i0 + i, opts)
        torch.cuda.synchronize()

    run(0)
    t = time.perf_counter()
    run(steps)
    wall = (time.perf_counter() - t) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not kernels:
        print(f"decode step (8 rows, full width): wall {wall * 1e3:.2f} ms "
              "unprofiled; the profiler saw no device events, so device "
              "time is not measured")
        return
    device = sum(us for us, _ in by_name.values()) * 1e-6 / steps
    print(f"decode step (8 rows, full width): wall {wall * 1e3:.2f} ms "
          f"unprofiled; device time of its kernels {device * 1e3:.3f} ms "
          f"(profiler, {len(kernels) // steps} device events a step); "
          f"device busy share {device / wall:.3f}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {us * 1e-3 / steps:8.4f} ms/step {n // steps:4d} calls/step"
              f"  {name[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import default_tuner
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as pd_kernel
    from repro_torch.kernels import rms_norm as rms_kernel
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase("1. card and tools")
    card = card_line()
    print(card)
    print(json.dumps(versions(), sort_keys=True))
    chip = ops.device_chip(0)
    print(f"spec: {chip}")

    phase("2. build")
    secs = build_kernels()
    print("build seconds: " + json.dumps({k: round(v, 1)
                                          for k, v in secs.items()}))

    phase("3. kernels against their plain versions")
    pdk = check_paged_decode(chip)
    rms = check_rms_norm(chip)

    phase("4. tuning (deployment lookup and the engine's contexts)")
    tuner = default_tuner()
    tuner.on_miss = "tune"
    args = serve.build_parser().parse_args([
        "--full-config", "--requests", "8", "--prompt-len", "512",
        "--min-prompt-len", "128", "--gen", "32", "--max-batch", "8",
        "--prefill-chunk", "256"])
    t = time.perf_counter()
    engine, reqs, info = serve.prepare(args, tuner)
    print(f"prepare (weights on the card, pool, tuning): "
          f"{time.perf_counter() - t:.1f} s; {json.dumps(info)}")
    for k, entry in tuner.cache.items():
        ctx = json.loads(k["ctx"])
        print(f"tuned {k['kernel']} shapes {ctx['shapes']} extra "
              f"{ctx['extra']}: {entry.n_evaluated} configs timed in "
              f"{entry.measure_s:.1f} s -> {entry.config} "
              f"({entry.metric * 1e3:.4f} ms)")
    # The layout the serving run launches (the engine's page size and
    # table width): every valid config, the tuned one among them, checked
    # against the plain version, then the tuned one timed.
    pd_ctx = serve.engine_contexts(engine)[0][1]
    pd_cfg = tuner.best_config(ops.PAGED_DECODE, pd_ctx)
    ps, max_pages = engine.pool.page_size, engine.scheduler.max_pages
    cfg = engine.cfg
    pd_args = paged_case(7, engine.scheduler.max_batch, cfg.n_heads,
                         cfg.n_kv_heads, cfg.head_dim, ps, max_pages,
                         ragged_lens(ps * max_pages,
                                     cfg.n_heads // cfg.n_kv_heads),
                         torch.bfloat16)
    ctx, configs, worst = check_paged_layout(
        chip, "phi4-mini bf16 at the serving layout", pd_args, ps, max_pages)
    if ctx.signature() != pd_ctx.signature() or pd_cfg not in configs:
        raise AssertionError(f"serving config {pd_cfg} under {pd_ctx} is "
                             f"not among the configs checked under {ctx}")
    pdk["max_abs_err"] = max(pdk["max_abs_err"], worst)
    pdk.update(time_paged_decode(chip, pd_args, pd_cfg, ps, max_pages))
    print(f"paged_decode at the serving layout (page {ps}, {max_pages} "
          f"pages a table) under {pd_cfg}: " + json.dumps(
              {k: v for k, v in pdk.items() if k != "max_abs_err"}))
    rms_cfg = tuner.best_config(
        ops.RMS_NORM, ops.rmsnorm_context(chip, (8, 1, 3072), "bfloat16"))
    x, w = rms["args"]
    rms["kernel_ms"] = timer().time_runner(
        lambda: ops.rmsnorm(x, w, config=rms_cfg)) * 1e3
    print(f"rms_norm (8, 3072) bf16 under {rms_cfg}: kernel_ms "
          f"{rms['kernel_ms']:.4f}")

    phase("5. serving phi4-mini-3.8b at full width")
    pd_kernel.paged_decode.launches = 0
    rms_kernel.rms_norm.launches = 0
    report = serve.serve(engine, reqs)
    launches = {"paged_decode": pd_kernel.paged_decode.launches,
                "rms_norm": rms_kernel.rms_norm.launches}
    print("run report: " + json.dumps(report, sort_keys=True))
    print("launches in the run: " + json.dumps(launches))
    n_layers = engine.cfg.n_layers
    assert n_layers == 32 and engine.cfg.d_model == 3072
    assert report["lifecycle"]["terminal"] == len(reqs) == 8
    assert report["lifecycle"]["failed"] == 0
    assert all(len(r.tokens) == 32 for r in reqs)
    assert launches["paged_decode"] == report["decode_steps"] * n_layers, \
        launches
    assert launches["rms_norm"] > 0, launches
    print(f"tokens/s {report['tokens_per_s']:.1f}, TTFT p50 "
          f"{report['ttft_p50_ms']:.1f} ms p99 {report['ttft_p99_ms']:.1f} "
          f"ms, ITL p50 {report['itl_p50_ms']:.2f} ms, peak memory "
          f"{report['peak_memory_bytes'] / 2**30:.2f} GiB")

    phase("6. full-width decode step: kernels against plain versions, "
          "and where its time goes")
    full_width_check(engine)
    profile_decode(engine)

    phase("7. summary")
    kernels = [
        {"name": "paged_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_decode.py:54",
         "launches": launches["paged_decode"],
         "max_abs_err": pdk["max_abs_err"],
         "ms": pdk["kernel_ms"],
         "plain_ms": pdk["plain_ms"], "bound_ms": pdk["bound_ms"],
         "bound_by": pdk["bound_by"], "library_ms": pdk["library_ms"]},
        {"name": "rms_norm", "route": "triton",
         "source": "src/repro_torch/kernels/rms_norm.py",
         "replaces": "src/repro/kernels/rms_norm.py:24",
         "launches": launches["rms_norm"],
         "max_abs_err": rms["max_abs_err"], "ms": rms["kernel_ms"],
         "plain_ms": rms["plain_ms"], "bound_ms": rms["bound_ms"],
         "bound_by": rms["bound_by"], "library_ms": rms["library_ms"]},
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
