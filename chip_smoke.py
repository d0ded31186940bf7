#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository around it; builds every kernel from
the sources in the checkout and never imports JAX or the JAX package.
Phases, each failing loudly:

  1. the card (``nvidia-smi`` name and power limit) and tool versions;
  2. the build of every kernel, started together: ``nvcc`` for the CUDA
     ``paged_decode`` and ``paged_verify`` (float and int8 pools each),
     ``gqa_decode`` (which also serves ``decode_attention``: one launch,
     a row's splits in one thread-block cluster),
     ``gqa_decode_kv8`` (the earlier dense-decode template built for int8
     caches),
     ``matmul``, ``matmul_w8a8``, ``flash_attention``,
     ``flash_attention_bwd`` and ``mla_decode``, and the Triton compile of
     ``rms_norm``;
  3. each kernel against its plain PyTorch version on the card at the main
     paths' shapes, for every valid config of its space, with its time, the
     plain version's, a yardstick library call's and the roofline bound;
     ``paged_decode`` (version 2: ``kv_splits`` blocks a row in one
     thread-block cluster, a ring of two chunks) also bit-equal
     across two calls at ``kv_splits`` 8, float and int8 pools;
     ``paged_verify`` (version 2, the same design over K·g query rows)
     at every valid config, ``kv_splits`` among its tunables;
     every valid ``gqa_decode_ragged`` and ``decode_attention`` config at
     ragged lengths (0 and past T) in bf16 and f32 and at the serving
     shape;
     ``gqa_decode_kv8`` and the int8 branches of ``paged_decode`` and
     ``paged_verify`` (depths 2, 4, 8) for q in bf16 and in f32; the fixed
     configs of off-space layouts (float and int8 pages of 4 and 256, a
     verify at depth 5 over float and int8 pools); every valid
     ``matmul_w8a8`` config of each scale granularity on ragged shapes
     and the four w8a8 serving shapes (its epilogue configs also equal to
     the exact integer-grid product, split-K bit-equal to one split at
     decode wo; the path each case takes printed: K 200 on ``mma.sync``,
     the serving shapes asserted on ``wgmma``) and its refusals; every
     valid ``matmul`` config in bf16 and f32 at ragged shapes (every edge
     masked; rows TMA cannot read on ``mma.sync``), decode-like rows and
     256^3 (bf16 asserted on ``wgmma``), and its refusals; every valid
     ``flash_attention`` config (o and lse) at the serving prefill and at
     ragged lengths, groups 1, 3 and 4, D 96 and 120, windows, a query
     offset, non-causal, f32, and rows that see no key; every valid
     ``flash_attention_bwd`` config (dq, dk and dv, two launches bit-equal)
     at the training step's shape (B 4, 24/8 heads of 128, 512 tokens),
     Sq 200, groups 1, 3 and 4 at D 96, 120 and 64, a window, a query
     offset, non-causal, f32, and rows that see no key (dq exactly zero);
     every valid ``mla_decode`` config at deepseek-v2-lite's widths (B 8, 16 heads,
     latent rank 512, RoPE keys of 64, T 544) in bf16 and f32 with
     ragged lengths (0 and past T: zeros and the whole cache), at the
     serving decode, and at 4 heads of rank 64 (rows padded to 16); then
     the registry's oracle sweep: every valid config of every registered
     kernel's host bench cases against its reference;
  4. tuning: the serve entry point's deployment lookups (``paged_decode``
     and ``paged_verify`` with the speculation depth free, float and,
     under ``--quant kv8``, int8), each a hit in the shipped H100 DB, and
     the contexts the plain, the speculative, the kv8 and the kv8
     speculative engine will dispatch, tuned on the card; then every
     valid ``paged_decode`` (float and int8) and ``paged_verify`` (float
     and int8) config at the pool layouts the
     tuning chose (the tuned ones among them) against the plain versions,
     and the tuned ones timed (both asserted on their bulk-copy paths);
     ``paged_decode`` and ``paged_verify`` at the shipped deployment
     shape (phi4-mini, 16 sequences of 32,768 slots, bf16 and int8 pools)
     under the shipped configs, held within 2e-2 of the plain version's
     largest |o|, beside SDPA and the bound; ``decode_attention`` tuned at
     the serving shape and timed there and, under its shipped config, at
     the deployment shape (16 requests of 32,768, held within 2e-2 of the
     plain version's largest |o|) beside SDPA; the kv8 dense
     serving context tuned and
     timed; the four ``matmul_w8a8`` contexts of a w8a8 dense run
     (prefill and decode rows, ``wi`` and ``wo``) tuned and timed beside
     the plain version, ``torch._int_mm`` and a bf16 ``torch.matmul``;
     the ``--attn-impl pallas`` prefill's ``flash_attention`` context
     tuned and timed beside the plain version and SDPA; the train
     launcher's ``--attn-impl pallas`` contexts (``flash_attention`` and
     ``flash_attention_bwd`` at the training step) and the registry's
     ``train4k`` tuned, the backward timed at both beside the plain
     version, SDPA's backward and the bound; deepseek-v2-lite's
     ``mla_decode`` serving context and the registry's ``dsv2_32k`` tuned
     and timed beside the plain version and SDPA; ``matmul`` at 8192^3
     bf16 (``mm8k``, the shipped config, asserted on ``wgmma``) and 256^3
     f32 (tuned) timed beside the plain version, ``torch.matmul`` and the
     bound;
  5. serving phi4-mini-3.8b at full width (32 layers, bf16, random weights
     from a seed): 8 requests of 128-512 prompt tokens and 32 new tokens,
     prefill chunks of 256, once by plain decode and once by speculative
     decode (``--speculative``: draft and verify, depth from the tuned
     deployment entry), with the kernels' launch counts read around each
     run (every ``paged_decode`` launch on its bulk-copy path, float and
     int8); the two runs' tokens must agree; the same requests with
     ``--quant kv8`` (int8 page pools) through the int8 branch of
     ``paged_decode`` and through the plain versions, streams equal 8/8;
     then ``--quant kv8 --speculative`` through the int8 branch of
     ``paged_verify`` (depth from the int8 deployment entry), its streams
     equal to the kv8 plain run's up to a tie and its numbers beside the
     bf16 speculative run's; then the launcher at the smoke
     widths with ``--speculative 5`` (off the tuned depths); then the
     static batch over dense caches (``--decode-impl pallas`` through
     ``gqa_decode_ragged``, then ``--decode-impl full``): 8 prompts of 512
     tokens, 32 new tokens each, the token streams equal 8 of 8; the same
     with ``--quant kv8`` (int8 caches, ``gqa_decode_kv8``), and how many
     of its streams equal the bf16 run's; then ``--quant w8a8`` (int8 MLP
     weights, per-token int8 activations) with ``--quant-impl pallas``
     (every MLP GEMM through ``matmul_w8a8``, all on its ``wgmma`` path)
     and ``sim``, streams equal 8/8 up to a tie, and by ``--decode-impl
     full``; then ``--decode-impl pallas --attn-impl pallas`` (the
     prefill through ``flash_attention``, 32 launches, none in the
     chunked runs), streams equal the chunked run's up to a tie; then
     ``gqa_decode_ragged`` under the serving config timed at the serving
     shape and, under its shipped config, at the deployment shape (the
     seed-7 lengths; held and timed as ``decode_attention`` is), and the
     timer's floor measured by
     this script's own CUDA events (the kernel with every kv_len 0, a
     ``copy_`` of the kernel's 17.3 MB, and the kernel, SDPA and the copy
     after the timer's zeroing L2 flush and after one that reads);
  6. one full-width decode step (float pools and int8 pools) and one
     full-width verify step (float pools and int8 pools) through the
     kernels against the same step through the plain versions on the same
     cache, and one full-width dense decode step through ``gqa_decode``
     and one through ``gqa_decode_kv8`` (int8 caches) against the plain
     einsum, and one w8a8 dense step through ``matmul_w8a8`` against the
     sim GEMMs, with the residual stream compared layer by layer, and a
     profiled window of each (wall time, device time, device busy share),
     and one profiled w8a8 prefill of the 8 prompts by each;
     one full-width dense prefill through ``flash_attention`` against the
     chunked prefill (KV chunks of 64), logits held, and a profile of
     each; one call of ``decode_attention`` and one of
     ``gqa_decode_ragged`` at k_splits 8, and one of ``paged_verify`` at
     kv_splits 8, under ``torch.profiler`` in a fresh process: one kernel
     each, two calls bit-equal;
     then a small f32 model whose drafts are often rejected,
     served speculatively on the CPU (plain versions) and on the card
     (kernels), and by plain decode on the card: the same tokens and
     counts, at depth 4 on pages of 8, at depth 5 on pages of 4 (both
     off the tuned layouts) and at depth 4 over int8 pools (kv8);
  7. with every phi4-mini model released, serving deepseek-v2-lite-16b at
     full width (27 layers, MLA rank 512, 64 experts top-6 plus 2 shared,
     bf16, random weights from a seed, 31 GB): the launcher's static batch
     of 8 prompts of 512 tokens and 32 new tokens, chunked prefill, by
     ``--decode-impl pallas`` (``mla_decode`` launched 27 times a decode
     step) and ``full`` (none), and ``full`` after the reference's other
     exact prefill (``--attn-impl full``): the streams each pair shares;
  8. one full-width deepseek decode step: ``mla_decode`` against the
     reference's einsum on the same inputs at each of the 27 layers, the
     whole step's logits held against the einsum step's within the
     reference's own spread, and a profiled window of it; then the model
     in float32 (63 GB), where the streams of ``mla_decode`` and of the
     einsum are held equal up to a tie;
  9. with every serving model released (the device memory allocated is
     printed before phase 7 and here, and held under 1 GiB), training
     phi4-mini-3.8b at full width (``launch.train --full-config --batch 4
     --seq 512 --steps 4``, no checkpoint) by ``--attn-impl pallas``
     (``flash_attention`` and ``flash_attention_bwd`` 32 times a step each:
     128) and by ``chunked`` (none), step 1's loss held within 2e-2; that
     first step again, its gradients held per leaf against chunked's within
     the spread of the reference's own exact paths (``full`` and
     ``chunked``), and ``flash_attention_bwd`` on each of its 32 layers'
     inputs against the plain version; a profiled window of two training
     steps; the model cut to 8 layers in float32, 4 steps by both paths,
     losses within 1e-4 and parameters within F32_TOL; a checkpoint, an
     injected failure and a resume at smoke widths, the restored state bit
     for bit the saved one;
 10. the shipped H100 tuning DB (``src/repro_torch/configs/
     shipped_tuning_db.json``): every entry parses against the current
     spaces and names this card; a fresh process with
     ``REPRO_ON_MISS=error`` resolves every deployment lookup of the serve
     launcher for each arch it pages (plain, ``--speculative``, ``--quant
     kv8`` and both) and the ``mm8k`` matmul through ``default_tuner()``
     with no tune, and launches ``ops.matmul`` once on that config against
     the plain version; ``gen_shipped_db`` restricted to ``matmul`` and
     ``matmul_w8a8`` runs into a temporary file (matmul's launches there
     and in that process are its count);
 11. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib.metadata
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 2e-2
F32_TOL = 1e-4
# int8 caches with an f32 q: the kernel scales the finished dot product and
# the probability where the plain version dequantizes first (the
# reference's int8 tolerance, tests/test_kernel_oracles.py); a bf16 q
# keeps BF16_TOL
INT8_TOL = 2e-3
TOL = {"bfloat16": BF16_TOL, "float32": F32_TOL, "int8": INT8_TOL}


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def versions() -> dict:
    from repro_torch.kernels import build
    nvcc = subprocess.run([build.nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "none"
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "triton": triton,
            "nvcc": nvcc.stdout.strip().splitlines()[-1]}


def build_kernels() -> dict:
    """nvcc for each CUDA kernel (one process each) and Triton's compile of
    rms_norm (on its first launch), started together; returns seconds per
    build."""
    from repro_torch.kernels import flash_attention as fa_kernel
    from repro_torch.kernels import flash_attention_bwd as fab_kernel
    from repro_torch.kernels import gqa_decode as gqa_kernel
    from repro_torch.kernels import matmul as mm_kernel
    from repro_torch.kernels import matmul_w8a8 as mm8_kernel
    from repro_torch.kernels import mla_decode as mla_kernel
    from repro_torch.kernels import paged_decode as pd_kernel
    from repro_torch.kernels import paged_verify as pv_kernel
    from repro_torch.kernels import rms_norm as rms_kernel
    secs, errors = {}, []
    libs = {"paged_decode": pd_kernel.LIB, "paged_verify": pv_kernel.LIB,
            "gqa_decode": gqa_kernel.LIB, "gqa_decode_kv8": gqa_kernel.LIB_KV8,
            "matmul": mm_kernel.LIB, "matmul_w8a8": mm8_kernel.LIB,
            "flash_attention": fa_kernel.LIB,
            "flash_attention_bwd": fab_kernel.LIB, "mla_decode": mla_kernel.LIB}

    def nvcc(name):
        t = time.perf_counter()
        try:
            libs[name].load()
        except Exception as e:          # noqa: BLE001 — re-raised below
            errors.append(e)
        secs[name] = time.perf_counter() - t

    t0 = time.perf_counter()
    threads = [threading.Thread(target=nvcc, args=(name,)) for name in libs]
    for th in threads:
        th.start()
    x = torch.ones(8, 3072, device="cuda", dtype=torch.bfloat16)
    rms_kernel.rms_norm(x, x[0])
    torch.cuda.synchronize()
    secs["rms_norm"] = time.perf_counter() - t0
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    for name, lib in libs.items():
        lines = [ln for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "Used " in ln]
        if not regs:            # built by an earlier process: no log here
            print(f"ptxas ({name}): built before this run")
            continue
        print(f"ptxas ({name}, {len(regs)} instantiations): {max(regs)} "
              f"registers at most; spills: "
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


def paged_case(seed, B, Hq, Hkv, D, ps, max_pages, kv_len, dtype, K=None):
    """Pool with page 0 as scratch and each sequence on shuffled pages; q
    is (B, Hq, D) for decode, (B, K, Hq, D) for a verify of depth K."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_pages
    tables = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = tables.reshape(B, max_pages).copy()
    for b, n in enumerate(kv_len):
        tables[b, -(-min(max(n, 0), max_pages * ps) // ps):] = 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
    return (rand(B, Hq, D) if K is None else rand(B, K, Hq, D),
            rand(Hkv, n_pages, ps, D), rand(Hkv, n_pages, ps, D),
            torch.from_numpy(tables).cuda(),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"))


def paged_kv8_case(seed, B, Hq, Hkv, D, ps, max_pages, kv_len, q_dtype,
                   K=None):
    """``paged_case``'s pool in f32 quantized by the kv8 wire format, q in
    ``q_dtype`` ((B, K, Hq, D) for a verify of depth K): (args (q, k_pages,
    v_pages, tables, kv_len), scales {"k_scales", "v_scales"})."""
    from repro_torch.quant import quantize_kv
    q, kp, vp, tables, lens = paged_case(seed, B, Hq, Hkv, D, ps, max_pages,
                                         kv_len, torch.float32, K)
    kq, ks, vq, vs = quantize_kv(kp, vp)
    return ((q.to(q_dtype), kq, vq, tables, lens),
            {"k_scales": ks, "v_scales": vs})


def time_paged(chip, args, cfg, ps, max_pages, scales=None) -> dict:
    """Kernel (under ``cfg``), plain version, library yardstick and the
    roofline bound for one decode or verify input set (int8 pools with
    their ``scales``: the bound counts int8 rows and f32 scales, the
    yardstick is SDPA over the pools dequantized to q's dtype beforehand,
    the dequant not timed); the bound counts the resident tokens (and a
    verify's attended (row, key) pairs) these inputs have."""
    from repro_torch.core import KernelWorkload
    from repro_torch.kernels import ops
    scales = scales or {}
    _, _, entry, plain, _ = paged_kernel(args, ps, max_pages, chip)
    q, kp, lens = args[0], args[1], args[4]
    B, Hq, D = q.shape[0], q.shape[-2], q.shape[-1]
    cap = ps * max_pages
    kv_tokens = int(torch.clamp(lens, 0, cap).sum())
    rows = dict(q_itemsize=q.element_size(), scale_bytes=4 if scales else 0)
    if q.dim() == 3:
        flops = ops.paged_decode_flops(Hq, D, kv_tokens)
        nbytes = ops.paged_decode_bytes(B, Hq, kp.shape[0], D, kv_tokens,
                                        max_pages, kp.element_size(), **rows)
    else:
        K = q.shape[1]
        flops = ops.paged_verify_flops(Hq, D,
                                       ops.verify_attended(lens, K, cap))
        nbytes = ops.paged_verify_bytes(B, K, Hq, kp.shape[0], D, kv_tokens,
                                        max_pages, kp.element_size(), **rows)
    yard = args
    if scales:
        yard = (q, *(
            (pool.float() * sc[..., None]).to(q.dtype)
            for pool, sc in ((args[1], scales["k_scales"]),
                             (args[2], scales["v_scales"]))), *args[3:])
    bound_ms, by = bound(KernelWorkload(flops, nbytes,
                                        ops.dtype_name(q.dtype)), chip)
    return {"kernel_ms": timer().time_runner(
                lambda: entry(*args, **scales, config=cfg)) * 1e3,
            "plain_ms": timer().time_runner(
                lambda: plain(*args, **scales)) * 1e3,
            "library_ms": sdpa_ms(yard, cap), "bound_ms": bound_ms,
            "bound_by": by, "kv_tokens": kv_tokens}


def sdpa_ms(args, cap) -> float:
    """Yardstick only: PyTorch's SDPA with GQA over K/V already gathered
    dense, each query position masked to its causal window (a decode is a
    verify of one position; windows hold at least one key, so no row is
    fully masked). The port never calls it."""
    from repro_torch.kernels import ref
    q, kp, vp, tables, kv_len = args
    if q.dim() == 3:
        q = q[:, None]
    K = q.shape[1]
    k = ref.gather_pages(kp, tables)
    v = ref.gather_pages(vp, tables)
    lens = torch.clamp(kv_len.long(), K, cap)
    q_pos = lens[:, None] - K + torch.arange(K, device="cuda")[None]
    mask = (torch.arange(k.shape[2], device="cuda")[None, None, :]
            <= q_pos[:, :, None])[:, None]
    qs = q.transpose(1, 2).contiguous()
    fn = torch.nn.functional.scaled_dot_product_attention
    return timer().time_runner(
        lambda: fn(qs, k, v, attn_mask=mask, enable_gqa=True)) * 1e3


def ragged_lens(cap: int, group: int) -> list:
    """Eight lengths: empty, one past capacity, short, mid-page tails and
    near or at capacity."""
    if group > 1:
        return [0, cap + 1, 1, cap // 7, cap // 2 - 1, (5 * cap) // 7,
                (8 * cap) // 9 + 1, cap - 1]
    return [0, cap + 1, cap // 9, cap // 6, cap // 3 + 8, cap // 2,
            (8 * cap) // 9 - 1, cap]


def paged_kernel(args, ps, max_pages, chip):
    """(kernel name, tunable, entry point, plain version, context) of the
    paged attention kernel these inputs are for: a 3-d q is a decode, a
    4-d q a verify of depth q.shape[1]; int8 pools give the int8 context,
    q's dtype beside it."""
    from repro_torch.kernels import ops, ref
    q, kp = args[0], args[1]
    Hkv, cap, dt = kp.shape[0], ps * max_pages, ops.dtype_name(q.dtype)
    int8 = kp.dtype == torch.int8
    pool_dt, suffix = ("int8", " int8") if int8 else (dt, "")
    if q.dim() == 3:
        B, Hq, D = q.shape
        return ("paged_decode" + suffix, ops.PAGED_DECODE,
                ops.paged_decode, ref.paged_decode,
                ops.paged_decode_context(chip, B, Hq, Hkv, D, cap, pool_dt,
                                         ps, dt))
    B, K, Hq, D = q.shape
    return ("paged_verify" + suffix, ops.PAGED_VERIFY, ops.paged_verify,
            ref.paged_verify,
            ops.paged_verify_context(chip, B, Hq, Hkv, D, cap, pool_dt, ps,
                                     K, dt))


def check_paged_layout(chip, name, args, ps, max_pages, scales=None):
    """Every valid config of the context these inputs give (int8 pools
    with their ``scales``: the int8 context, at INT8_TOL for an f32 q),
    against the plain version on the same inputs, rows with kv_len 0
    exactly zero; returns (context, configs checked, worst max abs
    error)."""
    kname, tunable, entry, plain, ctx = paged_kernel(args, ps, max_pages,
                                                     chip)
    q, scales = args[0], scales or {}
    tol = BF16_TOL if q.dtype == torch.bfloat16 else (
        INT8_TOL if scales else F32_TOL)
    want = plain(*args, **scales).float()
    empty = args[4] == 0
    configs = tunable.space.valid_configs(ctx)
    if not configs:
        raise AssertionError(f"{kname} {name}: no valid config")
    worst = 0.0
    for cfg in configs:
        got = entry(*args, **scales, config=cfg).float()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=tol, rtol=tol) \
                or got[empty].any():
            raise AssertionError(f"{kname} {name} {cfg}: max abs "
                                 f"err {err} over tolerance {tol}")
        worst = max(worst, err)
    depth = f", K {q.shape[1]}" if q.dim() == 4 else ""
    print(f"{kname} {name}{depth} (pages of {ps}, {max_pages} a table, "
          f"lengths {args[4].tolist()}): {len(configs)} configs ok, "
          f"max_abs_err {worst:.3g} (tol {tol})")
    return ctx, configs, worst


def time_heuristic(chip, tunable, ctx, args, ps, max_pages,
                   scales=None) -> None:
    """Time the context's heuristic config on these inputs and print it
    beside the plain version, the yardstick and the bound."""
    heur = tunable.default_config(ctx)
    tm = time_paged(chip, args, heur, ps, max_pages, scales)
    print(f"  heuristic {heur}: kernel_ms {tm['kernel_ms']:.4f} plain_ms "
          f"{tm['plain_ms']:.4f} library_ms {tm['library_ms']:.4f} "
          f"bound_ms {tm['bound_ms']:.5f} ({tm['bound_by']}, "
          f"{tm['kv_tokens']} resident tokens)")


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
        time_heuristic(chip, ops.PAGED_DECODE, ctx, args, ps, max_pages)
        splits_repeatable(name, args, ctx)
    return out


def splits_repeatable(name, args, ctx, scales=None) -> None:
    """Two calls at kv_splits 8 (eight blocks a row, merged by rank 0 in
    rank order) give the same bits."""
    from repro_torch.kernels import ops
    cfg = next(c for c in ops.PAGED_DECODE.space.valid_configs(ctx)
               if c["kv_splits"] == 8)
    scales = scales or {}
    one = ops.paged_decode(*args, **scales, config=cfg)
    two = ops.paged_decode(*args, **scales, config=cfg)
    torch.cuda.synchronize()
    if not torch.equal(one, two):
        raise AssertionError(f"paged_decode {name} {cfg}: two calls differ")
    print(f"  kv_splits 8 ({cfg}): two calls bit-equal")


def check_paged_decode_kv8(chip) -> dict:
    """The int8 branch: every valid config of the int8 context against the
    plain version (dequantize, gather, decode) at pages of 16 on
    phi4-mini's heads, q in bf16 (BF16_TOL) and in f32 (INT8_TOL), ragged
    lengths with 0 and one past the capacity; the heuristic config timed
    for the bf16 q. The serving layout is checked in phase 4."""
    from repro_torch.kernels import ops
    ps, max_pages = 16, 36
    out = {"max_abs_err": 0.0}
    for q_dtype in (torch.bfloat16, torch.float32):
        name = f"phi4-mini int8 pools, q {ops.dtype_name(q_dtype)}"
        args, scales = paged_kv8_case(130, 8, 24, 8, 128, ps, max_pages,
                                      ragged_lens(ps * max_pages, 3), q_dtype)
        ctx, _, worst = check_paged_layout(chip, name, args, ps, max_pages,
                                           scales)
        out["max_abs_err"] = max(out["max_abs_err"], worst)
        if q_dtype == torch.bfloat16:
            time_heuristic(chip, ops.PAGED_DECODE, ctx, args, ps, max_pages,
                           scales)
        splits_repeatable(name, args, ctx, scales)
    return out


def on_bulk_path(run, wrapper=None):
    """``run()``, asserting that every launch of ``wrapper`` (a paged
    kernel's wrapper, by default paged_decode's) it makes copies its
    chunks by bulk copies (none by cp.async); returns its result."""
    from repro_torch.kernels import paged_decode as pd_kernel
    wrapper = wrapper or pd_kernel.paged_decode
    before = dict(wrapper.path_launches)
    out = run()
    after = wrapper.path_launches
    if after["cp_async"] != before["cp_async"] or \
            after["bulk"] == before["bulk"]:
        raise AssertionError(f"{wrapper.__name__} left the bulk path: "
                             f"{before} -> {after}")
    return out


def time_deployment(chip, tuner, full_cfg) -> dict:
    """paged_decode at the shipped deployment shape (16 sequences of
    32,768 slots, the runner's seed-7 lengths) under the shipped config,
    bf16 and int8 pools (q bf16), held against the plain version and
    timed beside SDPA over K/V pre-gathered (int8: dequantized to bf16
    beforehand, not timed) and the bound. o there is a softmax-weighted
    mean of about 18k random rows, |o| about 0.05, so the bf16 limit is
    taken relative to the plain version's largest |o|."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    out = {}
    for quant in (None, "kv8"):
        ctx = serve.deployment_context(full_cfg, chip, quant)
        cfg = tuner.best_config(ops.PAGED_DECODE, ctx)
        ps = cfg["page_size"]
        run = ops._paged_runner(cfg, ctx)     # the tuner's own operands
        args, scales = run.args, {k: run.kwargs[k] for k in
                                  ("k_scales", "v_scales") if k in run.kwargs}
        got = run().float()
        want = ref.paged_decode(*args, **scales).float()
        err = float((got - want).abs().max())
        limit = BF16_TOL * float(want.abs().max())
        if err > limit:
            raise AssertionError(f"paged_decode at the deployment shape "
                                 f"{cfg}: max abs err {err} > {limit}")
        kernel_ms = on_bulk_path(lambda: timer().time_runner(run)) * 1e3
        yard = args
        if scales:
            pools = ((args[1], scales["k_scales"]),
                     (args[2], scales["v_scales"]))
            yard = (args[0], *((pool.float() * sc[..., None]).bfloat16()
                               for pool, sc in pools), *args[3:])
        bound_ms, by = bound(ops._paged_workload(cfg, ctx), chip)
        label = "int8" if quant else "bf16"
        out[label] = {"max_abs_err": err, "limit": limit,
                      "kernel_ms": kernel_ms,
                      "library_ms": sdpa_ms(yard, ps * args[3].shape[1]),
                      "bound_ms": bound_ms, "bound_by": by,
                      "kv_tokens": int(args[4].sum()), "config": cfg}
        print(f"paged_decode at the deployment shape ({label} pools, "
              f"{ctx.shapes}, the shipped config): " + json.dumps(out[label]))
        del args, scales, yard, run, got, want
        ops.release_tuning_operands()
        torch.cuda.empty_cache()
    return out


def time_verify_deployment(chip, tuner, full_cfg) -> dict:
    """paged_verify at the shipped deployment shape (16 sequences of
    32,768 slots, the runner's seed-11 lengths, the entry's depth) under
    the shipped config, bf16 and int8 pools (q bf16), on its bulk-copy
    path, held against the plain version within 2e-2 of the plain
    version's largest |o| (as ``time_deployment``) and timed beside SDPA
    with a causal-tail mask over K/V pre-gathered (int8: dequantized to
    bf16 beforehand, not timed) and the bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_verify as pv_kernel
    from repro_torch.launch import serve
    out = {}
    for quant in (None, "kv8"):
        ctx = serve.verify_deployment_context(full_cfg, chip, quant)
        cfg = tuner.best_config(ops.PAGED_VERIFY, ctx)
        ps = cfg["page_size"]
        run = ops._paged_verify_runner(cfg, ctx)  # the tuner's operands
        args, scales = run.args, {k: run.kwargs[k] for k in
                                  ("k_scales", "v_scales") if k in run.kwargs}
        got = run().float()
        want = ref.paged_verify(*args, **scales).float()
        err = float((got - want).abs().max())
        limit = BF16_TOL * float(want.abs().max())
        if err > limit or got[want.abs().amax(-1) == 0].any():
            raise AssertionError(f"paged_verify at the deployment shape "
                                 f"{cfg}: max abs err {err} > {limit}")
        kernel_ms = on_bulk_path(lambda: timer().time_runner(run),
                                 pv_kernel.paged_verify) * 1e3
        yard = args
        if scales:
            pools = ((args[1], scales["k_scales"]),
                     (args[2], scales["v_scales"]))
            yard = (args[0], *((pool.float() * sc[..., None]).bfloat16()
                               for pool, sc in pools), *args[3:])
        bound_ms, by = bound(ops._paged_verify_workload(cfg, ctx), chip)
        label = "int8" if quant else "bf16"
        out[label] = {"max_abs_err": err, "limit": limit,
                      "kernel_ms": kernel_ms,
                      "library_ms": sdpa_ms(yard, ps * args[3].shape[1]),
                      "bound_ms": bound_ms, "bound_by": by,
                      "kv_tokens": int(args[4].sum()), "config": cfg}
        print(f"paged_verify at the deployment shape ({label} pools, "
              f"{ctx.shapes}, K {cfg['draft_k']}, the shipped config): "
              + json.dumps(out[label]))
        del args, scales, yard, run, got, want
        ops.release_tuning_operands()
        torch.cuda.empty_cache()
    return out


def verify_lens(cap: int, K: int) -> list:
    """Eight lengths (drafts counted): empty, one, a tail shorter than K,
    exactly K, full, past capacity, and two ragged ones."""
    return [0, 1, K - 1, K, cap, cap + 1, cap // 3 + 5, (2 * cap) // 3 - 1]


def check_paged_verify(chip) -> dict:
    """Every valid config against the plain version at pages of 16, on
    phi4-mini's heads (bf16 and f32 pools) and on phi3-mini's (group 1,
    D 96), at depths 2, 4 and 8. The serving layout is checked in phase
    4, once it is known."""
    from repro_torch.kernels import ops
    ps, max_pages = 16, 36
    cases = [("phi4-mini bf16", 8, 24, 8, 128, torch.bfloat16),
             ("phi4-mini f32", 8, 24, 8, 128, torch.float32),
             ("phi3-mini bf16", 8, 32, 32, 96, torch.bfloat16)]
    out = {"max_abs_err": 0.0}
    for name, B, Hq, Hkv, D, dtype in cases:
        for K in (2, 4, 8):
            args = paged_case(D + K, B, Hq, Hkv, D, ps, max_pages,
                              verify_lens(ps * max_pages, K), dtype, K)
            ctx, _, worst = check_paged_layout(chip, name, args, ps,
                                               max_pages)
            out["max_abs_err"] = max(out["max_abs_err"], worst)
            time_heuristic(chip, ops.PAGED_VERIFY, ctx, args, ps, max_pages)
    return out


def check_paged_verify_kv8(chip) -> dict:
    """The int8 branch of the verify: every valid config of the int8
    context against the plain version (gather, dequantize, verify) at
    pages of 16 on phi4-mini's heads, depths 2, 4 and 8, q in bf16
    (BF16_TOL) and in f32 (INT8_TOL), lengths with 0, a tail shorter than
    K and one past the capacity; the heuristic config timed for the bf16
    q. The kv8 speculative serving layout is checked in phase 4."""
    from repro_torch.kernels import ops
    ps, max_pages = 16, 36
    out = {"max_abs_err": 0.0}
    for q_dtype in (torch.bfloat16, torch.float32):
        name = f"phi4-mini int8 pools, q {ops.dtype_name(q_dtype)}"
        for K in (2, 4, 8):
            args, scales = paged_kv8_case(140 + K, 8, 24, 8, 128, ps,
                                          max_pages,
                                          verify_lens(ps * max_pages, K),
                                          q_dtype, K)
            ctx, _, worst = check_paged_layout(chip, name, args, ps,
                                               max_pages, scales)
            out["max_abs_err"] = max(out["max_abs_err"], worst)
            if q_dtype == torch.bfloat16:
                time_heuristic(chip, ops.PAGED_VERIFY, ctx, args, ps,
                               max_pages, scales)
    return out


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


def off_space_layouts(chip) -> dict:
    """Pools with page sizes outside the space (4 and 256; float and int8)
    and a verify at depth 5 (outside the tuned depths; over float and
    int8 pools) through ``ops``: the fixed config, no tuning (a tuner that
    errors on a miss), against the plain versions; returns the worst max
    abs error by kernel."""
    from repro_torch.core import Autotuner
    from repro_torch.kernels import ops, ref
    tuner = Autotuner(on_miss="error")
    worst = {}
    for ps, max_pages, K in ((4, 136, 5), (256, 3, 5), (16, 36, 5)):
        cap = ps * max_pages
        lens = ragged_lens(cap, 3)
        args = paged_case(ps + K, 8, 24, 8, 128, ps, max_pages, lens,
                          torch.bfloat16)
        vargs = paged_case(ps + K, 8, 24, 8, 128, ps, max_pages,
                           verify_lens(cap, K), torch.bfloat16, K)
        v8, vsc = paged_kv8_case(ps + K + 2, 8, 24, 8, 128, ps, max_pages,
                                 verify_lens(cap, K), torch.bfloat16, K)
        runs = [("paged_verify", ops.paged_verify, ref.paged_verify, vargs,
                 ops.paged_verify_config(vargs[0], vargs[1], vargs[3])),
                ("paged_verify int8", functools.partial(
                    ops.paged_verify, **vsc), functools.partial(
                    ref.paged_verify, **vsc), v8, ops.paged_verify_config(
                    v8[0], v8[1], v8[3]))]
        if ps not in ops.PAGE_SIZES:
            runs.append(("paged_decode", ops.paged_decode, ref.paged_decode,
                         args, ops.paged_decode_config(args[0], args[1],
                                                       args[3])))
        if ps not in ops.PAGE_SIZES:
            a8, sc = paged_kv8_case(ps + K + 1, 8, 24, 8, 128, ps,
                                    max_pages, lens, torch.bfloat16)
            runs.append(("paged_decode int8", functools.partial(
                ops.paged_decode, **sc), functools.partial(
                ref.paged_decode, **sc), a8, ops.paged_decode_config(
                a8[0], a8[1], a8[3])))
        for name, entry, plain, a, cfg in runs:
            got = entry(*a, tuner=tuner).float()
            err = float((got - plain(*a).float()).abs().max())
            depth = f", K {K}" if name.startswith("paged_verify") else ""
            print(f"{name} off-space (pages of {ps}{depth}) under the fixed "
                  f"config {cfg}: max_abs_err {err:.3g} (tol {BF16_TOL})")
            if err > BF16_TOL:
                raise AssertionError(f"{name} pages of {ps}: {err}")
            worst[name] = max(worst.get(name, 0.0), err)
    assert tuner.stats()["misses"] == 0
    return worst


def registry_sweep(chip) -> None:
    """The oracle sweep over the registry: every registered kernel, every
    host bench case, every valid config, operands made on the card by the
    kernel's own ``operands`` function, entry point against reference."""
    from repro_torch.kernels.registry import list_kernels
    for spec in list_kernels():
        if not spec.cases("host"):
            print(f"registry sweep {spec.name}: no host bench case (its "
                  f"cases are paper scale; phases 3-4 check and time it)")
        for case in spec.cases("host"):
            ctx = case.context(chip)
            tol = TOL[case.dtype]
            configs = spec.space.valid_configs(ctx)
            worst = 0.0
            for cfg in configs:
                args, kw = spec.operands(ctx, cfg, "cuda")
                outs = spec.entry_point(*args, **kw, config=cfg)
                wants = spec.reference(*args, **kw)
                if isinstance(outs, torch.Tensor):   # else (dq, dk, dv)
                    outs, wants = (outs,), (wants,)
                for got, want in zip(outs, wants):
                    got, want = got.float(), want.float()
                    err = float((got - want).abs().max())
                    if not torch.allclose(got, want, atol=tol, rtol=tol):
                        raise AssertionError(f"registry sweep {spec.name}/"
                                             f"{case.label} {cfg}: {err}")
                    worst = max(worst, err)
            print(f"registry sweep {spec.name}/{case.label}: {len(configs)} "
                  f"configs ok, max_abs_err {worst:.3g} (tol {tol})")


def dense_case(seed, B, T, kv_len, dtype):
    """phi4-mini's heads: q and a (B, T, Hkv, D) cache handed over as
    (B, Hkv, T, D) views, as ``attn_decode`` hands it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
    return (rand(B, 24, 128), rand(B, T, 8, 128).transpose(1, 2),
            rand(B, T, 8, 128).transpose(1, 2),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"))


DENSE_T = 544           # the serving cache: prompts of 512 + 32 new tokens


def check_dense_decode(chip) -> dict:
    """Every valid config of gqa_decode_ragged and of decode_attention
    against the plain version at phi4-mini's heads: ragged lengths (with
    kv_len 0 and past T) in bf16 and f32, and the serving shape (B 8, T
    544, every request at 528 tokens) in bf16. Returns the worst error per
    kernel."""
    from repro_torch.kernels import ops, ref
    out = {"gqa_decode_ragged": 0.0, "decode_attention": 0.0}
    cases = [("ragged bf16", ragged_lens(DENSE_T, 3), torch.bfloat16),
             ("ragged f32", ragged_lens(DENSE_T, 3), torch.float32),
             ("serving bf16", [528] * 8, torch.bfloat16)]
    for label, lens, dtype in cases:
        q, k, v, kv_len = dense_case(len(label), 8, DENSE_T, lens, dtype)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        want = ref.gqa_decode(q, k, v, kv_len=kv_len).float()
        dt = ops.dtype_name(dtype)
        for name, tunable, entry, ctx in (
                ("gqa_decode_ragged", ops.GQA_DECODE_RAGGED,
                 ops.ragged_decode,
                 ops.gqa_decode_context(chip, 8, 24, 8, 128, DENSE_T, dt)),
                ("decode_attention", ops.DECODE_ATTENTION, ops.decode,
                 ops.decode_attention_context(chip, 8, 24, 8, 128, DENSE_T,
                                              dt))):
            configs = tunable.space.valid_configs(ctx)
            worst = 0.0
            for cfg in configs:
                got = entry(q, k, v, kv_len=kv_len, config=cfg).float()
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, atol=tol, rtol=tol):
                    raise AssertionError(f"{name} {label} {cfg}: max abs "
                                         f"err {err} over tolerance {tol}")
                worst = max(worst, err)
            out[name] = max(out[name], worst)
            print(f"{name} {label} (B 8, 24/8 heads of 128, T {DENSE_T}, "
                  f"lengths {lens}): {len(configs)} configs ok, max_abs_err "
                  f"{worst:.3g} (tol {tol})")
    return out


def kv8_case(seed, B, T, kv_len, q_dtype):
    """phi4-mini's heads: q, and a (B, T, Hkv, D) cache quantized by the
    kv8 wire format, handed over as the (B, Hkv, T, D) and (B, Hkv, T)
    views ``attn_decode`` hands the kernel: (q, k, v, k_scale, v_scale,
    kv_len)."""
    from repro_torch.quant import quantize_kv
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    kq, ks, vq, vs = quantize_kv(rand(B, T, 8, 128).to(q_dtype),
                                 rand(B, T, 8, 128).to(q_dtype))
    return (rand(B, 24, 128).to(q_dtype), kq.transpose(1, 2),
            vq.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"))


def check_kv8_decode(chip) -> float:
    """Every valid gqa_decode_kv8 config against the plain version
    (dequantize, then the dense ragged decode) at phi4-mini's heads, q in
    bf16 and in f32: ragged lengths (with kv_len 0, 1 and past T) and the
    serving shape (B 8, T 544, every request at 528 tokens). Returns the
    worst error."""
    from repro_torch.kernels import ops, ref
    worst_all = 0.0
    for label, lens in (("ragged", ragged_lens(DENSE_T, 3)),
                        ("serving", [528] * 8)):
        for q_dtype in (torch.bfloat16, torch.float32):
            dt = ops.dtype_name(q_dtype)
            *args, kv_len = kv8_case(len(label) + q_dtype.itemsize, 8,
                                     DENSE_T, lens, q_dtype)
            tol = BF16_TOL if q_dtype == torch.bfloat16 else INT8_TOL
            want = ref.gqa_decode_kv8(*args, kv_len=kv_len).float()
            ctx = ops.gqa_decode_kv8_context(chip, 8, 24, 8, 128, DENSE_T, dt)
            configs = ops.GQA_DECODE_KV8.space.valid_configs(ctx)
            worst = 0.0
            for cfg in configs:
                got = ops.ragged_decode_kv8(*args, kv_len=kv_len,
                                            config=cfg).float()
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, atol=tol, rtol=tol) \
                        or (kv_len == 0).any() and got[0].any():
                    raise AssertionError(f"gqa_decode_kv8 {label} q {dt} "
                                         f"{cfg}: max abs err {err} over "
                                         f"tolerance {tol}")
                worst = max(worst, err)
            worst_all = max(worst_all, worst)
            print(f"gqa_decode_kv8 {label} q {dt} (B 8, 24/8 heads of 128, "
                  f"int8 T {DENSE_T}, lengths {lens}): {len(configs)} "
                  f"configs ok, max_abs_err {worst:.3g} (tol {tol})")
    return worst_all


def time_kv8(chip, cfg) -> dict:
    """Kernel (under ``cfg``), plain version, the library yardstick and the
    roofline bound at the kv8 serving shape: B 8, 24/8 heads of 128, bf16
    q, an int8 cache of T 544 with its f32 scales, every request at 528
    tokens. No single PyTorch call attends an int8 cache: the yardstick is
    SDPA over the cache dequantized to bf16 beforehand, the dequant not
    timed."""
    from repro_torch.core import KernelWorkload
    from repro_torch.kernels import ops, ref
    *args, kv_len = kv8_case(12, 8, DENSE_T, [528] * 8, torch.bfloat16)
    q, k, v, ks, vs = args
    kv_tokens = int(kv_len.sum())
    bound_ms, by = bound(KernelWorkload(
        ops.paged_decode_flops(24, 128, kv_tokens),
        ops.dense_decode_bytes(8, 24, 8, 128, kv_tokens, 1, q_itemsize=2,
                               scale_bytes=4), "bfloat16"), chip)
    kd = (k.float() * ks[..., None]).bfloat16()
    vd = (v.float() * vs[..., None]).bfloat16()
    mask = (torch.arange(DENSE_T, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None]
    fn = torch.nn.functional.scaled_dot_product_attention
    return {
        "kernel_ms": timer().time_runner(
            lambda: ops.ragged_decode_kv8(*args, kv_len=kv_len,
                                          config=cfg)) * 1e3,
        "plain_ms": timer().time_runner(
            lambda: ref.gqa_decode_kv8(*args, kv_len=kv_len)) * 1e3,
        "library_ms": timer().time_runner(
            lambda: fn(q[:, :, None], kd, vd, attn_mask=mask,
                       enable_gqa=True)) * 1e3,
        "library": "SDPA over the cache dequantized to bf16 beforehand "
                   "(dequant not timed)",
        "bound_ms": bound_ms, "bound_by": by, "kv_tokens": kv_tokens,
        "config": cfg}


def time_dense(chip, name: str, cfg, tuner) -> dict:
    """Kernel (under ``cfg``), plain version, SDPA over the same cache and
    the roofline bound at the serving shape: B 8, 24/8 heads of 128, T
    544, bf16, every request at 528 tokens (decode_attention, which takes
    no lengths in the reference's runner, attends all 544); then the
    kernel at the deployment shape (``dense_deployment``)."""
    from repro_torch.core import KernelWorkload
    from repro_torch.kernels import ops, ref
    ragged = name == "gqa_decode_ragged"
    q, k, v, kv_len = dense_case(11, 8, DENSE_T, [528] * 8, torch.bfloat16)
    if not ragged:
        kv_len = torch.full_like(kv_len, DENSE_T)
    entry = ops.ragged_decode if ragged else ops.decode
    kv_tokens = int(kv_len.sum())
    bound_ms, by = bound(KernelWorkload(
        ops.paged_decode_flops(24, 128, kv_tokens),
        ops.dense_decode_bytes(8, 24, 8, 128, kv_tokens, 2), "bfloat16"),
        chip)
    mask = (torch.arange(DENSE_T, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None]
    fn = torch.nn.functional.scaled_dot_product_attention
    return {
        "kernel_ms": timer().time_runner(
            lambda: entry(q, k, v, kv_len=kv_len, config=cfg)) * 1e3,
        "plain_ms": timer().time_runner(
            lambda: ref.gqa_decode(q, k, v, kv_len=kv_len)) * 1e3,
        "library_ms": timer().time_runner(
            lambda: fn(q[:, :, None], k, v, attn_mask=mask,
                       enable_gqa=True)) * 1e3,
        "bound_ms": bound_ms, "bound_by": by, "kv_tokens": kv_tokens,
        "config": cfg, "deployment": dense_deployment(chip, tuner, name)}


def dense_deployment(chip, tuner, name: str) -> dict:
    """``name`` at the shipped deployment shape of phi4-mini (16 requests
    of 32,768 slots, 24/8 heads of 128, bf16; gqa_decode_ragged at the
    runner's seed-7 lengths, decode_attention at all T) under its shipped
    config: held against the plain version within 2e-2 of the plain
    version's largest |o| (o there is a softmax-weighted mean of
    thousands of random rows, so an absolute 2e-2 could not see a lost
    split), and timed beside SDPA over the same cache and the bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    ragged = name == "gqa_decode_ragged"
    full = get_config("phi4-mini-3.8b")
    B, T = 16, 32768
    shape = (B, full.n_heads, full.n_kv_heads, full.head_dim, T, "bfloat16")
    tunable, ctx = ((ops.GQA_DECODE_RAGGED, ops.gqa_decode_context(
        chip, *shape)) if ragged else (ops.DECODE_ATTENTION,
                                       ops.decode_attention_context(
                                           chip, *shape)))
    cfg = tuner.best_config(tunable, ctx)
    run = tunable.make_runner(cfg, ctx)       # the tuner's own operands
    q, k, v = run.args
    lens = run.kwargs.get("kv_len")
    got = run().float()
    want = ref.gqa_decode(q, k, v, kv_len=lens).float()
    err = float((got - want).abs().max())
    limit = BF16_TOL * float(want.abs().max())
    del got, want
    if err > limit:
        raise AssertionError(f"{name} at the deployment shape {cfg}: max "
                             f"abs err {err} > {limit}")
    mask = None if lens is None else (
        torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, None]
    fn = torch.nn.functional.scaled_dot_product_attention
    bound_ms, by = bound(tunable.workload_fn(cfg, ctx), chip)
    out = {"config": cfg, "max_abs_err": err, "limit": limit,
           "kernel_ms": timer().time_runner(run) * 1e3,
           "library_ms": timer().time_runner(
               lambda: fn(q[:, :, None], k, v, attn_mask=mask,
                          enable_gqa=True)) * 1e3,
           "bound_ms": bound_ms, "bound_by": by}
    ops.release_tuning_operands()
    print(f"{name} at the deployment shape (B {B}, T {T}, "
          f"{'seed-7 lengths' if ragged else 'all T'}) under the shipped "
          f"config: " + json.dumps(out))
    return out


def one_launch(name: str, cfg) -> None:
    """One call of ``name`` at k_splits 8 (``paged_verify``: kv_splits 8;
    eight blocks a row in a cluster) under torch.profiler launches exactly
    one kernel: no combine, no workspace; two such calls give the same
    bits."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    if name == "paged_verify":
        ps, max_pages, K = 16, 36, cfg["draft_k"]
        args = paged_case(14, 8, 24, 8, 128, ps, max_pages,
                          verify_lens(ps * max_pages, K), torch.bfloat16, K)
        cfg = dict(cfg, page_size=ps, block_kv=16, kv_splits=8)

        def call():
            return ops.paged_verify(*args, config=cfg)
        kernel_name = "paged_verify_kernel"
    else:
        q, k, v, kv_len = dense_case(13, 8, DENSE_T,
                                     ragged_lens(DENSE_T, 3), torch.bfloat16)
        entry = ops.ragged_decode if name == "gqa_decode_ragged" \
            else ops.decode
        cfg = dict(cfg, k_splits=8, block_kv=32, num_warps=1)

        def call():
            return entry(q, k, v, kv_len=kv_len, config=cfg)
        kernel_name = "gqa_decode_kernel"
    one = call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        two = call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not torch.equal(one, two):
        raise AssertionError(f"{name} {cfg}: two calls differ")
    if len(kernels) != 1 or kernel_name not in kernels[0]:
        raise AssertionError(f"{name} {cfg}: launched {kernels}, not one "
                             f"kernel")
    print(f"{name} {cfg}: one kernel a call under the profiler "
          f"({kernels[0][:60]}), two calls bit-equal")


def one_launch_fresh(cfgs: dict) -> None:
    """``one_launch`` for each kernel name and its config, in a fresh
    process: in this script's own process, after the serving runs, the
    profiler's sessions saw no device events of these kernels (three chip
    runs), where a process's first session does."""
    code = ("import json, sys; sys.path.insert(0, %r); import chip_smoke; "
            "[chip_smoke.one_launch(n, c) for n, c in "
            "json.loads(sys.argv[1]).items()]" % REPO)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code, json.dumps(cfgs)],
                         env=env, capture_output=True, text=True,
                         timeout=600, check=False)
    print(res.stdout, end="")
    if res.returncode != 0:
        raise AssertionError(f"the one-launch check failed:\n{res.stderr}")


def timer_floor(chip, cfg) -> dict:
    """What the tuner's timer (``CudaEventTimer``: a flush that zeroes 4x
    the L2, the card spun ahead, events around one call) adds to a decode
    kernel at the serving shape, by this script's own CUDA events under
    the same protocol, median of 50: gqa_decode_ragged with every kv_len
    0 (one launch through the same ctypes path, clusters and barriers,
    that reads no key); a ``copy_`` of the bytes the kernel reads (17.3
    MB); and the kernel (every request at 528), SDPA and that copy after
    the zeroing flush and after a flush that reads the same buffer
    instead of writing it."""
    import statistics
    from repro_torch.core.measure import LEAD_CYCLES
    from repro_torch.kernels import ops
    q, k, v, kv_len = dense_case(11, 8, DENSE_T, [528] * 8, torch.bfloat16)
    empty = torch.zeros_like(kv_len)
    nbytes = int(kv_len.sum()) * 8 * 128 * 2 * 2
    src = torch.randn(nbytes // 2, device="cuda").bfloat16()
    dst = torch.empty_like(src)
    buf = timer()._flush_buffer()
    words = buf.view(torch.int32)
    flushes = {"zero": buf.zero_, "read": lambda: words.max()}
    mask = (torch.arange(DENSE_T, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None]
    fn = torch.nn.functional.scaled_dot_product_attention
    runs = {
        "kernel": lambda: ops.ragged_decode(q, k, v, kv_len=kv_len,
                                            config=cfg),
        "kernel_kv_len_0": lambda: ops.ragged_decode(q, k, v, kv_len=empty,
                                                     config=cfg),
        "sdpa": lambda: fn(q[:, :, None], k, v, attn_mask=mask,
                           enable_gqa=True),
        "copy": lambda: dst.copy_(src)}

    def ms(run, flush):
        for _ in range(5):
            run()
        samples = []
        for _ in range(50):
            flush()
            torch.cuda._sleep(LEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        return statistics.median(samples)

    out = {"config": cfg, "copy_bytes": 2 * nbytes}
    for flush in ("zero", "read"):
        for label, run in runs.items():
            out[f"{label}_ms_{flush}_flush"] = ms(run, flushes[flush])
    print("the timer's floor at the serving shape (own CUDA events, median "
          "of 50): " + json.dumps(out))
    return out


# phi4-mini's four w8a8 serving GEMMs, (M, K, N): the MLP's wi (d_model x
# 2 d_ff) and wo (d_ff x d_model) at decode's 8 rows and at the prefill's
# 8 x 512 rows, in the order ``serve.w8a8_contexts`` gives them
W8A8_SERVING = {"prefill wi": (4096, 3072, 16384),
                "prefill wo": (4096, 8192, 3072),
                "decode wi": (8, 3072, 16384), "decode wo": (8, 8192, 3072)}
# ragged shapes: rows inside one 16-row tile, past one and past two; a K
# that is not a multiple of 16 bytes; a column count off the 64-column grid
W8A8_RAGGED = [(M, K, N) for M in (8, 100, 257) for K in (200, 3072)
               for N in (96, 3072)]


def w8a8_case(seed, M, K, N, gran):
    """x (M, K) and w (K, N) drawn in f32 and quantized per row and per
    column (or per tensor) through ``quant.calibrate``, w K-major as
    ``QTensor`` stores it: (x, w, x_scale, w_scale)."""
    from repro_torch.quant import absmax_scale, quantize
    from repro_torch.quant.qtensor import k_major
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=g, device="cuda")
    w = torch.randn(K, N, generator=g, device="cuda")
    per_tensor = gran == "per_tensor"
    xs = absmax_scale(x, axis=None if per_tensor else -1)
    ws = absmax_scale(w, axis=None if per_tensor else 0)
    return quantize(x, xs), k_major(quantize(w, ws)), xs, ws


def check_matmul_w8a8(chip) -> float:
    """Every valid matmul_w8a8 config (epilogue and inline dequant) of each
    granularity against the plain version (dequantize, then an f32
    product) at INT8_TOL, atol and rtol, on the ragged shapes and the four
    serving shapes; the epilogue configs also equal the exact
    integer-grid product bit for bit (the sim path's arithmetic). Each
    case prints the kernel it took (``matmul_w8a8.path``): K 200 the
    mma.sync kernel, K 3072 and 8192 the wgmma one, asserted for the
    serving shapes. At decode wo, epilogue split_k 8 equals split_k 1 bit
    for bit. Then the refusals, with the C/Python shared-memory parity.
    Returns the worst error."""
    from repro_torch.kernels import matmul_w8a8 as mm8_kernel
    from repro_torch.kernels import ops, ref
    worst_all = 0.0
    shapes = [(f"ragged {M}x{K}x{N}", (M, K, N)) for M, K, N in W8A8_RAGGED]
    shapes += [(f"serving {k}", v) for k, v in W8A8_SERVING.items()]
    for label, (M, K, N) in shapes:
        for gran in ("per_channel", "per_tensor"):
            args = w8a8_case(M + K + N, M, K, N, gran)
            xq, wq, xs, ws = args
            want = ref.matmul_w8a8(*args)
            acc = xq.float() @ wq.float()
            exact = acc * (xs * ws) if gran == "per_tensor" else \
                acc * xs * ws
            ctx = ops.matmul_w8a8_context(chip, M, K, N, gran)
            configs = ops.MATMUL_W8A8.space.valid_configs(ctx)
            route = mm8_kernel.path(K, xq.data_ptr(), wq.data_ptr())
            before = dict(mm8_kernel.matmul_w8a8.path_launches)
            worst, n_exact = 0.0, 0
            for cfg in configs:
                got = ops.matmul_w8a8(*args, config=cfg)
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, atol=INT8_TOL,
                                      rtol=INT8_TOL):
                    raise AssertionError(f"matmul_w8a8 {label} {gran} {cfg}: "
                                         f"max abs err {err} over "
                                         f"tolerance {INT8_TOL}")
                if cfg["dequant"] == "epilogue":
                    if not torch.equal(got, exact):
                        raise AssertionError(
                            f"matmul_w8a8 {label} {gran} {cfg}: the "
                            f"epilogue differs from the exact integer-grid "
                            f"product")
                    n_exact += 1
                worst = max(worst, err)
            ran = mm8_kernel.matmul_w8a8.path_launches[route] - before[route]
            assert ran == len(configs), (label, route, ran)
            assert route == "wgmma" or not label.startswith("serving"), label
            worst_all = max(worst_all, worst)
            print(f"matmul_w8a8 {label} {gran} ({route}): {len(configs)} "
                  f"configs ok, max_abs_err {worst:.3g} (tol {INT8_TOL}); "
                  f"{n_exact} epilogue configs equal the exact product")
            del args, xq, wq, want, acc, exact
    args = w8a8_case(5, *W8A8_SERVING["decode wo"], "per_channel")
    cfg = {"block_m": 8, "block_n": 128, "block_k": 128, "num_stages": 4,
           "dequant": "epilogue"}
    one = mm8_kernel.matmul_w8a8(*args, split_k=1, **cfg)
    eight = mm8_kernel.matmul_w8a8(*args, split_k=8, **cfg)
    if not torch.equal(one, eight):
        raise AssertionError("matmul_w8a8 decode wo: epilogue split_k 8 "
                             "differs from split_k 1")
    print("matmul_w8a8 decode wo: epilogue split_k 8 equals split_k 1 bit "
          "for bit")
    x, w, xs, ws = w8a8_case(0, 16, 64, 64, "per_channel")
    for bad, match in (((x, w.contiguous(), xs, ws), "K-major"),
                       ((x.float(), w, xs, ws), "int8"),
                       ((x, w, xs[:8], ws), "per_channel scales")):
        try:
            mm8_kernel.matmul_w8a8(*bad)
        except ValueError as e:
            assert match in str(e), e
        else:
            raise AssertionError(f"matmul_w8a8 took what it refuses "
                                 f"({match})")
    lib = mm8_kernel.LIB.load()
    for bm, bn, bk in ((16, 64, 64), (128, 256, 128), (64, 128, 64)):
        assert lib.matmul_w8a8_smem_bytes(bm, bn, bk) == \
            mm8_kernel.smem_bytes(bm, bn, bk)
    for bm, bn, st in ((8, 64, 8), (128, 256, 4), (64, 128, 2)):
        assert lib.matmul_w8a8_wgmma_smem_bytes(bm, bn, st) == \
            mm8_kernel.wgmma_smem_bytes(bm, bn, st)
    for K, sk in ((8192, 8), (3072, 16), (200, 4)):
        assert lib.matmul_w8a8_splits(K, sk) == \
            mm8_kernel.effective_splits(K, sk)
    print("matmul_w8a8 refusals ok (a row-major w, float x, scales of the "
          "wrong size); C and Python shared memory and splits agree")
    return worst_all


def time_w8a8(chip, M, K, N, cfg) -> dict:
    """Kernel (under ``cfg``), plain version, the library yardsticks and the
    roofline bound at one serving GEMM, per channel. Yardsticks only, the
    port calls neither: ``torch._int_mm`` with the same scale epilogue
    (it refuses fewer than 17 rows: decode's 8 are timed padded to 32),
    and ``torch.matmul`` of the unquantized bf16 operands, which is what
    w8a8 replaces."""
    from repro_torch.kernels import matmul_w8a8 as mm8_kernel
    from repro_torch.kernels import ops, ref
    args = w8a8_case(M * 7 + N, M, K, N, "per_channel")
    xq, wq, xs, ws = args
    bound_ms, by = bound(ops._w8a8_workload(
        {"scale_gran": "per_channel"},
        ops.matmul_w8a8_context(chip, M, K, N)), chip)
    m_lib = max(M, 32)
    xl = torch.zeros(m_lib, K, dtype=torch.int8, device="cuda")
    xl[:M] = xq
    xsl = torch.ones(m_lib, 1, device="cuda")
    xsl[:M] = xs
    xb = (xq.float() * xs).bfloat16()
    wb = (wq.float() * ws).bfloat16().contiguous()
    out = {
        "kernel_ms": timer().time_runner(
            lambda: ops.matmul_w8a8(*args, config=cfg)) * 1e3,
        "plain_ms": timer().time_runner(
            lambda: ref.matmul_w8a8(*args)) * 1e3,
        "library_ms": timer().time_runner(
            lambda: torch._int_mm(xl, wq).float() * xsl * ws) * 1e3,
        "library": f"torch._int_mm plus the scale epilogue at M {m_lib}",
        "bf16_matmul_ms": timer().time_runner(lambda: xb @ wb) * 1e3,
        "bound_ms": bound_ms, "bound_by": by, "config": cfg,
        "path": mm8_kernel.path(K, xq.data_ptr(), wq.data_ptr())}
    assert out["path"] == "wgmma", out
    return out


# matmul's cases, (M, K, N): ragged shapes (every edge masked: rows, columns
# and K slices past the tile grid; K and N whose rows are only 2- or
# 8-byte aligned in bf16), decode-like rows, and the registry's m256
MATMUL_CASES = [(200, 300, 136), (37, 45, 29), (1000, 1030, 520),
                (8, 3072, 64), (256, 256, 256)]
MM8K = (8192, 8192, 8192)


def mm_case(seed, M, K, N, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(M, K, generator=g, device="cuda").to(dtype),
            torch.randn(K, N, generator=g, device="cuda").to(dtype))


def check_matmul(chip) -> dict:
    """Every valid matmul config against the plain version (an f32 product
    with TF32 off, cast to x's dtype) at MATMUL_CASES, in bf16 at
    BF16_TOL and in f32 at F32_TOL (atol and rtol: a bf16 output may
    round the other way by one unit in the last place); the refusals, and
    the C/Python shared-memory parity. Returns the worst error per
    dtype."""
    from repro_torch.kernels import matmul as mm_kernel
    from repro_torch.kernels import ops, ref
    worst_all = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[ops.dtype_name(dtype)]
        for M, K, N in MATMUL_CASES:
            x, y = mm_case(M + K + N, M, K, N, dtype)
            want = ref.matmul(x, y).float()
            ctx = ops.matmul_context(chip, M, K, N, ops.dtype_name(dtype))
            configs = ops.MATMUL.space.valid_configs(ctx)
            route = mm_kernel.path(dtype, K, N, x.data_ptr(), y.data_ptr())
            before = mm_kernel.matmul.path_launches[route]
            worst = 0.0
            for cfg in configs:
                got = ops.matmul(x, y, config=cfg)
                assert got.dtype == dtype and got.shape == (M, N)
                got = got.float()
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, atol=tol, rtol=tol):
                    raise AssertionError(f"matmul {M}x{K}x{N} {dtype} {cfg}: "
                                         f"max abs err {err} over tolerance "
                                         f"{tol}")
                worst = max(worst, err)
            worst_all[ops.dtype_name(dtype)] = max(
                worst_all.get(ops.dtype_name(dtype), 0.0), worst)
            assert mm_kernel.matmul.path_launches[route] - before == \
                len(configs), route
            ragged = (K * 2) % 16 or (N * 2) % 16
            assert route == ("fma" if dtype == torch.float32 else
                             "mma_sync" if ragged else "wgmma"), route
            print(f"matmul {M}x{K}x{N} {ops.dtype_name(dtype)} ({route}): "
                  f"{len(configs)} configs ok, max_abs_err {worst:.4g} "
                  f"(atol and rtol {tol}; largest |out| "
                  f"{float(want.abs().max()):.4g})")
    x, y = mm_case(0, 64, 64, 64, torch.bfloat16)
    for bad, match in (((x.half(), y.half()), "float16"),
                       ((x, y.t()), "contiguous"),
                       ((x, y.float()), "differ")):
        try:
            mm_kernel.matmul(*bad)
        except ValueError as e:
            assert match in str(e), e
        else:
            raise AssertionError(f"matmul took what it refuses ({match})")
    lib = mm_kernel.LIB.load()
    for args in ((2, 64, 64, 32, 2), (2, 256, 128, 64, 4),
                 (4, 128, 256, 32, 3)):
        assert lib.matmul_smem_bytes(*args) == mm_kernel.smem_bytes(*args)
    for args in ((64, 64, 2), (128, 256, 3), (128, 128, 4)):
        assert lib.matmul_wgmma_smem_bytes(*args) == \
            mm_kernel.wgmma_smem_bytes(*args)
    print("matmul refusals ok (float16, a transposed y, mixed dtypes); C "
          "and Python shared memory agree")
    return worst_all


def time_matmul(chip, M, K, N, dtype, cfg) -> dict:
    """Kernel (under ``cfg``), plain version, the library yardstick and the
    roofline bound at one shape; the yardstick, which the port never
    calls, is ``torch.matmul`` (cuBLAS) on the same operands."""
    from repro_torch.kernels import matmul as mm_kernel
    from repro_torch.kernels import ops, ref
    x, y = mm_case(7, M, K, N, dtype)
    ctx = ops.matmul_context(chip, M, K, N, ops.dtype_name(dtype))
    bound_ms, by = bound(ops.MATMUL.workload_fn(cfg, ctx), chip)
    got = ops.matmul(x, y, config=cfg).float()
    want = ref.matmul(x, y).float()
    tol = TOL[ops.dtype_name(dtype)]
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"matmul {M}x{K}x{N} {cfg}: over tolerance")
    return {
        "kernel_ms": timer().time_runner(
            lambda: ops.matmul(x, y, config=cfg)) * 1e3,
        "plain_ms": timer().time_runner(lambda: ref.matmul(x, y)) * 1e3,
        "library_ms": timer().time_runner(lambda: torch.matmul(x, y)) * 1e3,
        "bound_ms": bound_ms, "bound_by": by, "config": cfg,
        "max_abs_err": float((got - want).abs().max()),
        "path": mm_kernel.path(dtype, K, N, x.data_ptr(), y.data_ptr())}


# flash_attention's cases, (label, B, Hq, Hkv, Sq, Skv, D, dtype, causal,
# window, q_offset): the serving prefill, ragged lengths, groups 1, 3 and 4,
# D 96 and 120, D 160 at stablelm's 32/8 heads and D 256 (three and four
# 64-column blocks of D, TMA zero-filling D 160's last), windows of 16 and
# 100, a query offset, non-causal, f32 at F32_TOL (TF32 off), and rows that
# see no key inside running tiles; every case with its lse
FLASH_SERVING = (8, 24, 8, 512, 512, 128)
FLASH_CASES = [
    ("serving", *FLASH_SERVING, torch.bfloat16, True, None, 0),
    ("ragged f32 group 4 window 100", 2, 8, 2, 200, 333, 128, torch.float32,
     True, 100, 0),
    ("ragged group 1 D 96", 2, 8, 8, 333, 200, 96, torch.bfloat16, True,
     None, 0),
    ("D 120 group 3 window 16", 2, 12, 4, 300, 300, 120, torch.bfloat16,
     True, 16, 0),
    ("f32 D 96 q_offset 211", 2, 6, 2, 77, 300, 96, torch.float32, True,
     None, 211),
    ("non-causal group 4 D 64", 2, 8, 2, 200, 333, 64, torch.bfloat16,
     False, None, 0),
    ("non-causal f32 window 100 q_offset 30", 1, 4, 1, 128, 200, 128,
     torch.float32, False, 100, 30),
    ("rows with no visible key", 1, 8, 2, 64, 40, 128, torch.bfloat16, True,
     16, 40),
    ("stablelm D 160 ragged", 1, 32, 8, 300, 300, 160, torch.bfloat16, True,
     None, 0),
    ("D 256 group 2", 1, 4, 2, 200, 200, 256, torch.bfloat16, True, None, 0),
]


def flash_case(seed, B, Hq, Hkv, Sq, Skv, D, dtype):
    """q, k, v as (B, H, S, D) views of (B, S, H, D) tensors, as the
    prefill hands them to the kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
    return (rand(B, Sq, Hq, D).transpose(1, 2),
            rand(B, Skv, Hkv, D).transpose(1, 2),
            rand(B, Skv, Hkv, D).transpose(1, 2))


def check_flash_attention(chip) -> float:
    """Every valid flash_attention config against the plain version on the
    card at FLASH_CASES: o and lse within the dtype's tolerance, rows with
    no visible key exactly zero with lse -1e30; the heuristic config timed
    at the serving shape. Returns the worst error."""
    from repro_torch.kernels import ops, ref
    worst_all = 0.0
    for label, B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, q_offset \
            in FLASH_CASES:
        q, k, v = flash_case(Sq + D, B, Hq, Hkv, Sq, Skv, D, dtype)
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  return_lse=True)
        want, want_lse = ref.flash_attention(q, k, v, **kw)
        want = want.float()
        empty = want_lse[0, 0] <= -1e30
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        ctx = ops.attention_context(chip, B, Hq, Hkv, Sq, Skv, D,
                                    ops.dtype_name(dtype), causal, window)
        configs = ops.FLASH_ATTENTION.space.valid_configs(ctx)
        if not configs:
            raise AssertionError(f"flash_attention {label}: no valid config")
        worst = 0.0
        for cfg in configs:
            got, lse = ops.attention(q, k, v, config=cfg, **kw)
            got = got.float()
            err = max(float((got - want).abs().max()),
                      float((lse - want_lse).abs().max()))
            if not (torch.allclose(got, want, atol=tol, rtol=tol)
                    and torch.allclose(lse, want_lse, atol=tol, rtol=tol)) \
                    or got[:, :, empty].any() \
                    or not (lse[:, :, empty] == -1e30).all():
                raise AssertionError(f"flash_attention {label} {cfg}: max "
                                     f"abs err {err} over tolerance {tol}")
            worst = max(worst, err)
        worst_all = max(worst_all, worst)
        print(f"flash_attention {label} (B {B}, {Hq}/{Hkv} heads of {D}, Sq "
              f"{Sq}, Skv {Skv}, {ops.dtype_name(dtype)}, causal {causal}, "
              f"window {window}, q_offset {q_offset}; {int(empty.sum())} "
              f"rows see no key): {len(configs)} configs ok, max_abs_err "
              f"{worst:.3g} (o and lse, tol {tol})")
        if label == "serving":
            heur = ops.FLASH_ATTENTION.default_config(ctx)
            print(f"  heuristic {heur}: " + json.dumps(time_flash(chip, heur)))
    return worst_all


def time_flash(chip, cfg, shape=FLASH_SERVING) -> dict:
    """Kernel (under ``cfg``), plain version, the library yardstick and the
    roofline bound of the causal forward at ``shape`` (B, Hq, Hkv, Sq, Skv,
    D; by default the serving prefill: B 8, 24/8 heads of 128, Sq = Skv =
    512), bf16, q, k, v as the prefill's views. Yardstick only, the port
    never calls it: SDPA with ``is_causal`` and GQA on the same views."""
    from repro_torch.core import KernelWorkload
    from repro_torch.kernels import ops, ref
    B, Hq, Hkv, Sq, Skv, D = shape
    q, k, v = flash_case(3, B, Hq, Hkv, Sq, Skv, D, torch.bfloat16)
    bound_ms, by = bound(KernelWorkload(
        ops.flash_attention_flops(B, Hq, D,
                                  ops.attention_pairs(Sq, Skv, True)),
        ops.flash_attention_bytes(B, Hq, Hkv, Sq, Skv, D, 2), "bfloat16"),
        chip)
    fn = torch.nn.functional.scaled_dot_product_attention

    def plain():
        # one call, or one batch row a call where the f32 scores of the
        # whole batch would not fit the card beside the rest (train4k)
        if B * Hq * Sq * Skv * 4 <= 4 << 30:
            return ref.flash_attention(q, k, v)
        return [ref.flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1])
                for b in range(B)]

    return {
        "kernel_ms": timer().time_runner(
            lambda: ops.attention(q, k, v, config=cfg)) * 1e3,
        "plain_ms": timer().time_runner(plain) * 1e3,
        "library_ms": timer().time_runner(
            lambda: fn(q, k, v, is_causal=True, enable_gqa=True)) * 1e3,
        "bound_ms": bound_ms, "bound_by": by, "config": cfg}


# flash_attention_bwd's cases, FLASH_CASES' columns: the training step's
# shape (B 4, phi4-mini's 24/8 heads of 128, 512 tokens); Sq 200 (not a tile
# multiple); groups 1, 3 and 4 at D 96, 120 and 64; a window; a query
# offset; non-causal; f32; rows that see no key (their dq exactly zero)
TRAIN_SHAPE = (4, 24, 8, 512, 512, 128)
TRAIN4K = (8, 32, 8, 4096, 4096, 128)
FLASH_BWD_CASES = [
    ("training step", *TRAIN_SHAPE, torch.bfloat16, True, None, 0),
    ("Sq 200 group 3", 2, 24, 8, 200, 200, 128, torch.bfloat16, True, None,
     0),
    ("group 1 D 96", 2, 8, 8, 333, 333, 96, torch.bfloat16, True, None, 0),
    ("group 3 D 120 window 16", 2, 12, 4, 300, 300, 120, torch.bfloat16,
     True, 16, 0),
    ("group 4 D 64 q_offset 211 f32", 2, 8, 2, 77, 300, 64, torch.float32,
     True, None, 211),
    ("non-causal group 4 D 64", 2, 8, 2, 200, 333, 64, torch.bfloat16,
     False, None, 0),
    ("f32 D 128 window 100", 2, 8, 2, 200, 333, 128, torch.float32, True,
     100, 0),
    ("rows with no visible key", 1, 8, 2, 64, 40, 128, torch.bfloat16, True,
     16, 40),
]


def check_flash_attention_bwd(chip) -> float:
    """Every valid flash_attention_bwd config against the plain version on
    the card at FLASH_BWD_CASES: dq, dk and dv each within the dtype's
    tolerance (elementwise, atol and rtol), rows with no visible key
    exactly zero in dq, two launches of one config bit-equal (no atomics).
    Returns the worst absolute error."""
    from repro_torch.kernels import flash_attention_bwd as fab_kernel
    from repro_torch.kernels import ops, ref
    worst_all = 0.0
    for label, B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, q_offset \
            in FLASH_BWD_CASES:
        q, k, v = flash_case(Sq + D + 1, B, Hq, Hkv, Sq, Skv, D, dtype)
        do = flash_case(Sq + D + 2, B, Hq, Hkv, Sq, Skv, D, dtype)[0]
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        o, lse = ref.flash_attention(q, k, v, return_lse=True, **kw)
        want = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        empty = lse[0, 0] <= -1e30
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        ctx = ops.attention_context(chip, B, Hq, Hkv, Sq, Skv, D,
                                    ops.dtype_name(dtype), causal, window)
        configs = ops.FLASH_ATTENTION_BWD.space.valid_configs(ctx)
        if not configs:
            raise AssertionError(f"flash_attention_bwd {label}: no valid "
                                 f"config")
        worst, worst_rel = 0.0, 0.0
        for cfg in configs:
            got = fab_kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw,
                                                 **cfg)
            again = fab_kernel.flash_attention_bwd(q, k, v, o, lse, do,
                                                   **kw, **cfg)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                if not torch.allclose(g.float(), w.float(), atol=tol,
                                      rtol=tol):
                    err = float((g.float() - w.float()).abs().max())
                    raise AssertionError(f"flash_attention_bwd {label} "
                                         f"{cfg}: {name} max abs err {err} "
                                         f"over tolerance {tol}")
            if got[0][:, :, empty].any():
                raise AssertionError(f"flash_attention_bwd {label} {cfg}: "
                                     f"rows that see no key have dq != 0")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd {label} {cfg}: "
                                     f"two launches differ")
            for g, w in zip(got, want):
                err = float((g.float() - w.float()).abs().max())
                worst = max(worst, err)
                worst_rel = max(worst_rel, err / float(w.float().abs().max()))
        worst_all = max(worst_all, worst)
        print(f"flash_attention_bwd {label} (B {B}, {Hq}/{Hkv} heads of {D}, "
              f"Sq {Sq}, Skv {Skv}, {ops.dtype_name(dtype)}, causal "
              f"{causal}, window {window}, q_offset {q_offset}; "
              f"{int(empty.sum())} rows see no key): {len(configs)} configs "
              f"ok, max_abs_err {worst:.3g} ({worst_rel:.3g} of the largest "
              f"gradient; tol {tol}, elementwise)")
    return worst_all


def time_flash_bwd(chip, shape, cfg) -> dict:
    """Kernel (under ``cfg``), plain version, the library yardstick and the
    roofline bound of the causal backward at ``shape`` (B, Hq, Hkv, Sq,
    Skv, D) in bf16, on the registry's operands (q, k, v, do as the
    training step's (B, S, H, D) views, o and lse from the forward kernel).
    Yardstick only, the port never calls it: ``torch.autograd.grad``
    through SDPA with ``is_causal`` and GQA, its forward's graph retained,
    so the backward alone is timed."""
    from repro_torch.core import KernelWorkload
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.registry import get_kernel
    B, Hq, Hkv, Sq, Skv, D = shape
    ctx = ops.attention_context(chip, B, Hq, Hkv, Sq, Skv, D, "bfloat16")
    (q, k, v, o, lse, do), kw = get_kernel("flash_attention_bwd").operands(
        ctx, cfg, "cuda")
    pairs = ops.attention_pairs(Sq, Skv, True)
    bound_ms, by = bound(KernelWorkload(
        ops.flash_attention_bwd_flops(B, Hq, D, pairs),
        ops.flash_attention_bwd_bytes(B, Hq, Hkv, Sq, Skv, D, 2),
        "bfloat16"), chip)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, enable_gqa=True)
    res = {
        "kernel_ms": timer().time_runner(
            lambda: ops.attention_bwd(q, k, v, o, lse, do, config=cfg,
                                      **kw)) * 1e3,
        "plain_ms": timer().time_runner(
            lambda: ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)) * 1e3,
        "library_ms": timer().time_runner(
            lambda: torch.autograd.grad(out, leaves, do,
                                        retain_graph=True)) * 1e3,
        "bound_ms": bound_ms, "bound_by": by, "config": cfg}
    del out, leaves
    return res


def tune_and_time_flash_bwd(tuner, chip, bwd_err: float) -> dict:
    """The train launcher's ``--attn-impl pallas`` contexts at the training
    step (``train.attention_contexts``: flash_attention and
    flash_attention_bwd over B 4, 512 tokens) and the registry's
    ``train4k`` tuned for both kernels; the backward and the forward timed
    at both beside the plain version, SDPA and the bound. Returns the
    backward's numbers at the training shape with ``train4k``'s beside
    them."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.registry import get_kernel
    from repro_torch.launch import train
    t = time.perf_counter()
    cfgs = [tuner.best_config(tunable, ctx) for tunable, ctx in
            train.attention_contexts(get_config("phi4-mini-3.8b"), 4, 512,
                                     torch.device("cuda"))]
    ((case, ctx),) = [(c, c.context(chip)) for c in
                      get_kernel("flash_attention_bwd").cases("paper")]
    cfg4k = tuner.best_config(ops.FLASH_ATTENTION_BWD, ctx)
    print(f"flash_attention and flash_attention_bwd at the training step, "
          f"and flash_attention_bwd at {case.label}, tuned in "
          f"{time.perf_counter() - t:.1f} s: {cfgs} {cfg4k}")
    bwd = time_flash_bwd(chip, TRAIN_SHAPE, cfgs[1])
    bwd["max_abs_err"] = bwd_err
    print("flash_attention_bwd at the training step (B 4, 24/8 heads of "
          "128, 512 tokens, bf16, causal): " + json.dumps(bwd))
    big = time_flash_bwd(chip, TRAIN4K, cfg4k)
    print(f"flash_attention_bwd at {case.label} ({dict(ctx.shapes)}, bf16, "
          f"causal): " + json.dumps(big))
    bwd[case.label] = big
    # the forward at the same two shapes: the training step's tuned config
    # and train4k's, tuned here
    print("flash_attention at the training step (B 4, 24/8 heads of 128, "
          "512 tokens, bf16, causal): "
          + json.dumps(time_flash(chip, cfgs[0], TRAIN_SHAPE)))
    fwd4k = tuner.best_config(ops.FLASH_ATTENTION, ctx)
    print(f"flash_attention at {case.label} ({dict(ctx.shapes)}, bf16, "
          f"causal): " + json.dumps(time_flash(chip, fwd4k, TRAIN4K)))
    ops.release_tuning_operands()
    return bwd


# mla_decode at deepseek-v2-lite's widths: B 8, 16 heads, latent rank 512,
# RoPE keys of 64, a cache of 544 rows (prompts of 512 + 32 new tokens);
# ragged lengths with 0 (zeros) and past T (the whole cache)
DSV2 = "deepseek-v2-lite-16b"
MLA_SERVING = (8, 16, 512, 64, DENSE_T)
MLA_RAGGED = [0, 1, 17, 300, 528, 544, 600, 333]


def mla_case(seed, B, H, C, R, T, dtype, pad=0):
    """q_abs, q_rope, and ckv, krope as the first T rows of caches ``pad``
    rows longer (0: the contiguous cache the decode step hands over)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
    return (rand(B, H, C), rand(B, H, R), rand(B, T + pad, C)[:, :T],
            rand(B, T + pad, R)[:, :T])


def check_mla_decode(chip) -> float:
    """Every valid mla_decode config against the plain version
    (``ref.mla_decode_ragged``) at deepseek-v2-lite's widths with ragged
    lengths in bf16 and f32 (on caches 8 rows longer than T), at the
    serving decode (every request at 528 of 544) in bf16, and at 4 heads
    of rank 64 with RoPE keys of 16 (rows padded to 16) in both dtypes:
    within the dtype's tolerance, requests with kv_len 0 exactly zero.
    Returns the worst error."""
    from repro_torch.kernels import ops, ref
    small = (3, 4, 64, 16, 200)
    cases = [("ragged bf16", MLA_SERVING, MLA_RAGGED, torch.bfloat16, 8),
             ("ragged f32", MLA_SERVING, MLA_RAGGED, torch.float32, 8),
             ("serving bf16", MLA_SERVING, [528] * 8, torch.bfloat16, 0),
             ("H 4 C 64 bf16", small, [0, 137, 250], torch.bfloat16, 8),
             ("H 4 C 64 f32", small, [0, 137, 250], torch.float32, 8)]
    worst_all = 0.0
    for label, shape, lens, dtype, pad in cases:
        B, H, C, R, T = shape
        args = mla_case(len(label), *shape, dtype, pad)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        scale = (C + R) ** -0.5
        want = ref.mla_decode_ragged(*args, kv_len=kv_len, scale=scale)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        ctx = ops.mla_decode_context(chip, *shape, ops.dtype_name(dtype))
        configs = ops.MLA_DECODE.space.valid_configs(ctx)
        if not configs:
            raise AssertionError(f"mla_decode {label}: no valid config")
        empty = kv_len == 0
        worst = 0.0
        for cfg in configs:
            got = ops.latent_decode(*args, kv_len=kv_len, scale=scale,
                                    config=cfg)
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=tol, rtol=tol) \
                    or got[empty].any():
                raise AssertionError(f"mla_decode {label} {cfg}: max abs "
                                     f"err {err} over tolerance {tol}")
            worst = max(worst, err)
        worst_all = max(worst_all, worst)
        print(f"mla_decode {label} (B {B}, {H} heads, rank {C}, rope {R}, "
              f"T {T}, lengths {lens}): {len(configs)} configs ok, "
              f"max_abs_err {worst:.3g} (tol {tol})")
    return worst_all


def time_mla(chip, cfg, B, H, C, R, T, lens) -> dict:
    """Kernel (under ``cfg``), plain version, the library yardstick and the
    roofline bound of one mla_decode call in bf16 at the model's scale
    (C + R)^-0.5 over a contiguous cache, as the decode step hands it
    over. Yardstick only, the port never calls it: SDPA of cat(q_abs,
    q_rope) against cat(ckv, krope) with v = ckv, one KV head
    (``enable_gqa``) and a length mask, the concatenations not timed."""
    from repro_torch.core import KernelWorkload
    from repro_torch.kernels import ops, ref
    args = mla_case(T + 1, B, H, C, R, T, torch.bfloat16)
    qa, qr, ckv, kr = args
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = (C + R) ** -0.5
    kv_tokens = int(torch.clamp(kv_len, max=T).sum())
    bound_ms, by = bound(KernelWorkload(
        ops.mla_decode_flops(H, C, R, kv_tokens),
        ops.mla_decode_bytes(B, H, C, R, kv_tokens, 2), "bfloat16"), chip)
    q = torch.cat([qa, qr], -1)[:, :, None]              # (B, H, 1, C + R)
    k = torch.cat([ckv, kr], -1)[:, None]                # (B, 1, T, C + R)
    v = ckv[:, None]
    mask = (torch.arange(T, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None]
    fn = torch.nn.functional.scaled_dot_product_attention
    out = {
        "kernel_ms": timer().time_runner(
            lambda: ops.latent_decode(*args, kv_len=kv_len, scale=scale,
                                      config=cfg)) * 1e3,
        "plain_ms": timer().time_runner(
            lambda: ref.mla_decode_ragged(*args, kv_len=kv_len,
                                          scale=scale)) * 1e3,
        "library_ms": timer().time_runner(
            lambda: fn(q, k, v, attn_mask=mask, scale=scale,
                       enable_gqa=True)) * 1e3,
        "library": "SDPA of cat(q_abs, q_rope) against cat(ckv, krope), "
                   "v = ckv, one KV head, a length mask (cat not timed)",
        # the same call with the heads as one KV head's query rows: no GQA
        # expansion of the cache (a second yardstick, printed only)
        "library_heads_as_rows_ms": timer().time_runner(
            lambda: fn(q.transpose(1, 2), k, v, attn_mask=mask,
                       scale=scale)) * 1e3,
        "bound_ms": bound_ms, "bound_by": by, "kv_tokens": kv_tokens,
        "config": cfg}
    del args, qa, qr, ckv, kr, q, k, v
    return out


def tune_and_time_mla(tuner, chip, mla_err: float) -> dict:
    """deepseek-v2-lite's serving context (``serve.mla_context``: B 8, T
    544) and the registry's ``dsv2_32k`` (B 8, T 32768, every request
    attending all of it) tuned, then timed under the tuned configs.
    Returns the serving shape's numbers with ``dsv2_32k``'s beside
    them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.registry import get_kernel
    from repro_torch.launch import serve
    t = time.perf_counter()
    cfg = tuner.best_config(*serve.mla_context(
        serve.get_config(DSV2), 8, DENSE_T, torch.device("cuda")))
    ((case, ctx),) = [(c, c.context(chip))
                      for c in get_kernel("mla_decode").cases("paper")]
    cfg32 = tuner.best_config(ops.MLA_DECODE, ctx)
    tune_s = time.perf_counter() - t
    mlak = time_mla(chip, cfg, *MLA_SERVING, [528] * 8)
    mlak["max_abs_err"] = mla_err
    print(f"mla_decode at the serving decode (every request at 528 of "
          f"{DENSE_T}; both contexts tuned in {tune_s:.1f} s): "
          + json.dumps(mlak))
    B, H, C = ctx.shape("q_abs")
    T, R = ctx.shape("ckv")[1], ctx.shape("q_rope")[2]
    big = time_mla(chip, cfg32, B, H, C, R, T, [T] * B)
    print(f"mla_decode at {case.label} ({dict(ctx.shapes)}, bf16, all "
          f"{T} keys): " + json.dumps(big))
    mlak[case.label] = {k: big[k] for k in ("kernel_ms", "plain_ms",
                                            "library_ms", "bound_ms",
                                            "bound_by", "config")}
    ops.release_tuning_operands()
    return mlak


@functools.lru_cache(maxsize=1)
def dsv2_model():
    """deepseek-v2-lite-16b at full width from the launcher's seed (0): the
    weights the MLA serving runs had."""
    from repro_torch.configs import get_config
    from repro_torch.models.param import init_params
    cfg = get_config(DSV2)
    return init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                       "cuda"), cfg


def mla_dense_serving(tuner) -> dict:
    """The launcher's static batch of deepseek-v2-lite-16b at full width (8
    prompts of 512, 32 new tokens, bf16, prefill by chunked attention),
    by ``--decode-impl pallas`` (mla_decode once a layer and decode step,
    27 x 31, and no other kernel) and ``full`` (no kernel), and by
    ``full`` after ``--attn-impl full``, the reference's other exact
    prefill: how many streams each pair shares, tokens/s, prefill ms and
    peak memory. Each run makes its own weights and frees them. Returns the
    kernel run's report and launch counts, and the runs' tokens."""
    from repro_torch.kernels import flash_attention as fa_kernel
    from repro_torch.kernels import gqa_decode as gqa_kernel
    from repro_torch.kernels import mla_decode as mla_kernel
    from repro_torch.launch import serve
    cfg, cuda = serve.get_config(DSV2), torch.device("cuda")
    assert (cfg.n_layers, cfg.d_model, cfg.moe.n_experts) == (27, 2048, 64)
    tuner.best_config(*serve.mla_context(cfg, 8, DENSE_T, cuda))
    counters = {"mla_decode": mla_kernel.mla_decode,
                "gqa_decode_ragged": gqa_kernel.gqa_decode,
                "flash_attention": fa_kernel.flash_attention}
    runs = {}
    for label, extra in (("pallas", ["--decode-impl", "pallas"]),
                         ("full", ["--decode-impl", "full"]),
                         ("full, full prefill", ["--decode-impl", "full",
                                                 "--attn-impl", "full"])):
        for fn in counters.values():
            fn.launches = 0
        args = serve.build_parser().parse_args(
            ["--arch", DSV2, "--full-config", "--requests", "8",
             "--prompt-len", "512", "--gen", "32"] + extra)
        report = serve.serve_dense(args, tuner)
        launches = {k: fn.launches for k, fn in counters.items()}
        runs[label] = (report, launches)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{DSV2} dense run report ({' '.join(extra)}): "
              + json.dumps({k: v for k, v in report.items() if k != "tokens"},
                           sort_keys=True))
        print(f"launches in the run ({' '.join(extra)}): "
              f"{json.dumps(launches)}")
        assert report["launches"]["mla_decode"] == launches["mla_decode"]
        assert np.asarray(report["tokens"]).shape == (8, 32)
    (kernel, kl), (plain, pl), (other, ol) = runs.values()
    assert kl["mla_decode"] == 31 * cfg.n_layers == 837, kl
    assert sum(kl.values()) == kl["mla_decode"], kl
    assert sum(pl.values()) == sum(ol.values()) == 0, (pl, ol)
    for a, b, pair in ((kernel, plain, "pallas vs full"),
                       (other, plain, "full after the full prefill vs full "
                                      "after the chunked one (the "
                                      "reference's own spread)")):
        firsts = [next((j for j, (x, y) in enumerate(zip(ra, rb)) if x != y),
                       None) for ra, rb in zip(a["tokens"], b["tokens"])]
        print(f"{DSV2} {pair}: {firsts.count(None)}/8 token streams equal; "
              f"first differing token of each request: {firsts}")
    print(f"{DSV2} at full width, --decode-impl pallas / full: prefill "
          f"{kernel['prefill_ms']:.1f} / {plain['prefill_ms']:.1f} ms, "
          f"decode {kernel['decode_ms']:.1f} / {plain['decode_ms']:.1f} ms, "
          f"tokens/s {kernel['tokens_per_s']:.1f} / "
          f"{plain['tokens_per_s']:.1f}, peak memory "
          f"{kernel['peak_memory_bytes'] / 2**30:.2f} / "
          f"{plain['peak_memory_bytes'] / 2**30:.2f} GiB")
    return {"report": kernel, "launches": kl}


@contextlib.contextmanager
def mla_attention_pairs(out: list):
    """Every MLA decode attention the plain path runs inside is also run by
    mla_decode on the same input and cache (it writes the same new latent
    into the same slot first), and the relative L2 between the two
    attention outputs is recorded, layer by layer, into ``out``: the
    kernel held on the reference path's own inputs, with no other
    difference carried in from earlier layers. The port's code is
    unchanged: ``attention._mla_decode`` is wrapped for the duration."""
    from repro_torch.models import attention as ATT
    real = ATT._mla_decode

    def paired(p, x, cfg, cache, pos, *, impl):
        if impl != "plain":
            return real(p, x, cfg, cache, pos, impl=impl)
        kernel, _ = real(p, x, cfg, cache, pos, impl="kernel")
        plain, cache = real(p, x, cfg, cache, pos, impl="plain")
        out.append(rel_l2(kernel, plain))
        return plain, cache

    ATT._mla_decode = paired
    try:
        yield out
    finally:
        ATT._mla_decode = real


def mla_step_check(model, cfg, steps: int = 8) -> None:
    """One full-width deepseek-v2-lite-16b decode step (8 requests at
    position 512 after a chunked prefill of 512 tokens):

    * mla_decode against the reference's einsum on the reference path's
      own inputs at each of the 27 layers (``mla_attention_pairs``): the
      attention outputs within BF16_TOL relative L2, every layer;
    * the whole step through mla_decode against the step through the
      einsum on clones of one latent cache, logits held by
      ``hold_logits``. The random 27-layer MoE turns rounding-level
      differences into O(1) ones wherever a top-6 routing choice flips, so
      the relative L2 is held within BF16_TOL or, where wider, 1.1x the
      reference's own spread between two exact computations of the same
      logits: this decode step and a prefill of the prompts with the
      step's token appended (the rule of ``prefill_check``); the greedy
      tokens by the tie rule as everywhere. The expert choices that
      differ between the two steps and the residual stream are printed;
    * a profiled window of kernel steps."""
    from repro_torch.models import lm
    rng = np.random.default_rng(9)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (8, 512))).cuda()
    chunked = lm.ForwardOpts(attn_chunk=64)
    _, cache = lm.prefill(model, cfg, prompts, max_len=512 + 2 * steps + 2,
                          opts=chunked)
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, (8, 1))).cuda()
    caches = {"kernel": [{k: v.clone() for k, v in layer.items()}
                         for layer in cache], "plain": cache}
    layers = []
    with mla_attention_pairs(layers):
        lm.decode_step(model, cfg, tok,
                       [{k: v.clone() for k, v in layer.items()}
                        for layer in cache], 512,
                       lm.ForwardOpts(decode_impl="plain"))
    print(f"{cfg.name}: mla_decode vs the einsum on the same inputs, "
          f"attention output relative L2 by layer (tol {BF16_TOL}): "
          f"max {max(layers):.3g}; {[float(f'{e:.3g}') for e in layers]}")
    assert len(layers) == cfg.n_layers, len(layers)
    if max(layers) > BF16_TOL:
        raise AssertionError(f"mla_decode's attention output at full width "
                             f"differs from the einsum's by {max(layers)}")
    logits, streams = {}, {"kernel": {}, "plain": {}}
    routes = {"kernel": [], "plain": []}
    for path in ("kernel", "plain"):
        with residual_streams(model, streams[path]), \
                routing_record(routes[path]):
            logits[path], _ = lm.decode_step(
                model, cfg, tok, caches[path], 512,
                lm.ForwardOpts(decode_impl=path))
    flips = [int((a != b).any(-1).sum())
             for a, b in zip(routes["kernel"], routes["plain"])]
    print(f"{cfg.name} decode step: residual stream, relative L2 after "
          f"layer {stream_errors(streams['kernel'], streams['plain'])}; "
          f"MoE rows whose top-6 experts differ between the paths, by MoE "
          f"layer: {flips} ({sum(flips)} of {len(flips) * 8})")
    prefilled, _ = lm.prefill(model, cfg, torch.cat([prompts, tok], 1),
                              max_len=513, opts=chunked)
    spread = rel_l2(prefilled, logits["plain"])
    print(f"  the reference's own spread: this step's logits against a "
          f"prefill of the prompts with the token appended, relative L2 "
          f"{spread:.4g}; the step through mla_decode against the prefill "
          f"{rel_l2(prefilled, logits['kernel']):.4g}")
    hold_logits(f"{cfg.name} dense decode step, mla_decode vs plain "
                f"einsum, 8 requests at position 512", logits["kernel"],
                logits["plain"], rel_tol=max(BF16_TOL, 1.1 * spread))
    del streams, prefilled
    for path, what in (("kernel", "mla_decode"), ("plain", "the einsum")):
        opts = lm.ForwardOpts(decode_impl=path)
        by_name = profile_steps(
            f"{cfg.name} dense decode step (8 rows, full width, {what})",
            lambda i, o=opts, p=path: lm.decode_step(
                model, cfg, tok, caches[p], 513 + i, o), steps)
        if by_name and path == "kernel":
            ms, n = by_name.get(next((k for k in by_name
                                      if "mla_kernel" in k), ""), (0.0, 0))
            print(f"  mla_decode's kernel: {ms:.4f} ms/step in {n} "
                  f"calls/step")


def mla_f32_streams(tuner) -> None:
    """deepseek-v2-lite-16b at full width in float32 (63 GB of weights from
    seed 0): the launcher's 8 prompts of 512, one chunked prefill, then 31
    greedy decode steps from it by mla_decode and by the reference's
    einsum on clones of its latent caches. Without bf16 roundings between
    the layers, the two paths' differences stay at f32 level, too small to
    flip the MoE routing, so the token streams are held equal 8/8, or at
    the first token where one differs the einsum path's own logits of that
    step score the two tokens within 2% of their std (the tie rule)."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.param import init_params
    cfg = dataclasses.replace(serve.get_config(DSV2), dtype="float32")
    cuda = torch.device("cuda")
    tuner.best_config(*serve.mla_context(cfg, 8, DENSE_T, cuda))
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    rng = np.random.default_rng(0)                 # the launcher's prompts
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (8, 512),
                                            dtype=np.int64)).cuda()
    logits, cache = lm.prefill(model, cfg, prompts, max_len=DENSE_T,
                               opts=lm.ForwardOpts(attn_chunk=64))
    first = torch.argmax(logits, -1, keepdim=True)
    toks, rows = {}, {}
    for path in ("kernel", "plain"):
        c = [{k: v.clone() for k, v in layer.items()} for layer in cache] \
            if path == "kernel" else cache
        tok, out, per_step = first, [first], []
        opts = lm.ForwardOpts(decode_impl=path)
        for i in range(31):
            step_logits, c = lm.decode_step(model, cfg, tok, c, 512 + i,
                                            opts)
            per_step.append(step_logits.cpu())
            tok = torch.argmax(step_logits, -1, keepdim=True)
            out.append(tok)
        toks[path] = torch.cat(out, 1).cpu().numpy()
        rows[path] = per_step
        del c
    assert np.isfinite(torch.stack(rows["kernel"]).numpy()).all()
    equal, found = 0, []
    for r in range(8):
        a, b = toks["kernel"][r], toks["plain"][r]
        i = next((j for j in range(len(a)) if a[j] != b[j]), None)
        if i is None:
            equal += 1
            continue
        row = rows["plain"][i - 1][r]             # step i - 1 chose token i
        gap, std = float(row[b[i]] - row[a[i]]), float(row.std())
        found.append({"request": r, "token": i, "gap": gap,
                      "tol": BF16_TOL * std})
        if gap > BF16_TOL * std:
            raise AssertionError(f"{DSV2} f32: request {r} diverges at "
                                 f"token {i} where the einsum path's logits "
                                 f"differ by {gap}, over {BF16_TOL} of their "
                                 f"std {std}")
    print(f"{DSV2} in float32 at full width, mla_decode vs the einsum: "
          f"{equal}/8 token streams equal (32 tokens each); the first "
          f"step's logits relative L2 "
          f"{rel_l2(rows['kernel'][0], rows['plain'][0]):.3g}; first "
          f"divergences: {json.dumps(found)}")
    del model, cache, logits


@contextlib.contextmanager
def routing_record(out: list):
    """Record the top-k expert ids of every MoE call run inside, in call
    order, into ``out`` (the port's code is unchanged: ``moe.route`` is
    wrapped for the duration)."""
    from repro_torch.models import moe
    real = moe.route

    def recording(p, x, cfg):
        w, idx, probs = real(p, x, cfg)
        out.append(idx.sort(-1).values.cpu())
        return w, idx, probs

    moe.route = recording
    try:
        yield out
    finally:
        moe.route = real


def flash_dense_serving(tuner, model, chunked) -> dict:
    """The launcher's static batch at full width with ``--decode-impl
    pallas --attn-impl pallas`` (8 prompts of 512, 32 new tokens):
    flash_attention launched once a layer in the one prefill (32) and
    gqa_decode_ragged once a layer and decode step; the streams equal the
    ``--attn-impl chunked`` run's (``chunked``: its report) up to the tie
    rule (``dense_divergences``, recomputed on ``model``: the seed-0
    weights the runs had); prefill ms and tokens/s printed beside the
    chunked run's. Returns the run's report and launch counts."""
    from repro_torch.kernels import flash_attention as fa_kernel
    from repro_torch.kernels import gqa_decode as gqa_kernel
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg, cuda = serve.get_config("phi4-mini-3.8b"), torch.device("cuda")
    for tunable, ctx in (serve.dense_context(cfg, 8, DENSE_T, cuda),
                         serve.flash_context(cfg, 8, 512, cuda)):
        tuner.best_config(tunable, ctx)      # before the counts start
    counters = {"flash_attention": fa_kernel.flash_attention,
                "gqa_decode_ragged": gqa_kernel.gqa_decode}
    for fn in counters.values():
        fn.launches = 0
    args = serve.build_parser().parse_args(
        ["--full-config", "--requests", "8", "--prompt-len", "512", "--gen",
         "32", "--decode-impl", "pallas", "--attn-impl", "pallas"])
    report = serve.serve_dense(args, tuner)
    launches = {k: fn.launches for k, fn in counters.items()}
    torch.cuda.empty_cache()
    print("dense run report (--decode-impl pallas --attn-impl pallas): "
          + json.dumps({k: v for k, v in report.items() if k != "tokens"},
                       sort_keys=True))
    print(f"launches in the run (--decode-impl pallas --attn-impl pallas): "
          f"{json.dumps(launches)}")
    assert report["attn_impl"] == "pallas" and chunked["attn_impl"] == \
        "chunked"
    assert np.asarray(report["tokens"]).shape == (8, 32)
    assert launches["flash_attention"] == cfg.n_layers == 32, launches
    assert launches["gqa_decode_ragged"] == 31 * cfg.n_layers, launches
    dense_divergences("--attn-impl pallas vs chunked", report["tokens"],
                      chunked["tokens"], lambda: (model, cfg),
                      lm.ForwardOpts(attn_chunk=64))
    print(f"--attn-impl pallas vs chunked (--decode-impl pallas) at full "
          f"width: prefill {report['prefill_ms']:.1f} / "
          f"{chunked['prefill_ms']:.1f} ms, decode {report['decode_ms']:.1f} "
          f"/ {chunked['decode_ms']:.1f} ms, tokens/s "
          f"{report['tokens_per_s']:.1f} / {chunked['tokens_per_s']:.1f}")
    return {"report": report, "launches": launches}


def prefill_check(model, cfg, steps: int = 2) -> None:
    """One full-width dense prefill (8 prompts of 512) through
    flash_attention against the same prefill by chunked attention (KV
    chunks of 64, the launcher's) on the same weights, last-position
    logits held by ``hold_logits``, the residual stream compared layer by
    layer; then a profiled window of each.

    Over 32 random bf16 layers and 512 positions a 1-ulp difference in one
    attention output grows to about 2% of the logits (relative L2): the
    reference's own exact prefills, ``full`` and ``chunked``, are as far
    apart as flash_attention is from either. So the relative L2 is held
    within BF16_TOL or, where the spread of those two reference prefills
    (measured here, on the same prompts) is wider, within 10% over it;
    the greedy tokens are held by the tie rule as everywhere."""
    from repro_torch.models import lm
    rng = np.random.default_rng(9)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                            (8, 512))).cuda()
    opts = {impl: lm.ForwardOpts(attn_impl=impl, attn_chunk=64)
            for impl in ("pallas", "chunked", "full")}
    logits, streams = {}, {"pallas": {}, "chunked": {}}
    for impl, o in opts.items():
        record = residual_streams(model, streams[impl]) \
            if impl in streams else contextlib.nullcontext()
        with record:
            logits[impl], _ = lm.prefill(model, cfg, prompts, max_len=512,
                                         opts=o)
    print(f"  residual stream (prefill), relative L2 after layer "
          f"{stream_errors(streams['pallas'], streams['chunked'])}")
    spread = rel_l2(logits["full"], logits["chunked"])
    print(f"  the reference's prefills, full vs chunked (KV chunks of 64): "
          f"logits relative L2 {spread:.4g}; flash_attention vs full "
          f"{rel_l2(logits['pallas'], logits['full']):.4g}")
    hold_logits("dense prefill, flash_attention vs chunked attention (KV "
                "chunks of 64), 8 prompts of 512, last position",
                logits["pallas"], logits["chunked"],
                rel_tol=max(BF16_TOL, 1.1 * spread))
    del streams
    opts.pop("full")
    for impl, o in opts.items():
        profile_steps(
            f"dense prefill (8 prompts of 512, full width, --attn-impl "
            f"{impl})",
            lambda i, o=o: lm.prefill(model, cfg, prompts, max_len=512,
                                      opts=o), steps)


def w8a8_dense_serving(tuner, n_layers: int, bf16_tokens) -> dict:
    """The launcher's w8a8 static batch at full width (``--quant w8a8``: 8
    prompts of 512, 32 new tokens), three times: ``--decode-impl pallas``
    with ``--quant-impl pallas`` (every MLP GEMM through matmul_w8a8) and
    with ``--quant-impl sim``, then ``--decode-impl full`` (sim). The
    kernel run's streams equal the sim run's 8/8 up to the tie rule
    (``dense_divergences``), with matmul_w8a8 launched 64 times a forward
    pass (2 GEMMs x 32 layers) x 32 passes and never on the sim runs;
    equality with the full run and with the bf16 run is printed, not held.
    Returns the kernel run's report and launch counts."""
    from repro_torch.kernels import gqa_decode as gqa_kernel
    from repro_torch.kernels import matmul_w8a8 as mm8_kernel
    from repro_torch.launch import serve
    from repro_torch.models import lm
    argv = ["--full-config", "--requests", "8", "--prompt-len", "512",
            "--gen", "32", "--quant", "w8a8"]
    counters = {"matmul_w8a8": mm8_kernel.matmul_w8a8,
                "gqa_decode_ragged": gqa_kernel.gqa_decode}
    cfg, cuda = serve.get_config("phi4-mini-3.8b"), torch.device("cuda")
    # every context the runs dispatch, tuned before the counts start
    for tunable, ctx in [serve.dense_context(cfg, 8, DENSE_T, cuda)] + \
            serve.w8a8_contexts(cfg, 8, 512, cuda):
        tuner.best_config(tunable, ctx)
    runs = {}
    for label, extra in (("kernel", ["--decode-impl", "pallas",
                                     "--quant-impl", "pallas"]),
                         ("sim", ["--decode-impl", "pallas",
                                  "--quant-impl", "sim"]),
                         ("full", ["--decode-impl", "full"])):
        args = serve.build_parser().parse_args(argv + extra)
        for fn in counters.values():
            fn.launches = 0
        wgmma = mm8_kernel.matmul_w8a8.path_launches["wgmma"]
        report = serve.serve_dense(args, tuner)
        launches = {k: fn.launches for k, fn in counters.items()}
        # every serving GEMM (K 3072 and 8192) takes the wgmma kernel
        assert mm8_kernel.matmul_w8a8.path_launches["wgmma"] - wgmma == \
            launches["matmul_w8a8"], label
        runs[label] = (report, launches)
        torch.cuda.empty_cache()
        print(f"w8a8 dense run report ({' '.join(extra)}): "
              + json.dumps({k: v for k, v in report.items() if k != "tokens"},
                           sort_keys=True))
        print(f"launches in the run ({' '.join(extra)}): "
              f"{json.dumps(launches)}")
        assert report["quant"] == "w8a8"
        assert np.asarray(report["tokens"]).shape == (8, 32)
    (kernel, kl), (sim, sl), (full, fl) = (runs[k] for k in
                                           ("kernel", "sim", "full"))
    assert kernel["quant_impl"] == "pallas" and sim["quant_impl"] == "sim"
    assert kl["matmul_w8a8"] == 2 * n_layers * 32 == 2048, kl
    assert kl["gqa_decode_ragged"] == sl["gqa_decode_ragged"] == \
        31 * n_layers, (kl, sl)
    assert sl["matmul_w8a8"] == 0 and sum(fl.values()) == 0, (sl, fl)
    dense_divergences("w8a8 --quant-impl pallas vs sim", kernel["tokens"],
                      sim["tokens"], w8a8_model,
                      lm.ForwardOpts(attn_chunk=64, quant="w8a8"))
    eq = {name: sum(a == b for a, b in zip(kernel["tokens"], other))
          for name, other in (("full", full["tokens"]),
                              ("bf16", bf16_tokens))}
    eq["sim-full"] = sum(a == b for a, b in zip(sim["tokens"],
                                                full["tokens"]))
    print(f"--quant w8a8 at full width, --quant-impl pallas vs sim vs "
          f"--decode-impl full: prefill {kernel['prefill_ms']:.1f} / "
          f"{sim['prefill_ms']:.1f} / {full['prefill_ms']:.1f} ms, decode "
          f"{kernel['decode_ms']:.1f} / {sim['decode_ms']:.1f} / "
          f"{full['decode_ms']:.1f} ms, tokens/s "
          f"{kernel['tokens_per_s']:.1f} / {sim['tokens_per_s']:.1f} / "
          f"{full['tokens_per_s']:.1f}, peak memory "
          f"{kernel['peak_memory_bytes'] / 2**30:.2f} / "
          f"{sim['peak_memory_bytes'] / 2**30:.2f} GiB; the full run's "
          f"streams equal the kernel run's {eq['full']}/8 and the sim "
          f"run's {eq['sim-full']}/8, the kernel run's equal the bf16 "
          f"dense run's {eq['bf16']}/8 (reported, not held)")
    return {"report": kernel, "launches": kl}


@functools.lru_cache(maxsize=1)
def w8a8_model():
    """phi4-mini at full width from the launcher's seed (0) with its MLP
    weights quantized (w8a8): the weights the w8a8 serving runs had."""
    from repro_torch.configs import get_config
    from repro_torch.models.param import init_params
    from repro_torch.quant import quantize_params
    cfg = get_config("phi4-mini-3.8b")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    return quantize_params(model, "w8a8"), cfg


def dense_divergences(label: str, kernel_tokens, ref_tokens, model_fn,
                      opts) -> None:
    """A dense kernel run's streams equal a reference run's (``label``
    names the pair), or at the first token where one differs the
    reference path's logits (one prefill of the request's context under
    ``opts``, on the (model, cfg) ``model_fn`` gives) score the two tokens
    within 2% of the logits' std: a tie, as ``hold_logits`` allows."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    rng = np.random.default_rng(0)                 # the launcher's prompts
    prompts = rng.integers(1, get_config("phi4-mini-3.8b").vocab_size,
                           (8, 512), dtype=np.int64)
    equal, found = 0, []
    for r, (a, b) in enumerate(zip(kernel_tokens, ref_tokens)):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            equal += 1
            continue
        model, cfg = model_fn()
        ctx = np.concatenate([prompts[r], np.asarray(b[:i], np.int64)])
        logits, _ = lm.prefill(model, cfg, torch.from_numpy(ctx[None]).cuda(),
                               max_len=len(ctx) + 1, opts=opts)
        row = logits[0]
        gap = float(row[b[i]] - row[a[i]])
        std = float(row.std())
        found.append({"request": r, "token": i, "kernel": a[i],
                      "reference": b[i], "reference_logit_gap": gap,
                      "tol": BF16_TOL * std})
        if abs(gap) > BF16_TOL * std:
            raise AssertionError(f"{label}: request {r} diverges at token "
                                 f"{i} where the reference logits differ by "
                                 f"{gap}, over {BF16_TOL} of their std {std}")
    print(f"{label} at full width: {equal}/8 token streams equal; first "
          f"divergences: {json.dumps(found)}")


def w8a8_step_check(steps: int = 8) -> None:
    """One full-width w8a8 dense decode step (8 requests at position 512
    after a sim prefill of 512 tokens) with every MLP GEMM through
    matmul_w8a8 against the same step through the sim GEMMs, on clones of
    one cache (attention through gqa_decode on both): logits held by
    ``hold_logits``, the residual stream compared layer by layer; then a
    profiled window of kernel steps, and of sim steps; then one profiled
    full-width prefill of the 8 prompts by each."""
    from repro_torch.models import lm
    model, cfg = w8a8_model()
    rng = np.random.default_rng(9)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (8, 512))).cuda()
    _, cache = lm.prefill(model, cfg, prompts, max_len=512 + 2 * steps + 2,
                          opts=lm.ForwardOpts(attn_chunk=64, quant="w8a8"))
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, (8, 1))).cuda()
    caches = {"pallas": [{k: v.clone() for k, v in layer.items()}
                         for layer in cache], "sim": cache}
    logits, streams = {}, {"pallas": {}, "sim": {}}
    for impl in ("pallas", "sim"):
        with residual_streams(model, streams[impl]):
            logits[impl], _ = lm.decode_step(
                model, cfg, tok, caches[impl], 512,
                lm.ForwardOpts(decode_impl="kernel", quant="w8a8",
                               quant_impl=impl))
    print(f"  residual stream (w8a8 step), relative L2 after layer "
          f"{stream_errors(streams['pallas'], streams['sim'])}")
    hold_logits("dense decode step --quant w8a8, matmul_w8a8 vs the sim "
                "GEMMs, 8 requests at position 512", logits["pallas"],
                logits["sim"])
    opts = lm.ForwardOpts(decode_impl="kernel", quant="w8a8",
                          quant_impl="pallas")
    profile_steps(
        "dense decode step (8 rows, full width, --quant w8a8, matmul_w8a8 "
        "and gqa_decode)",
        lambda i: lm.decode_step(model, cfg, tok, caches["pallas"], 513 + i,
                                 opts), steps)
    sim = lm.ForwardOpts(decode_impl="kernel", quant="w8a8")
    profile_steps(
        "dense decode step (8 rows, full width, --quant w8a8, sim GEMMs)",
        lambda i: lm.decode_step(model, cfg, tok, caches["sim"], 513 + i,
                                 sim), steps)
    del caches, cache
    for impl in ("pallas", "sim"):
        opts = lm.ForwardOpts(attn_chunk=64, quant="w8a8", quant_impl=impl)
        profile_steps(
            f"dense prefill (8 prompts of 512, full width, --quant w8a8, "
            f"{'matmul_w8a8' if impl == 'pallas' else 'sim GEMMs'})",
            lambda i: lm.prefill(model, cfg, prompts, max_len=512 + 2,
                                 opts=opts), 1)


def dense_serving(tuner, n_layers: int, quant: str = "none") -> dict:
    """The launcher's static batch over dense caches at full width (int8
    caches under ``--quant kv8``), by the decode kernel (gqa_decode_ragged,
    or gqa_decode_kv8) and by the plain einsum, both with the chunked
    prefill: equal token streams, the path's kernel launched once a layer
    and decode step and no other (flash_attention never); returns the
    kernel run's report and launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da_kernel
    from repro_torch.kernels import flash_attention as fa_kernel
    from repro_torch.kernels import gqa_decode as gqa_kernel
    from repro_torch.kernels import gqa_decode_kv8 as kv8_kernel
    from repro_torch.launch import serve
    argv = ["--full-config", "--requests", "8", "--prompt-len", "512",
            "--gen", "32", "--quant", quant]
    counters = {"gqa_decode_ragged": gqa_kernel.gqa_decode,
                "decode_attention": da_kernel.decode_attention,
                "gqa_decode_kv8": kv8_kernel.gqa_decode_kv8,
                "flash_attention": fa_kernel.flash_attention}
    path = "gqa_decode_kv8" if quant == "kv8" else "gqa_decode_ragged"
    # tuned before the counts start, as the paged engines' contexts are
    tuner.best_config(*serve.dense_context(
        get_config("phi4-mini-3.8b"), 8, DENSE_T, torch.device("cuda"),
        quant))
    runs = {}
    for impl in ("pallas", "full"):
        for fn in counters.values():
            fn.launches = 0
        args = serve.build_parser().parse_args(
            argv + ["--decode-impl", impl])
        report = serve.serve_dense(args, tuner)
        launches = {k: fn.launches for k, fn in counters.items()}
        runs[impl] = (report, launches)
        torch.cuda.empty_cache()
        print(f"dense run report (--decode-impl {impl} --quant {quant}): "
              + json.dumps({k: v for k, v in report.items() if k != "tokens"},
                           sort_keys=True))
        print(f"launches in the run (--decode-impl {impl} --quant {quant}): "
              f"{json.dumps(launches)}")
    (kernel, kl), (plain, pl) = runs["pallas"], runs["full"]
    assert kl[path] == 31 * n_layers, kl
    assert sum(kl.values()) == kl[path] and sum(pl.values()) == 0, (kl, pl)
    for rep in (kernel, plain):
        assert np.asarray(rep["tokens"]).shape == (8, 32)
        assert rep["quant"] == quant
    equal = sum(a == b for a, b in zip(kernel["tokens"], plain["tokens"]))
    print(f"--decode-impl pallas vs full --quant {quant} at full width: "
          f"{equal}/8 token streams equal; prefill "
          f"{kernel['prefill_ms']:.1f} / {plain['prefill_ms']:.1f} ms, decode "
          f"{kernel['decode_ms']:.1f} / {plain['decode_ms']:.1f} ms, tokens/s "
          f"{kernel['tokens_per_s']:.1f} / {plain['tokens_per_s']:.1f}")
    if equal != 8:
        raise AssertionError(f"dense serving --quant {quant}: the kernel and "
                             f"the plain path give different tokens")
    return {"report": kernel, "launches": kl}


def kv8_paged_serving(engine, reqs, bf16_reqs, counters) -> dict:
    """The launcher's kv8 paged run at full width (``--quant kv8``: int8
    page pools, decode through the int8 branch of paged_decode) and the
    same requests through the plain versions on the card, on the same
    model and pool layout: equal token streams 8/8, paged_decode launched
    once a layer and decode step with int8 pools and nothing launched on
    the plain path, no failed request; how many streams equal the bf16
    paged run's is printed, not held. Returns the kernel run's report and
    launch counts."""
    from repro_torch.kernels import paged_decode as pd_kernel
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import Request, ServingEngine
    sched = engine.scheduler
    assert engine.cache[0]["k_pages"].dtype == torch.int8
    plain_engine = ServingEngine(
        engine.cfg, engine.model, num_pages=engine.pool.num_pages,
        page_size=engine.pool.page_size, max_batch=sched.max_batch,
        max_seq_len=engine.max_seq_len, prefill_chunk=sched.prefill_chunk,
        opts=lm.ForwardOpts(**PATH_OPTS["plain"], quant="kv8"),
        device=engine.device)
    plain_reqs = [Request(rid=r.rid, prompt=r.prompt.copy(),
                          max_new_tokens=r.max_new_tokens) for r in reqs]
    runs = {}
    for label, eng, rs in (("kernel", engine, reqs),
                           ("plain", plain_engine, plain_reqs)):
        for fn in counters.values():
            fn.launches = 0
        pd_kernel.paged_decode.path_launches = {"bulk": 0, "cp_async": 0}
        report = serve.serve(eng, rs)
        launches = {k: fn.launches for k, fn in counters.items()}
        runs[label] = (report, launches)
        if label == "kernel":
            assert pd_kernel.paged_decode.path_launches == {
                "bulk": launches["paged_decode"], "cp_async": 0}, \
                pd_kernel.paged_decode.path_launches
        print(f"run report (--quant kv8, {label}): "
              + json.dumps(report, sort_keys=True))
        print(f"launches in the run (--quant kv8, {label}): "
              + json.dumps(launches))
        assert report["quant"] == "kv8"
        assert report["lifecycle"]["terminal"] == len(rs) == 8
        assert report["lifecycle"]["failed"] == 0
        assert all(len(r.tokens) == 32 for r in rs)
    (kernel, kl), (plain, pl) = runs["kernel"], runs["plain"]
    n_layers = engine.cfg.n_layers
    assert kl["paged_decode"] == kernel["decode_steps"] * n_layers > 0, kl
    assert kl["paged_verify"] == 0 and kl["rms_norm"] > 0, kl
    assert sum(pl.values()) == 0, pl
    equal = sum(a.tokens == b.tokens for a, b in zip(reqs, plain_reqs))
    same = sum(a.tokens == b.tokens for a, b in zip(reqs, bf16_reqs))
    print(f"--quant kv8 paged, kernels vs plain versions at full width: "
          f"{equal}/8 token streams equal; tokens/s "
          f"{kernel['tokens_per_s']:.1f} / {plain['tokens_per_s']:.1f}, ITL "
          f"p50 {kernel['itl_p50_ms']:.2f} / {plain['itl_p50_ms']:.2f} ms, "
          f"peak memory {kernel['peak_memory_bytes'] / 2**30:.2f} GiB; "
          f"{same}/8 streams equal the bf16 paged run's (reported, not "
          f"held)")
    if equal != 8:
        raise AssertionError("kv8 paged serving: the kernel and the plain "
                             "path give different tokens")
    del plain_engine
    torch.cuda.empty_cache()
    return {"report": kernel, "launches": kl}


def kv8_spec_serving(engine, reqs, plain_engine, plain_reqs, bf16_spec,
                     counters) -> dict:
    """The launcher's kv8 speculative run at full width (``--quant kv8
    --speculative``: int8 page pools, every verify pass through the int8
    branch of paged_verify) on the kv8 plain run's requests: no failed
    request, paged_verify launched once a layer and verify pass and
    paged_decode never, the streams equal the kv8 plain run's up to the
    tie rule (``first_divergences`` over int8 pools); tokens/s, TTFT, ITL
    and launches printed beside the bf16 speculative run's
    (``bf16_spec``: its report and launches). Returns the run's report
    and launch counts."""
    from repro_torch.launch import serve
    assert engine.cache[0]["k_pages"].dtype == torch.int8
    for fn in counters.values():
        fn.launches = 0
    report = serve.serve(engine, reqs)
    launches = {k: fn.launches for k, fn in counters.items()}
    K, n_layers = engine.spec_k, engine.cfg.n_layers
    print(f"run report (--quant kv8 --speculative {K}): "
          + json.dumps(report, sort_keys=True))
    print(f"launches in the run (--quant kv8 --speculative {K}): "
          + json.dumps(launches))
    assert report["quant"] == "kv8"
    assert report["lifecycle"]["terminal"] == len(reqs) == 8
    assert report["lifecycle"]["failed"] == 0
    assert all(len(r.tokens) == 32 for r in reqs)
    sp = report["speculative"]
    assert sp["draft_k"] == K and not sp["degraded"], sp
    assert report["decode_steps"] == 0 == launches["paged_decode"], launches
    assert launches["paged_verify"] == \
        report["verify_passes"] * n_layers > 0, launches
    assert launches["rms_norm"] > 0, launches
    first_divergences(plain_engine, plain_reqs, reqs, K)
    bf16, bf16_launches = bf16_spec
    for label, rep_, la in (("kv8", report, launches),
                            ("bf16", bf16, bf16_launches)):
        print(f"  --speculative {rep_['speculative']['draft_k']} {label}: "
              f"tokens/s {rep_['tokens_per_s']:.1f}, TTFT p50 "
              f"{rep_['ttft_p50_ms']:.1f} ms p99 {rep_['ttft_p99_ms']:.1f} "
              f"ms, ITL p50 {rep_['itl_p50_ms']:.2f} ms p99 "
              f"{rep_['itl_p99_ms']:.2f} ms, accepted_per_step "
              f"{rep_['speculative']['accepted_per_step']:.4f}, "
              f"{rep_['verify_passes']} verify passes, launches "
              f"{json.dumps(la)}, peak memory "
              f"{rep_['peak_memory_bytes'] / 2**30:.2f} GiB")
    return {"report": report, "launches": launches}


def dense_step_check(model, cfg, steps: int = 8, quant=None) -> None:
    """One full-width dense decode step (8 requests at position 512 after a
    plain prefill of 512 tokens; int8 caches under ``quant="kv8"``)
    through gqa_decode (gqa_decode_kv8) against the same step through the
    plain einsum on clones of one cache: the same GEMMs on both paths;
    logits held by ``hold_logits``, the residual stream compared layer by
    layer; then a profiled window of kernel steps."""
    from repro_torch.models import lm
    kernel = "gqa_decode_kv8" if quant else "gqa_decode"
    rng = np.random.default_rng(9)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (8, 512))).cuda()
    _, cache = lm.prefill(model, cfg, prompts, max_len=512 + 2 * steps + 2,
                          opts=lm.ForwardOpts(attn_chunk=64, quant=quant))
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, (8, 1))).cuda()
    caches = {"kernel": [{k: v.clone() for k, v in layer.items()}
                         for layer in cache], "plain": cache}
    logits, streams = {}, {"kernel": {}, "plain": {}}
    for path in ("kernel", "plain"):
        with residual_streams(model, streams[path]):
            logits[path], _ = lm.decode_step(
                model, cfg, tok, caches[path], 512,
                lm.ForwardOpts(decode_impl=path, quant=quant))
    hold_logits(f"dense decode step{' --quant ' + quant if quant else ''}, "
                f"{kernel} vs plain einsum, 8 requests at position 512",
                logits["kernel"], logits["plain"])
    print(f"  residual stream, relative L2 after layer "
          f"{stream_errors(streams['kernel'], streams['plain'])}")
    opts = lm.ForwardOpts(decode_impl="kernel", quant=quant)
    profile_steps(
        f"dense decode step (8 rows, full width, {kernel})",
        lambda i: lm.decode_step(model, cfg, tok, caches["kernel"], 513 + i,
                                 opts), steps)


def decode_state(engine, steps: int):
    """A fresh cache holding 8 prefilled sequences of 96-255 tokens (plain
    prefill), laid out like the engine's pool and of its kv dtype (int8
    pools under kv8), ready for ``steps`` decode steps: (cache, tables,
    lens, first tokens)."""
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
    cache = lm.init_paged_cache(cfg, 1 + B * need, ps, device="cuda",
                                kv_dtype=engine.opts.kv_dtype())
    plain = lm.ForwardOpts(**PATH_OPTS["plain"], quant=engine.opts.quant)
    for b in range(B):
        prompt = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (1, int(lens[b]))).astype(np.int64)).cuda()
        lm.prefill_paged(model, cfg, prompt, cache, tables_d[b:b + 1],
                         torch.zeros(1, dtype=torch.int32, device="cuda"),
                         plain)
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, 1))).cuda()
    return cache, tables_d, torch.from_numpy(lens.astype(np.int32)).cuda(), tok


PATH_OPTS = {"kernel": dict(decode_impl="kernel", norm_impl="kernel"),
             "plain": dict(decode_impl="plain", norm_impl="plain")}
STREAM_LAYERS = (1, 2, 4, 8, 16, 32)


@contextlib.contextmanager
def residual_streams(model, out: dict):
    """Record the residual stream after each layer of the forward passes
    run inside into ``out[i]`` (i = 1..n_layers): the input of layer i's
    first norm is the stream after layer i - 1, the final norm's input the
    stream after the last layer. The port's code is unchanged: the norm
    the layer loop calls is wrapped for the duration."""
    from repro_torch.models import lm
    index = {id(block.ln1): i for i, block in enumerate(model.layers)}
    index[id(model.final_ln)] = len(model.layers)
    real = lm.apply_norm

    def recording(p, x, cfg, **kw):
        i = index.get(id(p))
        if i:                  # layer 0's norm sees the embeddings
            out[i] = x.float().clone()
        return real(p, x, cfg, **kw)

    lm.apply_norm = recording
    try:
        yield out
    finally:
        lm.apply_norm = real


def stream_errors(a: dict, b: dict) -> str:
    return ", ".join(
        f"{i}: {float((a[i] - b[i]).norm() / b[i].norm()):.3g}"
        for i in STREAM_LAYERS if i in b)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def hold_logits(label: str, a: torch.Tensor, b: torch.Tensor,
                rel_tol: float = BF16_TOL) -> None:
    """Kernel-path logits ``a`` against plain-path logits ``b`` of the same
    step: relative L2 error within ``rel_tol`` (the bf16 tolerance), and
    on every row the same greedy token, or one the plain path scores
    within 2% of the logits' std of its own best (a tie). Held at the
    logits' typical scale, not their tail: over millions of logits of 32
    bf16 layers the largest elementwise error is a tail value of the
    scatter."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    assert torch.isfinite(a).all()
    err = float((a - b).abs().max())
    rel = rel_l2(a, b)
    std = float(b.std())
    pick_a, pick_b = a.argmax(-1), b.argmax(-1)
    gap = (b.gather(-1, pick_b[:, None]) - b.gather(-1, pick_a[:, None]))
    print(f"{label}: logits relative L2 error {rel:.4g} (tol {rel_tol:.4g}), "
          f"max_abs_err {err:.4g}, logit std {std:.4g}, max |logit| "
          f"{float(b.abs().max()):.4g}; argmax agreement "
          f"{int((pick_a == pick_b).sum())}/{a.shape[0]} (largest "
          f"plain-logit gap at a disagreement {float(gap.max()):.4g}, tol "
          f"{BF16_TOL * std:.4g})")
    if rel > rel_tol:
        raise AssertionError(f"{label}: relative L2 logits error {rel} over "
                             f"{rel_tol}")
    if float(gap.max()) > BF16_TOL * std:
        raise AssertionError(f"{label}: argmax differs where the plain "
                             f"logits differ by {float(gap.max())}, over "
                             f"{BF16_TOL} of their std {std}")


def full_width_check(engine, steps: int = 16) -> None:
    """One decode step through both kernels against the same step through
    the plain versions on clones of one cache (int8 pools under the
    engine's kv8; logits and greedy tokens held by ``hold_logits``,
    residual stream compared layer by layer), then a short greedy
    continuation on each path (agreement printed)."""
    from repro_torch.models import lm
    cfg, model, quant = engine.cfg, engine.model, engine.opts.quant
    cache, tables_d, lens_d, tok = decode_state(engine, steps)
    B = tok.shape[0]
    caches = {"kernel": [{k: v.clone() for k, v in layer.items()}
                         for layer in cache], "plain": cache}
    first, toks, streams = {}, {}, {}
    for path in ("kernel", "plain"):
        t, seq = tok, []
        opts = lm.ForwardOpts(**PATH_OPTS[path], quant=quant)
        for i in range(steps):
            record = (residual_streams(model, streams.setdefault(path, {}))
                      if i == 0 else contextlib.nullcontext())
            with record:
                logits, _ = lm.decode_step_paged(model, cfg, t, caches[path],
                                                 tables_d, lens_d + i, opts)
            if i == 0:
                first[path] = logits
            t = torch.argmax(logits, -1, keepdim=True)
            seq.append(t[:, 0].cpu().numpy())
        toks[path] = np.stack(seq, 1)
    assert first["kernel"].shape == (B, cfg.vocab_size)
    lens = lens_d.cpu().numpy()
    pools = " over int8 pools (kv8)" if quant else ""
    hold_logits(f"decode step{pools}, kernels vs plain, {B} sequences of "
                f"{lens.min()}-{lens.max()} tokens", first["kernel"],
                first["plain"])
    print(f"  residual stream, relative L2 after layer "
          f"{stream_errors(streams['kernel'], streams['plain'])}")
    print(f"  greedy agreement over {steps} steps "
          f"{float((toks['kernel'] == toks['plain']).mean()):.3f}")


def verify_check(engine) -> None:
    """One verify step (the engine's depth K, random drafts) through the
    kernels against the same verify step through the plain versions on
    clones of one cache (int8 pools under the engine's kv8): the same
    GEMMs of B·K rows on both paths, so only attention and the norms
    differ. Logits and greedy tokens of all B·K rows held by
    ``hold_logits``; residual stream compared layer by layer."""
    from repro_torch.models import lm
    cfg, model, K = engine.cfg, engine.model, engine.spec_k
    quant = engine.opts.quant
    cache, tables_d, lens_d, tok = decode_state(engine, K)
    B = tok.shape[0]
    rng = np.random.default_rng(6)
    drafts = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                           (B, K - 1))).cuda()
    toks = torch.cat([tok, drafts], 1)
    caches = {"kernel": [{k: v.clone() for k, v in layer.items()}
                         for layer in cache], "plain": cache}
    logits, streams = {}, {"kernel": {}, "plain": {}}
    for path in ("kernel", "plain"):
        with residual_streams(model, streams[path]):
            logits[path], _ = lm.verify_step_paged(
                model, cfg, toks, caches[path], tables_d, lens_d,
                lm.ForwardOpts(**PATH_OPTS[path], quant=quant))
    assert logits["kernel"].shape == (B, K, cfg.vocab_size)
    lens = lens_d.cpu().numpy()
    pools = " over int8 pools (kv8)" if quant else ""
    # the residual streams first: printed whether or not the logits hold
    print(f"verify step (K {K}){pools}: residual stream, relative L2 after "
          f"layer {stream_errors(streams['kernel'], streams['plain'])}")
    hold_logits(f"verify step (K {K}){pools}, kernels vs plain, {B} "
                f"sequences of {lens.min()}-{lens.max()} tokens, every "
                f"position", logits["kernel"], logits["plain"])


def profile_steps(label: str, step, steps: int = 8) -> None:
    """Where a full-width step's time goes: ``step(i)`` runs the i-th step;
    its wall time unprofiled, then the device time of its kernels under
    ``torch.profiler``; the device busy share is their ratio."""
    from torch.profiler import ProfilerActivity, profile

    def run(i0):
        for i in range(steps):
            step(i0 + i)
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
        print(f"{label}: wall {wall * 1e3:.2f} ms unprofiled; the profiler "
              "saw no device events, so device time is not measured")
        return
    device = sum(us for us, _ in by_name.values()) * 1e-6 / steps
    print(f"{label}: wall {wall * 1e3:.2f} ms unprofiled; device time of "
          f"its kernels {device * 1e3:.3f} ms (profiler, "
          f"{len(kernels) // steps} device events a step); device busy "
          f"share {device / wall:.3f}")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {us * 1e-3 / steps:8.4f} ms/step {n // steps:4d} calls/step"
              f"  {name[:90]}")
    return {name: (us * 1e-3 / steps, n // steps)
            for name, (us, n) in by_name.items()}


def profile_decode(engine, steps: int = 8) -> None:
    """A profiled window of paged decode steps through the kernels on a
    cache of the engine's kv dtype."""
    from repro_torch.models import lm
    cfg, model, quant = engine.cfg, engine.model, engine.opts.quant
    opts = lm.ForwardOpts(**PATH_OPTS["kernel"], quant=quant)
    cache, tables_d, lens_d, tok = decode_state(engine, 2 * steps + 2)
    pools = ", int8 pools" if quant else ""
    profile_steps(
        f"decode step ({tok.shape[0]} rows, full width{pools})",
        lambda i: lm.decode_step_paged(model, cfg, tok, cache, tables_d,
                                       lens_d + i, opts), steps)


def profile_verify(spec_engine, steps: int = 8) -> None:
    """A profiled window of verify steps through the kernels on a cache of
    the engine's kv dtype."""
    from repro_torch.models import lm
    cfg, quant = spec_engine.cfg, spec_engine.opts.quant
    opts = lm.ForwardOpts(**PATH_OPTS["kernel"], quant=quant)
    K = spec_engine.spec_k
    cache, tables_d, lens_d, tok = decode_state(spec_engine,
                                                (2 * steps + 1) * K)
    toks = tok.repeat(1, K)
    pools = ", int8 pools" if quant else ""
    profile_steps(
        f"verify step (K {K}, {tok.shape[0]} rows, full width{pools})",
        lambda i: lm.verify_step_paged(spec_engine.model, cfg, toks, cache,
                                       tables_d, lens_d + i * K, opts),
        steps)


def first_divergences(engine, plain_reqs, spec_reqs, K: int) -> None:
    """The plain and the speculative run's token streams agree, or at the
    first token where one differs the plain path's logits (recomputed by
    one kernel-path prefill of the context before it, over pools of the
    plain engine's kv dtype: int8 under kv8) score the two tokens within
    2% of the logits' std: a tie, as ``hold_logits`` allows."""
    from repro_torch.models import lm
    cfg, model, ps = engine.cfg, engine.model, engine.pool.page_size
    quant = engine.opts.quant
    equal, found = 0, []
    for a, b in zip(plain_reqs, spec_reqs):
        i = next((j for j, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), None)
        if i is None and len(a.tokens) == len(b.tokens):
            equal += 1
            continue
        assert i is not None, (a.tokens, b.tokens)
        ctx = np.concatenate([a.prompt, np.asarray(a.tokens[:i], np.int32)])
        n_pages = -(-len(ctx) // ps)
        cache = lm.init_paged_cache(cfg, 1 + n_pages, ps, device="cuda",
                                    kv_dtype=engine.opts.kv_dtype())
        tables = torch.arange(1, 1 + n_pages, dtype=torch.int32,
                              device="cuda")[None]
        logits, _ = lm.prefill_paged(
            model, cfg, torch.from_numpy(ctx[None].astype(np.int64)).cuda(),
            cache, tables, torch.zeros(1, dtype=torch.int32, device="cuda"),
            lm.ForwardOpts(**PATH_OPTS["kernel"], quant=quant))
        row = logits[0, -1]
        gap = float(row[a.tokens[i]] - row[b.tokens[i]])
        std = float(row.std())
        found.append({"rid": a.rid, "token": i, "plain": a.tokens[i],
                      "speculative": b.tokens[i], "plain_logit_gap": gap,
                      "tol": BF16_TOL * std})
        if abs(gap) > BF16_TOL * std:
            raise AssertionError(f"request {a.rid} diverges at token {i} "
                                 f"where the plain logits differ by {gap}, "
                                 f"over {BF16_TOL} of their std {std}")
    kv8 = " --quant kv8" if quant else ""
    print(f"plain vs --speculative (K {K}){kv8} at full width: {equal}/"
          f"{len(plain_reqs)} token streams equal; first divergences: "
          f"{json.dumps(found)}")


def rejection_run(K: int = 4, page_size: int = 8, quant=None) -> None:
    """A small f32 model whose drafts are often rejected: phi4-mini's smoke
    widths with 4 layers, a vocabulary of 64 and untied embeddings (tied
    ones make a random model repeat its input, so drafts always match),
    weights from seed 1. Six requests served speculatively at depth K on
    pages of ``page_size`` (int8 pools under ``quant="kv8"``, so the
    rollback leaves int8 entries and scales for the next write) on the
    CPU (plain versions), then on the card (kernels), then by plain
    decode on the card: the same tokens, the same verify steps and
    committed tokens, and an acceptance strictly between 1 and K."""
    from repro_torch.configs import get_config
    from repro_torch.core import default_tuner
    from repro_torch.kernels import paged_decode as pd_kernel
    from repro_torch.kernels import paged_verify as pv_kernel
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.param import init_params
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True),
                              name="spec-reject", n_layers=4, vocab_size=64,
                              tie_embeddings=False)
    model = init_params(cfg, torch.Generator().manual_seed(1), "cpu")

    def run(device, speculative):
        rng = np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(
                    1, cfg.vocab_size, int(rng.integers(8, 24))).astype(
                        np.int32), max_new_tokens=24) for i in range(6)]
        eng = ServingEngine(cfg, model, num_pages=1 + 6 * 64 // page_size,
                            page_size=page_size,
                            max_batch=4, max_seq_len=64, prefill_chunk=8,
                            opts=lm.ForwardOpts(**PATH_OPTS["kernel"],
                                                quant=quant),
                            device=device, speculative=speculative)
        assert (eng.cache[0]["k_pages"].dtype == torch.int8) == bool(quant)
        if device == "cuda":            # tuned before the launches count
            for kernel, ctx in serve.engine_contexts(eng):
                default_tuner().best_config(kernel, ctx)
        before = (pd_kernel.paged_decode.launches,
                  pv_kernel.paged_verify.launches)
        res = eng.run(reqs)
        assert res["requests"] == res["terminal_requests"] == 6, res
        eng.scheduler.check_invariants()
        assert eng.pool.num_allocated == 0
        res["launches"] = (pd_kernel.paged_decode.launches - before[0],
                           pv_kernel.paged_verify.launches - before[1])
        return [r.tokens for r in reqs], res

    cpu_toks, cpu = run("cpu", K)
    model.to("cuda")
    card_toks, card = run("cuda", K)
    plain_toks, plain = run("cuda", 0)
    sp, csp = card["speculative"], cpu["speculative"]
    pools = ", int8 pools (kv8)" if quant else ""
    print(f"rejection run (f32{pools}, 4 layers, K {K}, pages of "
          f"{page_size}): "
          f"CPU {json.dumps(csp)}; "
          f"card {json.dumps(sp)}, {card['verify_passes']} verify passes, "
          f"launches (paged_decode, paged_verify) {card['launches']}; card "
          f"plain decode: {plain['decode_steps']} decode steps, launches "
          f"{plain['launches']}")
    assert card_toks == cpu_toks, "card and CPU tokens differ"
    assert plain_toks == card_toks, "speculative and plain tokens differ"
    for key in ("verify_steps", "committed_tokens"):
        assert sp[key] == csp[key], (key, sp, csp)
    assert 1.0 < sp["accepted_per_step"] < K, sp
    assert card["launches"] == (0, card["verify_passes"] * cfg.n_layers)
    assert plain["launches"] == (plain["decode_steps"] * cfg.n_layers, 0)
    print(f"  6/6 token streams equal (card = CPU = card plain decode); "
          f"accepted_per_step {sp['accepted_per_step']:.4f}")


def _describe(obj) -> str:
    import types
    if isinstance(obj, types.FrameType):
        return (f"frame of {obj.f_code.co_name} "
                f"({os.path.basename(obj.f_code.co_filename)}:"
                f"{obj.f_lineno})")
    if isinstance(obj, dict):
        if "__builtins__" in obj and "__name__" in obj:
            return f"globals of module {obj['__name__']}"
        return f"dict with keys {list(obj)[:8]}"
    if isinstance(obj, (list, tuple, set)):
        return f"{type(obj).__name__} of {len(obj)}"
    return f"{type(obj).__module__}.{type(obj).__qualname__} " + \
        getattr(obj, "__qualname__", "")


def release(label: str) -> None:
    """Free what the phases before left and print the device memory still
    allocated; over 1 GiB, name the largest live tensors and the chain of
    objects that hold the largest, and fail: the next phase needs the
    card to itself."""
    import types
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"device memory allocated {label}: {held / 2**30:.3f} GiB")
    if held < 2**30:
        return
    live = sorted((t for t in gc.get_objects()
                   if isinstance(t, torch.Tensor) and t.is_cuda),
                  key=lambda t: -t.untyped_storage().nbytes())
    print("  the largest live tensors: " + ", ".join(
        f"{tuple(t.shape)} {t.dtype} "
        f"({t.untyped_storage().nbytes() / 2**20:.0f} MiB)"
        for t in live[:6]))
    obj, here = live[0], sys._getframe()
    del live
    seen = {id(here)}
    for depth in range(16):           # the chain of referrers up from it
        seen.add(id(obj))
        refs = [r for r in gc.get_referrers(obj) if id(r) not in seen]
        if not refs:
            print("  no further referrer the collector sees (a local of a "
                  "running function, whose frame it cannot see)")
            break
        print(f"  [{depth}] held by " + "; ".join(_describe(r)
                                                for r in refs[:4]))
        # prefer what is not a frame's plain locals list
        obj = next((r for r in refs if not isinstance(r, list)), refs[0])
        del refs
        if isinstance(obj, types.ModuleType) or (
                isinstance(obj, dict) and "__builtins__" in obj):
            break
    raise AssertionError(f"{held / 2**30:.2f} GiB of device memory still "
                         f"allocated {label}")


def training_runs() -> dict:
    """The launcher at full width: ``launch.train --full-config --batch 4
    --seq 512 --steps 4`` by ``--attn-impl pallas`` (flash_attention and
    flash_attention_bwd once a layer and step: 128 launches each) and by
    ``chunked`` (none), the same seed, weights and batches, no checkpoint
    written (``--ckpt-every 0``: the state is 46 GB). Step 1's loss held
    within 2e-2 relative. Returns both reports."""
    from repro_torch.launch import train
    argv = ["--full-config", "--batch", "4", "--seq", "512", "--steps", "4",
            "--ckpt-every", "0"]
    reports = {}
    for impl in ("pallas", "chunked"):
        reports[impl] = train.main(argv + ["--attn-impl", impl])
        release(f"after the --attn-impl {impl} training run")
    p, c = reports["pallas"], reports["chunked"]
    for impl, rep in reports.items():
        print(f"training --attn-impl {impl}: losses {rep['losses']}, step "
              f"ms {[round(t, 1) for t in rep['step_ms']]}, tokens/s "
              f"{rep['tokens_per_s']:.1f}, peak memory "
              f"{rep['peak_memory_bytes'] / 2**30:.2f} GiB, launches "
              f"{rep['launches']}")
        assert rep["steps"] == 4 and all(np.isfinite(rep["losses"]))
    assert p["params"] == c["params"] and p["params"] > 3.8e9
    assert p["launches"] == {"flash_attention": 128,
                             "flash_attention_bwd": 128}, p["launches"]
    assert c["launches"] == {"flash_attention": 0,
                             "flash_attention_bwd": 0}, c["launches"]
    rel = abs(p["losses"][0] - c["losses"][0]) / abs(c["losses"][0])
    print(f"step 1 loss, pallas vs chunked: {p['losses'][0]:.6f} / "
          f"{c['losses'][0]:.6f}, relative difference {rel:.3g} (tol 2e-2)")
    if rel > 2e-2:
        raise AssertionError(f"step 1 loss differs by {rel} relative")
    return reports


def train_step_check() -> None:
    """The full-width run's first step again (seed 0 weights, the stream's
    first batch): its gradients by ``--attn-impl pallas`` held per leaf
    against chunked's, by relative L2, within max(2%, 1.1x the spread
    between the reference's two exact paths, ``full`` and ``chunked``, on
    the same step); each of the 32 layers' flash_attention_bwd outputs on
    the step's own (q, k, v, o, lse, do) held against the plain version.
    Then a profiled window of two full training steps (AdamW included)
    by pallas."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.param import init_params
    from repro_torch.optim import adamw
    cfg = get_config("phi4-mini-3.8b")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda", trainable=True)
    named = dict(model.named_parameters())
    stream = iter(TokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=512, global_batch=4)))
    batch = steps._to_device(next(stream), torch.device("cuda"))
    captured = []
    real_bwd = ops.attention_bwd

    def capturing(q, k, v, o, lse, do, **kw):
        out = real_bwd(q, k, v, o, lse, do, **kw)
        captured.append(((q, k, v, o, lse, do), kw, out))
        return out

    def grads_of(impl):
        loss, _ = lm.loss_fn(model, cfg, batch,
                             lm.ForwardOpts(attn_impl=impl, attn_chunk=128))
        loss.backward()
        grads = {n: p.grad for n, p in named.items()}
        for p in named.values():
            p.grad = None
        return float(loss.detach()), grads

    loss_c, chunked = grads_of("chunked")
    ops.attention_bwd = capturing
    try:
        loss_p, pallas = grads_of("pallas")
    finally:
        ops.attention_bwd = real_bwd
    assert len(captured) == cfg.n_layers, len(captured)
    worst = []
    for args, kw, got in captured:
        want = ref.flash_attention_bwd(*args, **kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            scale = w.float().abs().max()
            if not torch.allclose(g.float() / scale, w.float() / scale,
                                  atol=BF16_TOL, rtol=BF16_TOL):
                raise AssertionError(f"flash_attention_bwd at layer "
                                     f"{len(worst)}: {name} off the plain "
                                     f"version")
        worst.append(max(rel_l2(g, w) for g, w in zip(got, want)))
    del captured
    print(f"flash_attention_bwd on the full-width step's own inputs, 32 "
          f"layers: dq, dk, dv within {BF16_TOL} of the plain version "
          f"(in units of each gradient's largest value); relative L2 at "
          f"most {max(worst):.3g} (layer {int(np.argmax(worst))})")
    p_err = {n: rel_l2(pallas[n], chunked[n]) for n in named}
    del pallas
    loss_f, full = grads_of("full")
    spread = {n: rel_l2(full[n], chunked[n]) for n in named}
    del full
    over = {n: (p_err[n], spread[n]) for n in named
            if p_err[n] > max(BF16_TOL, 1.1 * spread[n])}
    top = sorted(named, key=lambda n: -p_err[n])[:4]
    print(f"step 1 loss by pallas / chunked / full: {loss_p:.6f} / "
          f"{loss_c:.6f} / {loss_f:.6f}; gradients, relative L2 per leaf "
          f"against chunked's: pallas at most {max(p_err.values()):.4g}, "
          f"the reference's full at most {max(spread.values()):.4g}; the "
          f"largest: " + ", ".join(f"{n} {p_err[n]:.4g} (full "
                                   f"{spread[n]:.4g})" for n in top))
    if over:
        raise AssertionError(f"gradients off chunked's beyond max(2%, 1.1x "
                             f"the reference's spread): {over}")
    del chunked
    scfg = steps.StepConfig(
        opts=lm.ForwardOpts(attn_impl="pallas", attn_chunk=128),
        adamw=adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=8))
    step = steps.make_train_step(cfg, scfg, model)
    state = steps.init_opt_state(cfg, scfg, named)
    batches = [next(stream) for _ in range(2)]

    def one(i):
        nonlocal state
        _, state, _ = step(named, state, batches[i % 2])

    profile_steps("training step (B 4 x 512 tokens, full width, --attn-impl "
                  "pallas, AdamW)", one, 2)
    print(f"  peak device memory of the training steps "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def train_f32() -> None:
    """phi4-mini at full width cut to 8 layers, in float32 (seed 0): the
    launcher's 4 steps (B 4 x 512) by ``--attn-impl pallas`` and by
    ``chunked`` on the same weights and batches. Without bf16 roundings
    the two paths part only at f32 level: losses held within 1e-4
    relative, the parameters after the steps within F32_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.param import init_params
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), n_layers=8,
                              dtype="float32")
    models, reports = {}, {}
    for impl in ("pallas", "chunked"):
        args = train.build_parser().parse_args(
            ["--full-config", "--batch", "4", "--seq", "512", "--steps",
             "4", "--ckpt-every", "0", "--attn-impl", impl])
        models[impl] = init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
            trainable=True)
        reports[impl] = train.train(args, model=models[impl], cfg=cfg)
    p, c = reports["pallas"], reports["chunked"]
    assert p["launches"] == {"flash_attention": 32,
                             "flash_attention_bwd": 32}, p["launches"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(p["losses"], c["losses"]))
    worst, name = 0.0, ""
    for (n, a), b in zip(models["pallas"].named_parameters(),
                         models["chunked"].parameters()):
        if not torch.allclose(a, b, atol=F32_TOL, rtol=F32_TOL):
            raise AssertionError(f"f32 training: parameter {n} after 4 "
                                 f"steps off chunked's beyond {F32_TOL}")
        err = float((a - b).abs().max())
        if err > worst:
            worst, name = err, n
    print(f"training in float32 (8 layers, full width): losses by pallas "
          f"{p['losses']} / chunked {c['losses']}, largest relative "
          f"difference {rel:.3g} (tol 1e-4); parameters after 4 steps within "
          f"{F32_TOL} (max abs diff {worst:.3g} in {name}); step ms "
          f"{[round(t, 1) for t in p['step_ms']]} / "
          f"{[round(t, 1) for t in c['step_ms']]}")
    if rel > 1e-4:
        raise AssertionError(f"f32 losses differ by {rel} relative")


def train_checkpoint(root: str) -> None:
    """At smoke widths on the card (f32, --attn-impl pallas): a run that
    checkpoints every 2 steps and fails at step 5 by injection; a fresh
    trainer (other random weights) resumes from step 4, and its
    parameters, AdamW moments, step and data position equal what was
    saved bit for bit; it runs on to step 6, where its parameters equal
    an uninterrupted run's within F32_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.param import init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime import InjectedFailure, Trainer, TrainerConfig
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    scfg = steps.StepConfig(
        opts=lm.ForwardOpts(attn_impl="pallas", attn_chunk=128),
        adamw=adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=6))

    def make(seed, ckpt_dir, failure_at=None):
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            seed), "cuda", trainable=True)
        params = dict(model.named_parameters())
        stream = TokenStream(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=32, global_batch=4))
        return Trainer(
            TrainerConfig(total_steps=6, ckpt_dir=ckpt_dir, ckpt_every=2,
                          log_every=1, failure_at=failure_at),
            steps.make_train_step(cfg, scfg, model), params,
            steps.init_opt_state(cfg, scfg, params), iter(stream),
            data_state_fn=stream.state, data_restore_fn=stream.restore)

    def snapshot(t):
        a = t.opt_state["adamw"]
        return {"params": {k: v.clone() for k, v in t.params.items()},
                "m": {k: v.clone() for k, v in a.m.items()},
                "v": {k: v.clone() for k, v in a.v.items()},
                "step": int(a.step), "trainer_step": t.step,
                "data": t.data_state_fn()}

    saved = {}
    first = make(0, os.path.join(root, "run"), failure_at=5)
    real_save = first.save

    def save():
        saved[first.step] = snapshot(first)
        return real_save()

    first.save = save
    try:
        first.run()
        raise AssertionError("the injected failure did not fire")
    except InjectedFailure:
        pass
    resumed = make(1, os.path.join(root, "run"))
    assert resumed.maybe_resume() and resumed.step == 4
    now, then = snapshot(resumed), saved[4]
    for key in ("params", "m", "v"):
        for k, t in then[key].items():
            if not torch.equal(now[key][k], t):
                raise AssertionError(f"resume: {key} {k} differs from the "
                                     f"saved step 4")
    assert (now["step"], now["trainer_step"], now["data"]) == \
        (then["step"], then["trainer_step"], then["data"]), (now, then)
    resumed.run()
    straight = make(0, os.path.join(root, "straight"))
    straight.run()
    diff = max(float((a - b).abs().max()) for a, b in
               zip(resumed.params.values(), straight.params.values()))
    print(f"checkpoint at smoke widths on the card: saved at steps "
          f"{sorted(saved)}, failure injected at 5, resumed at 4 with "
          f"parameters, moments, step and data position ({now['data']}) "
          f"equal to the saved ones bit for bit; after step 6 the "
          f"parameters are {diff:.3g} from an uninterrupted run's (tol "
          f"{F32_TOL})")
    if diff > F32_TOL:
        raise AssertionError(f"resumed run {diff} off the uninterrupted one")


# Run in a fresh process with REPRO_ON_MISS=error: every deployment lookup
# the serve launcher makes for each arch it pages (plain, --speculative,
# --quant kv8 and both: paged_decode's and paged_verify's deployment
# contexts), then ops.matmul once at mm8k, all through default_tuner() and
# the shipped DB; prints one JSON line
DB_LOOKUPS = """
import json, torch
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import default_tuner
from repro_torch.kernels import matmul as mm_kernel
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import lm
torch.backends.cuda.matmul.allow_tf32 = False
tuner = default_tuner()
assert tuner.on_miss == "error", tuner.on_miss
chip = ops.device_chip(0)
found = {}
for arch in ARCHS:
    full = get_config(arch)
    try:
        lm._check_paged(full)
    except NotImplementedError:
        continue
    for quant in (None, "kv8"):
        found[f"{arch} paged_decode {quant}"] = tuner.best_config(
            ops.PAGED_DECODE, serve.deployment_context(full, chip, quant))
        found[f"{arch} paged_verify {quant}"] = tuner.best_config(
            ops.PAGED_VERIFY, serve.verify_deployment_context(full, chip,
                                                              quant))
g = torch.Generator(device="cuda").manual_seed(11)
x = torch.randn(8192, 8192, generator=g, device="cuda").bfloat16()
y = torch.randn(8192, 8192, generator=g, device="cuda").bfloat16()
found["matmul mm8k"] = tuner.best_config(
    ops.MATMUL, ops.matmul_context(chip, 8192, 8192, 8192, "bfloat16"))
mm_kernel.matmul.launches = 0
out = ops.matmul(x, y, config=found["matmul mm8k"]).float()
launches = mm_kernel.matmul.launches
want = ref.matmul(x, y).float()
print(json.dumps({"configs": found, "stats": tuner.stats(),
                  "launches": launches,
                  "max_abs_err": float((out - want).abs().max()),
                  "close": bool(torch.allclose(out, want, atol=2e-2,
                                               rtol=2e-2))}))
"""


def shipped_db_phase(chip) -> dict:
    """(a) The committed DB: every entry parses against the current spaces
    and names this card; (b) a fresh process with REPRO_ON_MISS=error
    resolves the serve launcher's deployment lookups and the mm8k matmul
    from it, no tune, and launches ops.matmul once; (c) the generator,
    restricted to matmul and matmul_w8a8, into a temporary file. Returns
    matmul's launches in (b) and (c)."""
    from repro_torch.configs import gen_shipped_db
    from repro_torch.core import TuningContext, get_chip, tuner as tuner_lib
    from repro_torch.core.cache import CacheEntry, cache_key
    from repro_torch.kernels import matmul as mm_kernel
    from repro_torch.kernels.registry import get_kernel
    with open(tuner_lib.SHIPPED_DB) as f:
        db = json.load(f)
    kernels = {}
    for key, raw in db.items():
        k = json.loads(key)
        c = json.loads(k["ctx"])
        assert c["chip"] == chip.name, (c["chip"], chip.name)
        ctx = TuningContext(chip=get_chip(c["chip"]),
                            shapes={n: tuple(v) for n, v in
                                    c["shapes"].items()},
                            dtype=c["dtype"], extra=c["extra"])
        tunable = get_kernel(k["kernel"]).tunable
        entry = CacheEntry.from_json(raw)
        assert cache_key(tunable.name, tunable.version, tunable.space,
                         ctx) == key, key
        assert tunable.space.is_valid(entry.config, ctx), (key, entry)
        assert entry.fingerprint["gpu"] == torch.cuda.get_device_name(0)
        kernels[k["kernel"]] = kernels.get(k["kernel"], 0) + 1
    print(f"(a) shipped DB: {len(db)} entries, every one parses against the "
          f"current spaces and names {chip.name}: {json.dumps(kernels)}")
    env = dict(os.environ, REPRO_ON_MISS="error",
               PYTHONPATH=os.path.join(REPO, "src"))
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", DB_LOOKUPS], env=env,
                         capture_output=True, text=True, timeout=600,
                         check=False)
    if res.returncode != 0:
        raise AssertionError(f"the lookup process failed:\n{res.stderr}")
    got = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"(b) a fresh process, REPRO_ON_MISS=error "
          f"({time.perf_counter() - t:.1f} s): " + json.dumps(got))
    stats = got["stats"]
    assert stats["tunes"] == stats["misses"] == 0, stats
    assert stats["hits"] == len(got["configs"]) >= 13, stats
    assert got["launches"] == 1 and got["close"], got
    mm_kernel.matmul.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "db.json")
        t = time.perf_counter()
        rc = gen_shipped_db.main(["--kernels", "matmul,matmul_w8a8",
                                  "--out", out])
        with open(out) as f:
            fresh = json.load(f)
    launches = mm_kernel.matmul.launches
    print(f"(c) gen_shipped_db --kernels matmul,matmul_w8a8 into a "
          f"temporary file: rc {rc}, {len(fresh)} entries in "
          f"{time.perf_counter() - t:.1f} s, matmul launched {launches} "
          f"times")
    assert rc == 0 and len(fresh) == 3 and set(fresh) <= set(db), fresh
    assert launches > 0
    for key, raw in fresh.items():
        print(f"  {json.loads(key)['kernel']} "
              f"{json.loads(json.loads(key)['ctx'])['shapes']}: "
              f"{raw['config']} ({raw['metric'] * 1e3:.4f} ms) against the "
              f"shipped {db[key]['config']} "
              f"({db[key]['metric'] * 1e3:.4f} ms)")
    return {"launches": launches + got["launches"],
            "config": got["configs"]["matmul mm8k"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import default_tuner
    from repro_torch.core.cache import cache_key
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as pd_kernel
    from repro_torch.kernels import paged_verify as pv_kernel
    from repro_torch.kernels import rms_norm as rms_kernel
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def elapsed() -> str:
        return f"[{time.perf_counter() - t_start:.0f} s]"

    phase("1. card and tools")
    card = card_line()
    print(card)
    print(json.dumps(versions(), sort_keys=True))
    chip = ops.device_chip(0)
    print(f"spec: {chip}")

    phase(f"2. build {elapsed()}")
    secs = build_kernels()
    print("build seconds: " + json.dumps({k: round(v, 1)
                                          for k, v in secs.items()}))

    phase(f"3. kernels against their plain versions {elapsed()}")
    pdk = check_paged_decode(chip)
    pvk = check_paged_verify(chip)
    rms = check_rms_norm(chip)
    dense_err = check_dense_decode(chip)
    kv8_err = check_kv8_decode(chip)
    pd8 = check_paged_decode_kv8(chip)
    pv8 = check_paged_verify_kv8(chip)
    w8_err = check_matmul_w8a8(chip)
    mm_err = check_matmul(chip)
    fa_err = check_flash_attention(chip)
    fab_err = check_flash_attention_bwd(chip)
    mla_err = check_mla_decode(chip)
    off_space_err = off_space_layouts(chip)
    for out, name in ((pdk, "paged_decode"), (pvk, "paged_verify"),
                      (pd8, "paged_decode int8"), (pv8, "paged_verify int8")):
        out["max_abs_err"] = max(out["max_abs_err"], off_space_err[name])
    registry_sweep(chip)

    phase(f"4. tuning (deployment lookups and the engines' contexts) "
          f"{elapsed()}")
    tuner = default_tuner()
    tuner.on_miss = "tune"
    shipped = tuner.cache.entries()
    argv = ["--full-config", "--requests", "8", "--prompt-len", "512",
            "--min-prompt-len", "128", "--gen", "32", "--max-batch", "8",
            "--prefill-chunk", "256"]
    t = time.perf_counter()
    engine, reqs, info = serve.prepare(serve.build_parser().parse_args(argv),
                                       tuner)
    print(f"prepare plain (weights on the card, pool, tuning): "
          f"{time.perf_counter() - t:.1f} s; {json.dumps(info)}")
    t = time.perf_counter()
    spec_engine, spec_reqs, spec_info = serve.prepare(
        serve.build_parser().parse_args(argv + ["--speculative"]), tuner)
    K = spec_engine.spec_k
    print(f"prepare --speculative: {time.perf_counter() - t:.1f} s; "
          f"{json.dumps(spec_info)}")
    print(f"the paged_verify deployment entry "
          f"{spec_info['verify_deployment_config']} recommends draft_k {K}")
    t = time.perf_counter()
    kv8_engine, kv8_reqs, kv8_info = serve.prepare(
        serve.build_parser().parse_args(argv + ["--quant", "kv8"]), tuner)
    print(f"prepare --quant kv8: {time.perf_counter() - t:.1f} s; "
          f"{json.dumps(kv8_info)}")
    t = time.perf_counter()
    kv8_spec_engine, kv8_spec_reqs, kv8_spec_info = serve.prepare(
        serve.build_parser().parse_args(
            argv + ["--quant", "kv8", "--speculative"]), tuner)
    K8 = kv8_spec_engine.spec_k
    print(f"prepare --quant kv8 --speculative: {time.perf_counter() - t:.1f} "
          f"s; {json.dumps(kv8_spec_info)}")
    print(f"the int8 paged_verify deployment entry "
          f"{kv8_spec_info['verify_deployment_config']} recommends draft_k "
          f"{K8}")
    full_cfg = engine.cfg
    deploy = [(ops.PAGED_DECODE, serve.deployment_context(full_cfg, chip, q))
              for q in (None, "kv8")]
    deploy += [(ops.PAGED_VERIFY,
                serve.verify_deployment_context(full_cfg, chip, q))
               for q in (None, "kv8")]
    own = {json.dumps(k, sort_keys=True) for k, _ in tuner.cache.items()}
    for kernel, ctx in deploy:
        key = cache_key(kernel.name, kernel.version, kernel.space, ctx)
        if key not in shipped or key in own:
            raise AssertionError(f"the deployment lookup {kernel.name} "
                                 f"{ctx.signature()} was tuned, not taken "
                                 f"from the shipped DB")
        print(f"deployment lookup {kernel.name} {ctx.dtype} "
              f"{dict(ctx.extra)}: a hit in the shipped DB -> "
              f"{shipped[key].config}")
    for k, entry in tuner.cache.items():
        ctx = json.loads(k["ctx"])
        print(f"tuned {k['kernel']} shapes {ctx['shapes']} extra "
              f"{ctx['extra']}: {entry.n_evaluated} configs timed in "
              f"{entry.measure_s:.1f} s -> {entry.config} "
              f"({entry.metric * 1e3:.4f} ms)")
    # The layouts the serving runs launch (the engines' page size and
    # table width): every valid config, the tuned one among them, checked
    # against the plain version, then the tuned one timed.
    contexts = dict((k.name, c) for k, c in
                    serve.engine_contexts(spec_engine)
                    if k.name != "rms_norm")
    assert contexts["paged_decode"].signature() == \
        serve.engine_contexts(engine)[0][1].signature()
    ps, max_pages = engine.pool.page_size, engine.scheduler.max_pages
    cfg = engine.cfg
    lens = {"paged_decode": ragged_lens(ps * max_pages,
                                        cfg.n_heads // cfg.n_kv_heads),
            "paged_verify": verify_lens(ps * max_pages, K)}
    for name, out in (("paged_decode", pdk), ("paged_verify", pvk)):
        tuned = tuner.best_config(
            {"paged_decode": ops.PAGED_DECODE,
             "paged_verify": ops.PAGED_VERIFY}[name], contexts[name])
        args = paged_case(7, engine.scheduler.max_batch, cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim, ps, max_pages,
                          lens[name], torch.bfloat16,
                          K if name == "paged_verify" else None)
        ctx, configs, worst = check_paged_layout(
            chip, "phi4-mini bf16 at the serving layout", args, ps,
            max_pages)
        if ctx.signature() != contexts[name].signature() \
                or tuned not in configs:
            raise AssertionError(f"serving config {tuned} under "
                                 f"{contexts[name]} is not among the "
                                 f"configs checked under {ctx}")
        out["max_abs_err"] = max(out["max_abs_err"], worst)
        timed = functools.partial(time_paged, chip, args, tuned, ps,
                                  max_pages)
        wrapper = {"paged_decode": pd_kernel.paged_decode,
                   "paged_verify": pv_kernel.paged_verify}[name]
        out.update(on_bulk_path(timed, wrapper))
        print(f"{name} at the serving layout (page {ps}, {max_pages} "
              f"pages a table) under {tuned}: " + json.dumps(
                  {k: v for k, v in out.items() if k != "max_abs_err"}))
    # The kv8 engine's layout: the int8 context (q bf16) at its pool
    ((kv8_tunable, kv8_ctx),) = [(k, c) for k, c in
                                 serve.engine_contexts(kv8_engine)
                                 if k.name == "paged_decode"]
    kv8_tuned = tuner.best_config(kv8_tunable, kv8_ctx)
    ps8 = kv8_engine.pool.page_size
    mp8 = kv8_engine.scheduler.max_pages
    args, scales = paged_kv8_case(
        8, kv8_engine.scheduler.max_batch, cfg.n_heads, cfg.n_kv_heads,
        cfg.head_dim, ps8, mp8, ragged_lens(ps8 * mp8, 3), torch.bfloat16)
    ctx, configs, worst = check_paged_layout(
        chip, "phi4-mini int8 pools, q bfloat16, at the kv8 serving layout",
        args, ps8, mp8, scales)
    if ctx.signature() != kv8_ctx.signature() or kv8_tuned not in configs:
        raise AssertionError(f"kv8 serving config {kv8_tuned} under "
                             f"{kv8_ctx} is not among the configs checked "
                             f"under {ctx}")
    pd8["max_abs_err"] = max(pd8["max_abs_err"], worst)
    pd8.update(on_bulk_path(lambda: time_paged(chip, args, kv8_tuned, ps8,
                                               mp8, scales)),
               library="SDPA over the pools pre-gathered and dequantized "
                       "to bf16 (dequant not timed)")
    print(f"paged_decode int8 at the kv8 serving layout (page {ps8}, {mp8} "
          f"pages a table) under {kv8_tuned}: " + json.dumps(
              {k: v for k, v in pd8.items() if k != "max_abs_err"}))
    ops.release_tuning_operands()
    time_deployment(chip, tuner, full_cfg)
    time_verify_deployment(chip, tuner, full_cfg)
    # The kv8 speculative engine's layout: the int8 verify context (q bf16)
    # at its pool and depth
    ((pv8_tunable, pv8_ctx),) = [(k, c) for k, c in
                                 serve.engine_contexts(kv8_spec_engine)
                                 if k.name == "paged_verify"]
    pv8_tuned = tuner.best_config(pv8_tunable, pv8_ctx)
    ps8 = kv8_spec_engine.pool.page_size
    mp8 = kv8_spec_engine.scheduler.max_pages
    args, scales = paged_kv8_case(
        10, kv8_spec_engine.scheduler.max_batch, cfg.n_heads, cfg.n_kv_heads,
        cfg.head_dim, ps8, mp8, verify_lens(ps8 * mp8, K8), torch.bfloat16,
        K8)
    ctx, configs, worst = check_paged_layout(
        chip, "phi4-mini int8 pools, q bfloat16, at the kv8 speculative "
        "serving layout", args, ps8, mp8, scales)
    if ctx.signature() != pv8_ctx.signature() or pv8_tuned not in configs:
        raise AssertionError(f"kv8 speculative serving config {pv8_tuned} "
                             f"under {pv8_ctx} is not among the configs "
                             f"checked under {ctx}")
    pv8["max_abs_err"] = max(pv8["max_abs_err"], worst)
    pv8.update(on_bulk_path(lambda: time_paged(chip, args, pv8_tuned, ps8,
                                               mp8, scales),
                            pv_kernel.paged_verify),
               library="SDPA with a causal-tail mask over the pools "
                       "pre-gathered and dequantized to bf16 (dequant not "
                       "timed)")
    print(f"paged_verify int8 at the kv8 speculative serving layout (page "
          f"{ps8}, {mp8} pages a table, K {K8}) under {pv8_tuned}: "
          + json.dumps({k: v for k, v in pv8.items() if k != "max_abs_err"}))
    rms_cfg = tuner.best_config(
        ops.RMS_NORM, ops.rmsnorm_context(chip, (8, 1, 3072), "bfloat16"))
    x, w = rms["args"]
    rms["kernel_ms"] = timer().time_runner(
        lambda: ops.rmsnorm(x, w, config=rms_cfg)) * 1e3
    print(f"rms_norm (8, 3072) bf16 under {rms_cfg}: kernel_ms "
          f"{rms['kernel_ms']:.4f}")
    da_cfg = tuner.best_config(ops.DECODE_ATTENTION,
                               ops.decode_attention_context(
                                   chip, 8, 24, 8, 128, DENSE_T, "bfloat16"))
    dak = time_dense(chip, "decode_attention", da_cfg, tuner)
    dak["max_abs_err"] = dense_err["decode_attention"]
    print("decode_attention at the serving shape, tuned: " + json.dumps(dak))
    kv8_kernel_, kv8_ctx = serve.dense_context(
        engine.cfg, 8, DENSE_T, torch.device("cuda"), "kv8")
    kv8_cfg = tuner.best_config(kv8_kernel_, kv8_ctx)
    kvk = time_kv8(chip, kv8_cfg)
    kvk["max_abs_err"] = kv8_err
    print("gqa_decode_kv8 at the serving shape under the serving config "
          f"(tuned on {kv8_ctx.signature()}): " + json.dumps(kvk))
    # The four matmul_w8a8 contexts a w8a8 dense run dispatches: tuned,
    # then the tuned configs timed beside the plain version, the
    # yardsticks and the bound
    w8 = {}
    for label, (tunable, ctx) in zip(W8A8_SERVING, serve.w8a8_contexts(
            engine.cfg, 8, 512, torch.device("cuda"))):
        shape = W8A8_SERVING[label]       # (M, K, N)
        assert ctx.shape("x") + ctx.shape("y")[1:] == shape, label
        t = time.perf_counter()
        tuned = tuner.best_config(tunable, ctx)
        tune_s = time.perf_counter() - t
        w8[label] = time_w8a8(chip, *shape, tuned)
        print(f"matmul_w8a8 {label} ({'x'.join(map(str, shape))}, per "
              f"channel; tuned in {tune_s:.1f} s): " + json.dumps(w8[label]))
    # The --attn-impl pallas prefill's context: tuned, then the tuned config
    # timed beside the plain version, SDPA and the bound
    t = time.perf_counter()
    fa_cfg = tuner.best_config(*serve.flash_context(
        engine.cfg, 8, 512, torch.device("cuda")))
    fak = time_flash(chip, fa_cfg)
    fak["max_abs_err"] = fa_err
    print(f"flash_attention at the serving prefill (tuned in "
          f"{time.perf_counter() - t:.1f} s): " + json.dumps(fak))
    fabk = tune_and_time_flash_bwd(tuner, chip, fab_err)
    mlak = tune_and_time_mla(tuner, chip, mla_err)
    # matmul: mm8k from the shipped DB (a hit, no tune), m256 in f32 tuned
    mm8k_ctx = ops.matmul_context(chip, *MM8K, "bfloat16")
    mm_cfg = tuner.best_config(ops.MATMUL, mm8k_ctx)
    assert cache_key(ops.MATMUL.name, ops.MATMUL.version, ops.MATMUL.space,
                     mm8k_ctx) in shipped
    mmk = time_matmul(chip, *MM8K, torch.bfloat16, mm_cfg)
    assert mmk["path"] == "wgmma", mmk
    print("matmul mm8k (8192^3 bf16, the shipped config): "
          + json.dumps(mmk))
    m256 = time_matmul(chip, 256, 256, 256, torch.float32, tuner.best_config(
        ops.MATMUL, ops.matmul_context(chip, 256, 256, 256, "float32")))
    print("matmul m256 (256^3 f32, tuned): " + json.dumps(m256))
    ops.release_tuning_operands()

    phase(f"5. serving phi4-mini-3.8b at full width {elapsed()}")
    counters = {"paged_decode": pd_kernel.paged_decode,
                "paged_verify": pv_kernel.paged_verify,
                "rms_norm": rms_kernel.rms_norm}
    n_layers = engine.cfg.n_layers
    assert n_layers == 32 and engine.cfg.d_model == 3072
    runs, paths = {}, {}
    for label, eng, rs in (("plain", engine, reqs),
                           (f"--speculative {K}", spec_engine, spec_reqs)):
        for fn in counters.values():
            fn.launches = 0
        pd_kernel.paged_decode.path_launches = {"bulk": 0, "cp_async": 0}
        report = serve.serve(eng, rs)
        launches = {k: fn.launches for k, fn in counters.items()}
        runs[label] = (report, launches)
        paths[label] = dict(pd_kernel.paged_decode.path_launches)
        print(f"run report ({label}): " + json.dumps(report, sort_keys=True))
        print(f"launches in the run ({label}): " + json.dumps(launches))
        assert report["lifecycle"]["terminal"] == len(rs) == 8
        assert report["lifecycle"]["failed"] == 0
        assert all(len(r.tokens) == 32 for r in rs)
        assert launches["rms_norm"] > 0, launches
        print(f"  tokens/s {report['tokens_per_s']:.1f}, TTFT p50 "
              f"{report['ttft_p50_ms']:.1f} ms p99 "
              f"{report['ttft_p99_ms']:.1f} ms, ITL p50 "
              f"{report['itl_p50_ms']:.2f} ms p99 "
              f"{report['itl_p99_ms']:.2f} ms, peak memory "
              f"{report['peak_memory_bytes'] / 2**30:.2f} GiB")
    (report, launches), (spec_report, spec_launches) = runs.values()
    assert launches["paged_decode"] == report["decode_steps"] * n_layers, \
        launches
    assert paths["plain"] == {"bulk": launches["paged_decode"],
                              "cp_async": 0}, paths
    print(f"paged_decode launches by path (plain run): {paths['plain']}")
    assert launches["paged_verify"] == 0, launches
    sp = spec_report["speculative"]
    assert sp["draft_k"] == K and not sp["degraded"], sp
    assert spec_report["decode_steps"] == 0 == spec_launches["paged_decode"]
    assert spec_launches["paged_verify"] == \
        spec_report["verify_passes"] * n_layers > 0, spec_launches
    first_divergences(engine, reqs, spec_reqs, K)
    kv8_paged = kv8_paged_serving(kv8_engine, kv8_reqs, reqs, counters)
    kv8_spec = kv8_spec_serving(kv8_spec_engine, kv8_spec_reqs, kv8_engine,
                                kv8_reqs, runs[f"--speculative {K}"],
                                counters)
    for fn in counters.values():
        fn.launches = 0
    off = serve.main(["--requests", "4", "--prompt-len", "48", "--gen",
                      "16", "--max-batch", "4", "--speculative", "5"])
    print(f"launcher --speculative 5 (smoke widths): paged_verify launches "
          f"{pv_kernel.paged_verify.launches}")
    assert off["speculative"]["draft_k"] == 5, off["speculative"]
    assert off["lifecycle"]["terminal"] == 4 and \
        off["lifecycle"]["failed"] == 0, off
    assert pv_kernel.paged_verify.launches == off["verify_passes"] * 2 > 0
    dense = dense_serving(tuner, n_layers)
    flash = flash_dense_serving(tuner, engine.model, dense["report"])
    dense_kv8 = dense_serving(tuner, n_layers, "kv8")
    same = sum(a == b for a, b in zip(dense_kv8["report"]["tokens"],
                                      dense["report"]["tokens"]))
    print(f"--quant kv8 vs bf16 caches (--decode-impl pallas): {same}/8 "
          f"token streams equal (reported, not held)")
    w8a8 = w8a8_dense_serving(tuner, n_layers, dense["report"]["tokens"])
    gq_cfg = tuner.best_config(
        *serve.dense_context(engine.cfg, 8, DENSE_T, torch.device("cuda")))
    gqk = time_dense(chip, "gqa_decode_ragged", gq_cfg, tuner)
    gqk["max_abs_err"] = dense_err["gqa_decode_ragged"]
    print("gqa_decode_ragged at the serving shape under the serving config: "
          + json.dumps(gqk))
    timer_floor(chip, gq_cfg)

    phase(f"6. full-width steps: kernels against plain versions, and where "
          f"their time goes {elapsed()}")
    full_width_check(engine)
    full_width_check(kv8_engine)
    verify_check(spec_engine)
    verify_check(kv8_spec_engine)
    dense_step_check(engine.model, engine.cfg)
    dense_step_check(engine.model, engine.cfg, quant="kv8")
    w8a8_step_check()
    prefill_check(engine.model, engine.cfg)
    profile_decode(engine)
    profile_verify(spec_engine)
    profile_decode(kv8_engine)
    profile_verify(kv8_spec_engine)
    one_launch_fresh({"decode_attention": da_cfg,
                      "gqa_decode_ragged": gq_cfg,
                      "paged_verify": tuner.best_config(
                          ops.PAGED_VERIFY, contexts["paged_verify"])})
    rejection_run()
    rejection_run(K=5, page_size=4)
    rejection_run(quant="kv8")

    phase(f"7. serving {DSV2} at full width (MLA + MoE) {elapsed()}")
    # every phi4-mini model goes before the 31 GB of deepseek weights come;
    # ``eng``, phase 5's loop variable, holds the speculative engine
    del engine, spec_engine, kv8_engine, kv8_spec_engine, eng
    w8a8_model.cache_clear()
    ops.release_tuning_operands()
    release("before the deepseek phase")
    mla = mla_dense_serving(tuner)

    phase(f"8. a full-width {DSV2} decode step: mla_decode against the "
          f"einsum, and where its time goes; the streams in float32 "
          f"{elapsed()}")
    mla_step_check(*dsv2_model())
    dsv2_model.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    mla_f32_streams(tuner)

    phase(f"9. training phi4-mini-3.8b at full width: flash_attention_bwd "
          f"behind the autograd function {elapsed()}")
    release("before the training phase")
    train = training_runs()
    train_step_check()
    release("after the full-width step check")
    train_f32()
    release("after the float32 runs")
    with tempfile.TemporaryDirectory() as root:
        train_checkpoint(root)

    phase(f"10. the shipped H100 tuning DB {elapsed()}")
    db = shipped_db_phase(chip)
    assert db["config"] == mm_cfg, (db["config"], mm_cfg)

    phase(f"11. summary {elapsed()}")

    def entry(name, route, source, replaces, launches, out):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": out["max_abs_err"], "ms": out["kernel_ms"],
                "plain_ms": out["plain_ms"], "bound_ms": out["bound_ms"],
                "bound_by": out["bound_by"],
                "library_ms": out["library_ms"]}

    kernels = [
        entry("paged_decode", "cuda", "src/repro_torch/csrc/paged_decode.cu",
              "src/repro/kernels/paged_decode.py:54",
              launches["paged_decode"], pdk),
        entry("paged_decode_int8", "cuda",
              "src/repro_torch/csrc/paged_decode.cu",
              "src/repro/kernels/paged_decode.py:54",
              kv8_paged["launches"]["paged_decode"], pd8),
        entry("paged_verify", "cuda", "src/repro_torch/csrc/paged_verify.cu",
              "src/repro/kernels/paged_verify.py:52",
              spec_launches["paged_verify"], pvk),
        entry("paged_verify_int8", "cuda",
              "src/repro_torch/csrc/paged_verify.cu",
              "src/repro/kernels/paged_verify.py:52",
              kv8_spec["launches"]["paged_verify"], pv8),
        entry("rms_norm", "triton", "src/repro_torch/kernels/rms_norm.py",
              "src/repro/kernels/rms_norm.py:24", launches["rms_norm"], rms),
        entry("gqa_decode_ragged", "cuda", "src/repro_torch/csrc/gqa_decode.cu",
              "src/repro/kernels/gqa_decode.py:43",
              dense["launches"]["gqa_decode_ragged"], gqk),
        entry("decode_attention", "cuda", "src/repro_torch/csrc/gqa_decode.cu",
              "src/repro/kernels/decode_attention.py:38",
              dense["launches"]["decode_attention"], dak),
        entry("gqa_decode_kv8", "cuda",
              "src/repro_torch/csrc/gqa_decode_kv8.cu",
              "src/repro/kernels/gqa_decode_kv8.py:44",
              dense_kv8["launches"]["gqa_decode_kv8"], kvk),
        entry("matmul_w8a8", "cuda", "src/repro_torch/csrc/matmul_w8a8.cu",
              "src/repro/kernels/matmul_int8.py:48",
              w8a8["launches"]["matmul_w8a8"],
              dict(w8["decode wi"], max_abs_err=w8_err)),
        entry("flash_attention", "cuda",
              "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:36",
              flash["launches"]["flash_attention"], fak),
        entry("flash_attention_bwd", "cuda",
              "src/repro_torch/csrc/flash_attention_bwd.cu",
              "src/repro/kernels/flash_attention_bwd.py:62 and :110",
              train["pallas"]["launches"]["flash_attention_bwd"], fabk),
        entry("mla_decode", "cuda", "src/repro_torch/csrc/mla_decode.cu",
              "src/repro/kernels/mla_decode.py:43",
              mla["launches"]["mla_decode"], mlak),
        entry("matmul", "cuda", "src/repro_torch/csrc/matmul.cu",
              "src/repro/kernels/matmul.py:23", db["launches"],
              dict(mmk, max_abs_err=max(mmk["max_abs_err"],
                                        *mm_err.values()))),
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
