"""Serving launcher on the card: paged continuous batching, or a static
batch over dense caches.

  PYTHONPATH=src python -m repro_torch.launch.serve --full-config \\
      --requests 8 --prompt-len 512 --gen 32 --max-batch 8 \\
      [--speculative [K]] [--quant kv8]
  PYTHONPATH=src python -m repro_torch.launch.serve --full-config \\
      --requests 8 --prompt-len 512 --gen 32 --decode-impl pallas|full \\
      [--attn-impl chunked|full|pallas] \\
      [--quant kv8 | --quant w8a8 [--quant-impl sim|pallas]]

The port of ``repro.launch.serve``. ``--decode-impl`` takes the reference's
choices, so one command line runs on both launchers:

  paged   — (the port's default; the reference's default arch, a windowed
            one, cannot run in the port yet) continuous batching over a
            page pool, below;
  pallas  — a static batch over dense per-request caches, decoding through
            the registry's hand-written decode kernel (``gqa_decode_ragged``,
            or ``gqa_decode_kv8`` under ``--quant kv8``, CUDA here), tuned at
            the serving context on a miss;
  full    — the same static batch through the plain einsum decode.

``--quant kv8`` (the reference's kv8 policy, ``repro_torch.quant``) makes
the caches int8 with per-token-per-head f32 scales. On the dense path the
prompt is attended in full precision and only what persists is
quantized; each decode step quantizes its new token, then attends
through ``gqa_decode_kv8`` (``pallas``) or the einsum over the cache
dequantized in f32 (``full``). On the paged path the page pools are int8
with f32 scale pools: each prefill chunk and decode token is quantized as
it is written, the chunked prefill attends the pool dequantized in f32,
and decode runs the int8 branch of the ``paged_decode`` CUDA kernel (under
``--speculative``, verify the int8 branch of ``paged_verify``); the
deployment lookups are the canonical scenarios at dtype ``int8`` (q in
bfloat16), keys of their own.

``--quant w8a8`` (the dense path only, ``pallas`` or ``full``) makes the
MLP projections int8 ``QTensor``s with one scale per output channel,
quantized once after the weights are made (the bf16 originals are
released), and quantizes their activations per token at run time. Their
GEMMs run by ``--quant-impl``: ``sim`` (the reference's default) is the
exact integer-grid float32 product, ``pallas`` the hand-written CUDA
``matmul_w8a8``, tuned before the timed run at the four contexts the run
dispatches (prefill and decode rows, for ``wi`` and ``wo``). ``w8a16``,
and ``w8a8`` on the paged path, are not ported and raise
``NotImplementedError``.

The dense path (``serve_dense``) follows the reference's: B uniform prompts
of ``--prompt-len`` tokens drawn from ``--seed`` with numpy, prefill by
``--attn-impl`` (``ForwardOpts.attn_impl``: ``chunked``, the reference's
default, over KV chunks of 64; ``full``, one masked einsum; ``pallas``,
the hand-written CUDA ``flash_attention``, tuned before the timed run at
the prompt's context), then ``--gen`` - 1 greedy decode steps with the
argmax on the device; ``--max-batch`` and ``--prefill-chunk`` are
paged-only and ignored there, ``--speculative`` is refused. ``--device
cpu`` runs it on the CPU, where the kernel wrappers take their plain
versions. The paged path's chunked prefill is the reference's einsum over
the pool (``attn_prefill_paged``), so it refuses ``--attn-impl pallas``.

The paged path: the pool's
page size comes from the tuner's deployment-level ``paged_decode`` config:
the canonical scenario (``q (16, Hq, D)``, ``k (16, Hkv, 32768, D)``,
bfloat16, page size free) of the full config's head geometry, which the
shipped H100 DB holds (``configs.gen_shipped_db``), tuned on the card on a
miss. The run then tunes the exact contexts the engine will
dispatch (``ServingEngine`` kernels at its pool layout), serves the
requests with the ``paged_decode`` CUDA kernel and the ``rms_norm`` Triton
kernel on every layer, and prints one structured run report.

``--speculative [K]`` (``--speculative`` of the reference's paged path)
serves by draft and verify through the ``paged_verify`` CUDA kernel
instead, with K draft positions a step. The bare flag takes K from the
tuned ``paged_verify`` deployment entry (the same canonical scenario with
``draft_k`` and ``page_size`` free); the pool keeps ``paged_decode``'s
page size either way.

The paged path runs on the card only: with no CUDA device it raises
instead of carrying on on the CPU. Tensor parallelism (``--tp``) is not
ported and raises ``NotImplementedError``.

``--arch deepseek-v2-lite-16b`` (MLA attention, MoE layers) and
``--arch olmoe-1b-7b`` (MoE layers) serve on the dense path only, as the
reference's paged path refuses them: ``pallas`` decodes an MLA arch
through the hand-written CUDA ``mla_decode`` over the latent cache (tuned
before the timed run at the serving context), ``full`` through the
reference's einsum; the MoE layers are the reference's index dispatch in
plain torch ops. Refused by name (``NotImplementedError``) on these
archs: ``--decode-impl paged`` and ``--speculative`` (MLA or MoE),
``--quant kv8`` (MLA: no int8 latent cache), ``--quant w8a8|w8a16``
(MoE: no quantized path for the stacked expert weights) and
``--attn-impl pallas`` (MLA: q and k are wider than v, and
``flash_attention`` takes one head dim).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.gen_shipped_db import (
    SHIP_DTYPE, paged_deployment_shapes,
)
from repro_torch.core.tuner import Autotuner, default_tuner
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import gqa_decode as gqa_kernel
from repro_torch.kernels import gqa_decode_kv8 as kv8_kernel
from repro_torch.kernels import matmul_w8a8 as mm8_kernel
from repro_torch.kernels import mla_decode as mla_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import paged_verify as pv_kernel
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import init_params
from repro_torch.quant import quantize_params
from repro_torch.serving import Request, ServingEngine


def _deploy_dtype(quant: Optional[str]) -> str:
    """The pools' dtype of a deployment lookup: ``int8`` under kv8 (q stays
    in the shipped dtype), else the shipped dtype."""
    return lm.ForwardOpts(quant=quant).kv_dtype() or SHIP_DTYPE


def _deploy_dims(full_cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    """(B, Hq, Hkv, D, tokens) of the shipped DB's deployment scenario
    (``gen_shipped_db.paged_deployment_shapes``)."""
    shapes = paged_deployment_shapes(full_cfg)
    (B, Hq, D), (_, Hkv, T, _) = shapes["q"], shapes["k"]
    return B, Hq, Hkv, D, T


def deployment_context(full_cfg: ModelConfig, chip,
                       quant: Optional[str] = None):
    """The canonical ``paged_decode`` deployment scenario, as the shipped
    DB holds it; under kv8 the same shapes at dtype ``int8`` with q in the
    shipped dtype, so int8 pools size by their own winner."""
    return ops.paged_decode_context(
        chip, *_deploy_dims(full_cfg), _deploy_dtype(quant),
        q_dtype=SHIP_DTYPE)


def verify_deployment_context(full_cfg: ModelConfig, chip,
                              quant: Optional[str] = None):
    """The canonical ``paged_verify`` deployment scenario (depth and page
    size free); under kv8 at dtype ``int8`` with q in the shipped dtype,
    as the reference looks both kernels up in one int8 context."""
    return ops.paged_verify_context(
        chip, *_deploy_dims(full_cfg), _deploy_dtype(quant),
        q_dtype=SHIP_DTYPE)


def pool_page_size(deploy_page_size: int, max_seq_len: int) -> int:
    """The deployment winner's page size, clamped to the largest tunable
    one a single sequence can still fill."""
    fits = max(v for v in ops.PAGE_SIZES
               if v <= max(min(ops.PAGE_SIZES), max_seq_len))
    return min(fits, deploy_page_size)


def make_requests(cfg: ModelConfig, n: int, min_prompt: int, max_prompt: int,
                  gen: int, seed: int) -> List[Request]:
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        prompt = rng.integers(1, cfg.vocab_size, plen,
                              dtype=np.int64).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gen))
    return reqs


def engine_contexts(engine: ServingEngine):
    """Every (kernel, context) the engine's steps tune: paged_decode at the
    pool layout (an int8 context, q in the model's dtype, for kv8 pools),
    rms_norm on prefill chunks and on decode rows, and under speculation
    paged_verify at the pool layout and the engine's depth, with rms_norm
    on its K rows a slot (an int8 context too, for kv8 pools). A page
    size or depth outside the spaces dispatches a fixed config and has no
    context to tune."""
    cfg, sched, pool = engine.cfg, engine.scheduler, engine.pool
    chip = ops.device_chip(engine.device.index or 0)
    dt = cfg.dtype
    cap = sched.max_pages * pool.page_size
    in_space = pool.page_size in ops.PAGE_SIZES
    out = []
    if in_space:
        out.append((ops.PAGED_DECODE, ops.paged_decode_context(
            chip, sched.max_batch, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cap, engine.opts.kv_dtype() or dt, pool.page_size,
            q_dtype=dt)))
    norm_shapes = [(1, sched.prefill_chunk, cfg.d_model),
                   (sched.max_batch, 1, cfg.d_model)]
    if engine.spec_k > 1:
        if in_space and engine.spec_k in pv_kernel.DRAFT_KS:
            out.append((ops.PAGED_VERIFY, ops.paged_verify_context(
                chip, sched.max_batch, cfg.n_heads, cfg.n_kv_heads,
                cfg.head_dim, cap, engine.opts.kv_dtype() or dt,
                pool.page_size, engine.spec_k, q_dtype=dt)))
        norm_shapes.append((sched.max_batch, engine.spec_k, cfg.d_model))
    if engine.opts.norm_impl == "kernel":
        out += [(ops.RMS_NORM, ops.rmsnorm_context(chip, shape, dt))
                for shape in norm_shapes]
    return out


def prepare(args, tuner: Autotuner) -> Tuple[ServingEngine, List[Request],
                                             dict]:
    """Build the engine and its requests, tuning every kernel context the
    run will dispatch. Returns (engine, requests, deployment info)."""
    if args.device != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("paged serving in repro_torch.launch.serve runs "
                           "on a CUDA card; no CUDA device is available")
    cfg = get_config(args.arch, smoke=not args.full_config)
    full_cfg = get_config(args.arch)
    device = torch.device("cuda")
    max_seq_len = args.prompt_len + args.gen
    chip = ops.device_chip(device.index or 0)
    quant = None if args.quant == "none" else args.quant
    deploy_cfg = tuner.best_config(ops.PAGED_DECODE,
                                   deployment_context(full_cfg, chip, quant))
    info = {"arch": cfg.name, "quant": args.quant,
            "deployment_config": deploy_cfg}
    spec_k = 0
    if args.speculative is not None:
        verify_cfg = tuner.best_config(
            ops.PAGED_VERIFY, verify_deployment_context(full_cfg, chip,
                                                        quant))
        spec_k = (args.speculative if args.speculative >= 2
                  else int(verify_cfg["draft_k"]))
        info.update(verify_deployment_config=verify_cfg, draft_k=spec_k)
    page_size = pool_page_size(deploy_cfg["page_size"], max_seq_len)
    # Room for a padded prefill chunk (or a verify burst) past the longest
    # sequence, so padded positions never clip onto live KV.
    room = max(args.prefill_chunk, spec_k)
    pages_per_seq = -(-(max_seq_len + room) // page_size)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_params(cfg, gen, device)
    engine = ServingEngine(
        cfg, model, num_pages=1 + args.max_batch * pages_per_seq,
        page_size=page_size, max_batch=args.max_batch,
        max_seq_len=max_seq_len + room,
        prefill_chunk=args.prefill_chunk,
        opts=lm.ForwardOpts(decode_impl="kernel", norm_impl="kernel",
                            quant=quant),
        device=device, speculative=spec_k)
    for kernel, ctx in engine_contexts(engine):
        tuner.best_config(kernel, ctx)
    ops.release_tuning_operands()
    reqs = make_requests(cfg, args.requests,
                         args.min_prompt_len or max(1, args.prompt_len // 2),
                         args.prompt_len, args.gen, args.seed)
    info.update(page_size=page_size, num_pages=engine.pool.num_pages)
    return engine, reqs, info


def serve(engine: ServingEngine, reqs: List[Request]) -> dict:
    """Serve ``reqs``, check the drain, and return the run report."""
    torch.cuda.reset_peak_memory_stats(engine.device)
    res = engine.run(reqs)
    assert res["terminal_requests"] == len(reqs), \
        f"non-terminal requests after drain: {res}"
    engine.scheduler.check_invariants()
    assert engine.pool.num_allocated == 0, "page leak after drain"
    lat = res["latency"]
    report = {
        "quant": engine.opts.quant or "none",
        "requests": res["requests"],
        "generated_tokens": res["generated_tokens"],
        "steps": res["steps"],
        "decode_steps": res["decode_steps"],
        "verify_passes": res["verify_passes"],
        "wall_s": res["wall_s"],
        "tokens_per_s": res["tokens_per_s"],
        "ttft_p50_ms": lat["ttft_p50_ms"],
        "ttft_p99_ms": lat["ttft_p99_ms"],
        "itl_p50_ms": lat["itl_p50_ms"],
        "itl_p99_ms": lat["itl_p99_ms"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(engine.device),
        "lifecycle": {"preemptions": res["preemptions"],
                      "resumes": res["resumes"],
                      "failed": res["failed_requests"],
                      "timed_out": res["timed_out_requests"],
                      "terminal": res["terminal_requests"]},
    }
    if "speculative" in res:
        report["speculative"] = res["speculative"]
    return report


def dense_context(cfg: ModelConfig, batch: int, max_len: int, device,
                  quant: Optional[str] = None):
    """(kernel, context) the dense decode steps dispatch: the batch, the
    model's heads and caches of ``max_len`` slots; ``gqa_decode_ragged``
    over float caches, ``gqa_decode_kv8`` (int8 context, q in the
    model's dtype) under kv8."""
    chip = ops.device_chip(device.index or 0)
    shape = (batch, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, max_len)
    if lm.ForwardOpts(quant=quant).kv_dtype() == "int8":
        return ops.GQA_DECODE_KV8, ops.gqa_decode_kv8_context(
            chip, *shape, q_dtype=cfg.dtype)
    return ops.GQA_DECODE_RAGGED, ops.gqa_decode_context(chip, *shape,
                                                         cfg.dtype)


def mla_context(cfg: ModelConfig, batch: int, max_len: int, device):
    """(kernel, context) an MLA arch's dense decode steps dispatch:
    ``mla_decode`` over the batch's latent caches of ``max_len`` slots, q
    in the model's dtype."""
    chip = ops.device_chip(device.index or 0)
    m = cfg.mla
    return ops.MLA_DECODE, ops.mla_decode_context(
        chip, batch, cfg.n_heads, m.kv_lora_rank, m.qk_rope_dim, max_len,
        cfg.dtype)


def decode_context(cfg: ModelConfig, batch: int, max_len: int, device,
                   quant: Optional[str] = None):
    """(kernel, context) the dense decode steps dispatch under
    ``--decode-impl pallas``: ``mla_context`` for an MLA arch, else
    ``dense_context``."""
    if cfg.mla is not None:
        return mla_context(cfg, batch, max_len, device)
    return dense_context(cfg, batch, max_len, device, quant)


# The kernels the dense path may launch, counted in its run report
DENSE_KERNELS = {"gqa_decode_ragged": gqa_kernel.gqa_decode,
                 "gqa_decode_kv8": kv8_kernel.gqa_decode_kv8,
                 "mla_decode": mla_kernel.mla_decode,
                 "flash_attention": fa_kernel.flash_attention,
                 "matmul_w8a8": mm8_kernel.matmul_w8a8}


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in DENSE_KERNELS.items()}


def flash_context(cfg: ModelConfig, batch: int, prompt_len: int, device):
    """(kernel, context) the ``--attn-impl pallas`` prefill dispatches:
    causal flash_attention over the batch's prompts, q (B, Hq, P, D) and
    k, v (B, Hkv, P, D) in the model's dtype."""
    chip = ops.device_chip(device.index or 0)
    return ops.FLASH_ATTENTION, ops.attention_context(
        chip, batch, cfg.n_heads, cfg.n_kv_heads, prompt_len, prompt_len,
        cfg.head_dim, cfg.dtype, causal=True)


def w8a8_contexts(cfg: ModelConfig, batch: int, prompt_len: int, device):
    """(kernel, context) of every ``matmul_w8a8`` GEMM a w8a8 dense run
    dispatches: the MLP's ``wi`` (d_model x 2 d_ff) and ``wo`` (d_ff x
    d_model) at the prefill's B·P rows and the decode steps' B rows, per
    channel."""
    chip = ops.device_chip(device.index or 0)
    d, f = cfg.d_model, cfg.d_ff_dense or cfg.d_ff
    return [(ops.MATMUL_W8A8, ops.matmul_w8a8_context(chip, M, K, N))
            for M in (batch * prompt_len, batch)
            for K, N in ((d, 2 * f), (f, d))]


def serve_dense(args, tuner: Autotuner) -> dict:
    """Static batch with dense per-request caches (int8 under ``--quant
    kv8``): prefill by ``--attn-impl`` (``pallas``: the flash_attention
    kernel), then G - 1 greedy decode steps through the
    ``gqa_decode_ragged`` or ``gqa_decode_kv8`` kernel (``--decode-impl
    pallas``) or the plain einsum (``full``). Under ``--quant w8a8`` the
    MLP weights are quantized once after they are made and their GEMMs
    run by ``--quant-impl``. An MLA arch decodes through ``mla_decode``
    (``pallas``) or the reference's absorbed einsum (``full``). Returns
    the run report, with the launches of each kernel the run made
    (``"launches"``) and the generated tokens (B, G) under
    ``"tokens"``."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to serve on the CPU")
    cfg = get_config(args.arch, smoke=not args.full_config)
    B, P, G = args.requests, args.prompt_len, args.gen
    kernel = args.decode_impl == "pallas"
    quant = None if args.quant == "none" else args.quant
    opts = lm.ForwardOpts(attn_impl=args.attn_impl, attn_chunk=64,
                          decode_impl="kernel" if kernel else "plain",
                          quant=quant, quant_impl=args.quant_impl)
    model = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)
    quantize_params(model, quant)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, P),
                                            dtype=np.int64)).to(device)
    if device.type == "cuda":
        contexts = [decode_context(cfg, B, P + G, device, quant)] \
            if kernel else []
        if args.attn_impl == "pallas":
            contexts.append(flash_context(cfg, B, P, device))
        if quant == "w8a8" and args.quant_impl == "pallas":
            contexts += w8a8_contexts(cfg, B, P, device)
        for tunable, ctx in contexts:
            tuned = tuner.best_config(tunable, ctx)
            print(f"{tunable.name} at the serving context "
                  f"{dict(ctx.shapes)}: {tuned}")
        ops.release_tuning_operands()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = _launch_counts()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(model, cfg, prompts, max_len=P + G, opts=opts)
    tok = torch.argmax(logits, -1, keepdim=True)
    sync()
    prefill_s = time.perf_counter() - t0
    outs = [tok]
    t0 = time.perf_counter()
    for i in range(G - 1):
        logits, cache = lm.decode_step(model, cfg, tok, cache, P + i, opts)
        tok = torch.argmax(logits, -1, keepdim=True)
        outs.append(tok)
    sync()
    decode_s = time.perf_counter() - t0
    launches = {k: n - before[k] for k, n in _launch_counts().items()}
    tokens = torch.cat(outs, 1).cpu().tolist()
    return {
        "arch": cfg.name, "attn_impl": args.attn_impl,
        "decode_impl": args.decode_impl,
        "quant": args.quant, "quant_impl": args.quant_impl,
        "device": str(device), "requests": B, "prompt_len": P, "gen": G,
        "prefill_ms": prefill_s * 1e3, "decode_ms": decode_s * 1e3,
        "tokens_per_s": B * (G - 1) / decode_s if G > 1 else 0.0,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "launches": launches, "sample": tokens[0][:12], "tokens": tokens,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="phi4-mini-3.8b",
                    help="deepseek-v2-lite-16b (MLA + MoE) and olmoe-1b-7b "
                         "(MoE) serve on the dense path only")
    ap.add_argument("--full-config", action="store_true",
                    help="serve the published widths (default: smoke)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48,
                    help="longest prompt")
    ap.add_argument("--min-prompt-len", type=int, default=0,
                    help="shortest prompt (default: half the longest)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--decode-impl", choices=("full", "pallas", "paged"),
                    default="paged",
                    help="paged = continuous batching over the page pool; "
                         "pallas = a static batch over dense caches through "
                         "the registry's decode kernel (CUDA here); full = "
                         "the same batch through the plain einsum decode")
    ap.add_argument("--attn-impl", choices=("chunked", "full", "pallas"),
                    default="chunked",
                    help="the dense path's prefill attention: chunked (the "
                         "reference's default, KV chunks of 64) or full in "
                         "plain torch ops; pallas = the hand-written "
                         "flash_attention kernel (CUDA here); the paged "
                         "path refuses pallas")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="concurrent sequences (paged only)")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="chunked-prefill width (paged only)")
    ap.add_argument("--speculative", type=int, nargs="?", const=0,
                    default=None, metavar="K",
                    help="draft-and-verify decoding with K positions a "
                         "step through the paged_verify kernel (output "
                         "equals plain decode); the bare flag takes K from "
                         "the tuned paged_verify deployment entry")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--on-miss", choices=("tune", "heuristic", "error"),
                    default="tune")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu serves the dense path on the CPU (the kernel "
                         "wrappers run their plain versions); paged serving "
                         "needs the card")
    ap.add_argument("--quant", choices=("none", "w8a8", "w8a16", "kv8"),
                    default="none",
                    help="kv8 = int8 caches with per-token scales (dense "
                         "caches, or page pools under --decode-impl paged, "
                         "with or without --speculative); w8a8 = int8 MLP "
                         "weights and per-token int8 activations (dense "
                         "path only); w8a16 is not ported and raises")
    ap.add_argument("--quant-impl", choices=("sim", "pallas"),
                    default="sim",
                    help="the w8a8 GEMM: sim = the exact integer-grid "
                         "float32 product (the reference's default); "
                         "pallas = the hand-written matmul_w8a8 kernel "
                         "(CUDA here)")
    ap.add_argument("--tp", type=int, default=1,
                    help="not ported: anything but 1 raises")
    return ap


def _refuse_for_arch(args, cfg: ModelConfig) -> None:
    """What the port does not serve on an MLA or MoE arch, each refused by
    name, as the reference refuses it or leaves it untested."""
    kind = "MLA" if cfg.mla is not None else "MoE" if cfg.moe else None
    if kind is None:
        return
    if args.decode_impl == "paged":
        raise NotImplementedError(
            f"--decode-impl paged on {cfg.name} ({kind}): paged serving "
            f"takes dense GQA archs (serve it with --decode-impl "
            f"pallas|full)")
    if args.speculative is not None:
        raise NotImplementedError(
            f"--speculative on {cfg.name} ({kind}): draft and verify run on "
            f"the paged engine, which takes dense GQA archs")
    if args.quant == "kv8" and cfg.mla is not None:
        raise NotImplementedError(
            f"--quant kv8 on {cfg.name}: kv8 int8 caching needs the "
            f"latent-cache quant path, and MLA caches latents")
    if args.quant in ("w8a8", "w8a16") and cfg.moe is not None:
        raise NotImplementedError(
            f"--quant {args.quant} on {cfg.name}: the MoE experts' stacked "
            f"weights have no quantized path")
    if args.attn_impl == "pallas" and cfg.mla is not None:
        raise NotImplementedError(
            f"--attn-impl pallas on {cfg.name}: MLA's q and k are "
            f"{cfg.attn_qk_dim} wide and v {cfg.attn_v_dim}, and "
            f"flash_attention takes one head dim (prefill by chunked or "
            f"full)")


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    _refuse_for_arch(args, get_config(args.arch))
    if args.quant == "w8a16":
        raise NotImplementedError("--quant w8a16: w8a16 weights are not "
                                  "ported yet")
    if args.quant == "w8a8" and args.decode_impl == "paged":
        raise NotImplementedError(
            "--quant w8a8 on the paged path: the paged engine takes no "
            "weight policy yet (w8a8 serves with --decode-impl pallas|full)")
    if args.tp != 1:
        raise NotImplementedError(f"--tp {args.tp}: tensor-parallel serving "
                                  "is not ported")
    if args.attn_impl == "pallas" and args.decode_impl == "paged":
        raise NotImplementedError(
            "--attn-impl pallas on the paged path: its chunked prefill is "
            "the reference's einsum over the pool (attn_prefill_paged), not "
            "flash_attention (--attn-impl pallas serves with --decode-impl "
            "pallas|full)")
    if args.speculative is not None and args.decode_impl != "paged":
        raise SystemExit("--speculative requires --decode-impl paged "
                         "(draft-and-verify runs on the paged engine)")
    if args.decode_impl != "full":
        from repro_torch.kernels.registry import list_kernels
        names = ", ".join(s.name for s in list_kernels(scenario="decode"))
        print(f"decode via registry kernels (available: {names})")
    tuner = default_tuner()
    tuner.on_miss = args.on_miss
    if args.decode_impl != "paged":
        report = serve_dense(args, tuner)
        report["tuner"] = tuner.stats()
        print("run report:", json.dumps(
            {k: v for k, v in report.items() if k != "tokens"},
            sort_keys=True))
        print("sample:", report["sample"])
        return report
    t0 = time.perf_counter()
    engine, reqs, info = prepare(args, tuner)
    print("paged serving:", json.dumps(info, sort_keys=True))
    print(f"set-up (weights, pool, tuning): {time.perf_counter() - t0:.1f} s")
    report = serve(engine, reqs)
    report["tuner"] = tuner.stats()
    print("run report:", json.dumps(report, sort_keys=True))
    print("sample:", engine.scheduler.finished[0].tokens[:12])
    return report


if __name__ == "__main__":
    main()
