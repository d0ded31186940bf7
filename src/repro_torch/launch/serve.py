"""Paged continuous-batching serving launcher on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --full-config \\
      --requests 8 --prompt-len 512 --gen 32 --max-batch 8 [--speculative [K]]

The port of ``repro.launch.serve``'s ``--decode-impl paged`` path. The pool's
page size comes from the tuner's deployment-level ``paged_decode`` config:
the canonical scenario (``q (16, Hq, D)``, ``k (16, Hkv, 32768, D)``,
bfloat16, page size free) of the full config's head geometry, tuned on the
card on a miss. The run then tunes the exact contexts the engine will
dispatch (``ServingEngine`` kernels at its pool layout), serves the
requests with the ``paged_decode`` CUDA kernel and the ``rms_norm`` Triton
kernel on every layer, and prints one structured run report.

``--speculative [K]`` (``--speculative`` of the reference's paged path)
serves by draft and verify through the ``paged_verify`` CUDA kernel
instead, with K draft positions a step. The bare flag takes K from the
tuned ``paged_verify`` deployment entry (the same canonical scenario with
``draft_k`` and ``page_size`` free); the pool keeps ``paged_decode``'s
page size either way.

It runs on the card only: with no CUDA device it raises instead of
carrying on on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.tuner import Autotuner, default_tuner
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import init_params
from repro_torch.serving import Request, ServingEngine

# The canonical deployment scenario of the reference's shipped DB
# (``paged_deployment_shapes``): its lookup context, tuned for this card.
DEPLOY_BATCH = 16
DEPLOY_TOKENS = 32768
DEPLOY_DTYPE = "bfloat16"


def deployment_context(full_cfg: ModelConfig, chip):
    return ops.paged_decode_context(
        chip, DEPLOY_BATCH, full_cfg.n_heads, full_cfg.n_kv_heads,
        full_cfg.head_dim, DEPLOY_TOKENS, DEPLOY_DTYPE)


def verify_deployment_context(full_cfg: ModelConfig, chip):
    return ops.paged_verify_context(
        chip, DEPLOY_BATCH, full_cfg.n_heads, full_cfg.n_kv_heads,
        full_cfg.head_dim, DEPLOY_TOKENS, DEPLOY_DTYPE)


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
    """Every (kernel, context) the engine's steps dispatch: paged_decode at
    the pool layout, rms_norm on prefill chunks and on decode rows, and
    under speculation paged_verify at the pool layout and the engine's
    depth, with rms_norm on its K rows a slot."""
    cfg, sched, pool = engine.cfg, engine.scheduler, engine.pool
    chip = ops.device_chip(engine.device.index or 0)
    dt = cfg.dtype
    cap = sched.max_pages * pool.page_size
    out = [(ops.PAGED_DECODE, ops.paged_decode_context(
        chip, sched.max_batch, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cap, dt, pool.page_size))]
    norm_shapes = [(1, sched.prefill_chunk, cfg.d_model),
                   (sched.max_batch, 1, cfg.d_model)]
    if engine.spec_k > 1:
        out.append((ops.PAGED_VERIFY, ops.paged_verify_context(
            chip, sched.max_batch, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cap, dt, pool.page_size, engine.spec_k)))
        norm_shapes.append((sched.max_batch, engine.spec_k, cfg.d_model))
    if engine.opts.norm_impl == "kernel":
        out += [(ops.RMS_NORM, ops.rmsnorm_context(chip, shape, dt))
                for shape in norm_shapes]
    return out


def prepare(args, tuner: Autotuner) -> Tuple[ServingEngine, List[Request],
                                             dict]:
    """Build the engine and its requests, tuning every kernel context the
    run will dispatch. Returns (engine, requests, deployment info)."""
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.serve runs on a CUDA card; "
                           "no CUDA device is available")
    cfg = get_config(args.arch, smoke=not args.full_config)
    full_cfg = get_config(args.arch)
    device = torch.device("cuda")
    max_seq_len = args.prompt_len + args.gen
    chip = ops.device_chip(device.index or 0)
    deploy_cfg = tuner.best_config(ops.PAGED_DECODE,
                                   deployment_context(full_cfg, chip))
    info = {"arch": cfg.name, "deployment_config": deploy_cfg}
    spec_k = 0
    if args.speculative is not None:
        verify_cfg = tuner.best_config(
            ops.PAGED_VERIFY, verify_deployment_context(full_cfg, chip))
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
        opts=lm.ForwardOpts(decode_impl="kernel", norm_impl="kernel"),
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="phi4-mini-3.8b")
    ap.add_argument("--full-config", action="store_true",
                    help="serve the published widths (default: smoke)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48,
                    help="longest prompt")
    ap.add_argument("--min-prompt-len", type=int, default=0,
                    help="shortest prompt (default: half the longest)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--speculative", type=int, nargs="?", const=0,
                    default=None, metavar="K",
                    help="draft-and-verify decoding with K positions a "
                         "step through the paged_verify kernel (output "
                         "equals plain decode); the bare flag takes K from "
                         "the tuned paged_verify deployment entry")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--on-miss", choices=("tune", "heuristic", "error"),
                    default="tune")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    tuner = default_tuner()
    tuner.on_miss = args.on_miss
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
