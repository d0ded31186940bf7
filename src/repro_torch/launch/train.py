"""Training launcher on the card: any arch the port trains.

  PYTHONPATH=src python -m repro_torch.launch.train --full-config \\
      --batch 4 --seq 512 --steps 4 [--attn-impl chunked|full|pallas] \\
      [--remat none|full] [--micro-batches N] [--grad-compression]

The port of ``repro.launch.train``, with its flags and defaults, plus
``--device cuda|cpu`` (the card unless asked otherwise; ``cpu`` runs the
kernel wrappers' plain versions), ``--seed`` (the weights, made on the
device from a torch generator, and the data stream), ``--attn-impl`` (the
reference's launcher fixes ``chunked``; ``pallas`` is the reference's
``ForwardOpts.attn_impl`` that its tests differentiate through: the
forward through ``flash_attention``, the backward through
``flash_attention_bwd``, both contexts tuned on the card before the first
step) and ``--ckpt-every`` (the reference's every ``steps // 4``; 0 writes
no checkpoint, for a full-width state of 46 GB).

Each step runs ``launch.steps.make_train_step`` (gradient accumulation,
optional int8 error feedback, AdamW with warmup 10 and a cosine schedule
over ``--steps``) through ``runtime.Trainer`` (checkpoints, resume from
the latest one, the straggler watchdog) on ``data.TokenStream``. The run
report gives each step's loss and wall time, tokens per second over the
steps after the first, the peak device memory and the launches of
``flash_attention`` and ``flash_attention_bwd``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.tuner import Autotuner, default_tuner
from repro_torch.data import DataConfig, TokenStream
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import flash_attention_bwd as fab_kernel
from repro_torch.kernels import ops
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import init_params
from repro_torch.optim import adamw
from repro_torch.runtime import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="phi4-mini-3.8b")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (paper-scale) config instead of smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default steps // 4, "
                         "at least 1); 0 writes none")
    ap.add_argument("--data", choices=["synthetic", "file"],
                    default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--attn-impl", choices=["chunked", "full", "pallas"],
                    default="chunked")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu trains on the CPU (the kernel wrappers run "
                         "their plain versions)")
    return ap


def attention_contexts(cfg: ModelConfig, batch: int, seq: int, device):
    """(kernel, context) of the ``--attn-impl pallas`` step: the causal
    forward and backward over one micro-batch's (batch, seq) tokens in the
    model's dtype."""
    ctx = ops.attention_context(ops.device_chip(device.index or 0), batch,
                                cfg.n_heads, cfg.n_kv_heads, seq, seq,
                                cfg.head_dim, cfg.dtype, causal=True)
    return [(ops.FLASH_ATTENTION, ctx), (ops.FLASH_ATTENTION_BWD, ctx)]


def _launch_counts() -> dict:
    return {"flash_attention": fa_kernel.flash_attention.launches,
            "flash_attention_bwd": fab_kernel.flash_attention_bwd.launches}


def train(args, model: Optional[lm.LM] = None,
          tuner: Optional[Autotuner] = None,
          cfg: Optional[ModelConfig] = None) -> dict:
    """The run ``args`` describe; ``cfg`` replaces the arch's config (a
    cut depth, another dtype) and ``model`` (trainable, on the device,
    updated in place) the seeded random weights where given. Returns the
    report."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the CPU")
    cfg = cfg or get_config(args.arch, smoke=not args.full_config)
    if args.batch % args.micro_batches:
        raise ValueError(f"--batch {args.batch} is not a multiple of "
                         f"--micro-batches {args.micro_batches}")
    scfg = steps_lib.StepConfig(
        micro_batches=args.micro_batches,
        grad_compression=args.grad_compression,
        opts=lm.ForwardOpts(attn_impl=args.attn_impl, attn_chunk=128,
                            remat=args.remat),
        adamw=adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps))
    lm._check_train(cfg, scfg.opts)
    if model is None:
        model = init_params(cfg, torch.Generator(device=device).manual_seed(
            args.seed), device, trainable=True)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={device}")
    if device.type == "cuda" and args.attn_impl == "pallas":
        tuner = tuner or default_tuner()
        for tunable, ctx in attention_contexts(
                cfg, args.batch // args.micro_batches, args.seq, device):
            tuned = tuner.best_config(tunable, ctx)
            print(f"{tunable.name} at the training context "
                  f"{dict(ctx.shapes)}: {tuned}")
        ops.release_tuning_operands()
    opt_state = steps_lib.init_opt_state(cfg, scfg, params)
    step_fn = steps_lib.make_train_step(cfg, scfg, model)
    losses = []

    def step(params, opt_state, batch):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(metrics["loss"])
        return params, opt_state, metrics

    stream = TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed, source=args.data,
        path=args.data_path))
    every = max(args.steps // 4, 1) if args.ckpt_every is None \
        else args.ckpt_every
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=every, log_every=10),
        step, params, opt_state, iter(stream),
        data_state_fn=stream.state, data_restore_fn=stream.restore)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = _launch_counts()
    out = trainer.run()
    launches = {k: n - before[k] for k, n in _launch_counts().items()}
    times = trainer.step_times
    tokens = args.batch * args.seq
    print(f"finished at step {out['step']}; "
          f"{len(out['stragglers'])} straggler steps flagged")
    return {
        "arch": cfg.name, "device": str(device), "params": n_params,
        "attn_impl": args.attn_impl, "remat": args.remat,
        "batch": args.batch, "seq": args.seq,
        "micro_batches": args.micro_batches, "steps": out["step"],
        "losses": [float(x) for x in losses],
        "step_ms": [t * 1e3 for t in times],
        "tokens_per_s": (tokens * (len(times) - 1) / sum(times[1:])
                         if len(times) > 1 else
                         tokens / times[0] if times else 0.0),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "launches": launches, "stragglers": len(out["stragglers"]),
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    report = train(args)
    print("run report: " + json.dumps(report, sort_keys=True))
    return report


if __name__ == "__main__":
    main()
