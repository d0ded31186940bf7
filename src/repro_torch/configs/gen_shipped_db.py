"""Generate the shipped H100 tuning DB (the paper's Q4.3: tuned configs are
reused outside the run that tuned them): the port of
``repro.configs.gen_shipped_db``.

    PYTHONPATH=src python -m repro_torch.configs.gen_shipped_db \\
        [--kernels paged_decode,paged_verify] [--out PATH]

Tunes every registered kernel on the CUDA card it runs on, at each arch's
deployment scenarios, and writes ``configs/shipped_tuning_db.json``
(sorted, indented), which ``default_tuner()`` reads as a read-only
overlay: a fresh serve or train launcher finds its deployment configs
there and tunes none of them. The entries are measured, not modelled: the
tuner's ``CudaEventTimer`` times every valid config on the card (the
reference's cost-model backend is not ported).

The whole tune takes tens of minutes, most of it the paged deployments
(paged_decode 300-600 configs each). So the file is written after each entry,
and the entries already in it are kept and not tuned again: a run that is
cut keeps what it finished, and ``--kernels`` splits the tune over several
runs. A scenario whose tune fails is left out and the run exits 1.

A key holds the kernel's version, not its code. So a kernel whose source
changes bumps its version (``version=`` of its ``TunableKernel`` in
``kernels.ops``), and its entries are tuned again: the version and a
digest of each kernel's sources are kept in
``tests/test_torch_shipped_db.py::KERNEL_SOURCES``, whose test fails when
a source changes and the row does not, and an entry of an older version
fails ``test_every_entry_parses_against_the_current_spaces``. Delete the
kernel's stale entries and run ``--kernels NAME``.

``scenarios(chip)`` gives every (kernel, context) at TP 1, each context
built by the function the runtime lookup itself calls, so a shipped key
cannot drift from what is looked up:

  * the archs whose attention is GQA (phi4-mini-3.8b, phi3-mini-3.8b,
    stablelm-12b, olmoe-1b-7b): ``flash_attention`` at (B, S) (8, 4096)
    and (1, 32768), causal; ``decode_attention``, ``gqa_decode_ragged``
    and ``gqa_decode_kv8`` (q in ``SHIP_DTYPE``) at the deployment shapes
    (``paged_deployment_shapes``);
  * the archs paged serving takes: ``paged_decode`` and ``paged_verify``
    at the launcher's deployment contexts (``launch.serve``'s
    ``deployment_context`` and ``verify_deployment_context``), float and
    int8 pools;
  * the MLA arch: ``mla_decode`` at the deployment shapes;
  * every arch: ``rms_norm`` at (8192, d_model);
  * ``matmul`` at 8192^3, and ``matmul_w8a8`` at 8192^3 and
    512 x 4096 x 4096 (per-channel scales, the runtime's operands).

Left out, as no entry point of the port looks them up:

  * paged entries for olmoe-1b-7b and deepseek-v2-lite-16b: paged serving
    refuses MoE and MLA (``models.lm._check_paged``);
  * the GQA-shaped entries for deepseek-v2-lite-16b: ``flash_attention``
    (``--attn-impl pallas`` refuses MLA), and ``decode_attention``,
    ``gqa_decode_ragged`` and ``gqa_decode_kv8`` (an MLA arch decodes
    through ``mla_decode`` over a latent cache, and kv8 refuses MLA);
  * the reference's TP 2 and TP 4 entries: tensor parallelism is not
    ported;
  * ``flash_attention_bwd``, for which the reference ships no entry
    either.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Iterator, List, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import Autotuner, TuningCache, TuningContext
from repro_torch.core.cache import cache_key
from repro_torch.kernels import ops
from repro_torch.kernels.registry import get_kernel

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "shipped_tuning_db.json")

# Every shipped scenario is tuned at serving numerics.
SHIP_DTYPE = "bfloat16"

# The canonical deployment scenario (the reference's
# ``paged_deployment_shapes``): 16 sequences of 32,768 tokens.
DEPLOY_BATCH = 16
DEPLOY_TOKENS = 32768


def paged_deployment_shapes(cfg) -> dict:
    """The deployment scenario's shapes for an arch: q (16, Hq, D) over
    caches of (16, Hkv, 32768, D). The serve launcher looks up exactly
    this (``launch.serve.deployment_context``), page size free, so the
    winner sizes the pool."""
    return {"q": (DEPLOY_BATCH, cfg.n_heads, cfg.head_dim),
            "k": (DEPLOY_BATCH, cfg.n_kv_heads, DEPLOY_TOKENS, cfg.head_dim)}


def _pages(cfg) -> bool:
    """Whether paged serving takes the arch (``lm._check_paged``)."""
    from repro_torch.models.lm import _check_paged
    try:
        _check_paged(cfg)
    except NotImplementedError:
        return False
    return True


def scenarios(chip) -> Iterator[Tuple[str, TuningContext]]:
    """(kernel name, context) for every shipped entry on ``chip`` (the
    module docstring lists them and what is left out)."""
    from repro_torch.launch import serve   # serve imports this module

    for arch in ARCHS:
        cfg = get_config(arch)
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if cfg.mla is None:
            for b, s in ((8, 4096), (1, 32768)):
                yield "flash_attention", ops.attention_context(
                    chip, b, hq, hkv, s, s, dh, SHIP_DTYPE, causal=True,
                    window=cfg.window)
            dims = (DEPLOY_BATCH, hq, hkv, dh, DEPLOY_TOKENS)
            yield "decode_attention", ops.decode_attention_context(
                chip, *dims, SHIP_DTYPE)
            yield "gqa_decode_ragged", ops.gqa_decode_context(
                chip, *dims, SHIP_DTYPE)
            yield "gqa_decode_kv8", ops.gqa_decode_kv8_context(
                chip, *dims, q_dtype=SHIP_DTYPE)
        if _pages(cfg):
            for quant in (None, "kv8"):
                yield "paged_decode", serve.deployment_context(cfg, chip,
                                                               quant)
                yield "paged_verify", serve.verify_deployment_context(
                    cfg, chip, quant)
        if cfg.mla is not None:
            m = cfg.mla
            yield "mla_decode", ops.mla_decode_context(
                chip, DEPLOY_BATCH, hq, m.kv_lora_rank, m.qk_rope_dim,
                DEPLOY_TOKENS, SHIP_DTYPE)
        yield "rms_norm", ops.rmsnorm_context(chip, (8192, cfg.d_model),
                                              SHIP_DTYPE)
    yield "matmul", ops.matmul_context(chip, 8192, 8192, 8192, SHIP_DTYPE)
    yield "matmul_w8a8", ops.matmul_w8a8_context(chip, 8192, 8192, 8192)
    yield "matmul_w8a8", ops.matmul_w8a8_context(chip, 512, 4096, 4096)


def _write(path: str, db: dict) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(db, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernel names to tune (default: "
                         "every kernel with a scenario)")
    ap.add_argument("--out", default=OUT, help="the DB file to extend")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("gen_shipped_db measures on a CUDA card; none is "
                           "available")
    chip = ops.device_chip(0)
    wanted = [k for k in args.kernels.split(",") if k]
    for name in wanted:
        get_kernel(name)                # an unknown name raises here
    db = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            db = json.load(f)
    tuner = Autotuner(cache=TuningCache())
    t_run = time.perf_counter()
    tuned = failed = 0
    for name, ctx in scenarios(chip):
        if wanted and name not in wanted:
            continue
        kernel = get_kernel(name).tunable
        key = cache_key(kernel.name, kernel.version, kernel.space, ctx)
        label = f"{name} {ctx.shapes} {ctx.dtype} {dict(ctx.extra)}"
        if key in db:
            print(f"have {label}", flush=True)
            continue
        try:
            entry = tuner.tune(kernel, ctx)
        except Exception as e:   # noqa: BLE001 — counted, the run exits 1
            entry = e
        ops.release_tuning_operands()
        if isinstance(entry, Exception) or entry.failed():
            print(f"FAILED {label}: {entry!r}", flush=True)
            failed += 1
            continue
        db[key] = entry.to_json()
        _write(args.out, db)
        tuned += 1
        print(f"tuned {label}: {entry.n_evaluated} configs in "
              f"{entry.measure_s:.1f} s -> {entry.config} "
              f"({entry.metric * 1e3:.4f} ms)", flush=True)
    print(f"{tuned} entries tuned, {failed} failed, {len(db)} in "
          f"{args.out} ({time.perf_counter() - t_run:.1f} s)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
