#!/usr/bin/env python3
"""The design sweeps behind ``csrc/paged_verify.cu``'s choices, on the card.

    PYTHONPATH=src python scripts/paged_verify_sweep.py \\
        [--v1-source PATH] [--out PATH]

Builds the kernel's source as it is and three variants of it (the query
rows a row group holds, ``kMaxSet``, at 2 and 8 instead of 4; and every
lane computing every exponent of its set instead of one a lane shared by
shuffles), with ``nvcc`` into ``build/``, and times them under the
tuner's timer (``CudaEventTimer``: an L2 flush, median of 50):

  * at the serving layout (B 8, phi4-mini's 24/8 heads of 128, pages of
    128, 7 a table, K 2, bf16 and int8 pools), on the tuner's seed-11
    lengths and on chip_smoke's (``verify_lens``: 0, 1, 1, 2, full, past
    the capacity, and two ragged ones): every valid config of the
    engine's context, the best printed with the heuristic's;
  * at the deployment shape (16 sequences of 32,768 slots, K 2, bf16 and
    int8 pools) of phi4-mini and stablelm-12b: each variant's best over
    pages of 128, block_kv 64 and 128, packed or not, 2, 4 or 8 splits.

``--v1-source`` takes the earlier design's source (``git show
4a1f787:src/repro_torch/csrc/paged_verify.cu``) and times it under the
same timer: at the serving layout its best of its configs there, at the
deployment shape its shipped configs. Every kernel is held against the
plain version before it is timed. Prints one JSON line per measurement
(and writes them to ``--out``); needs one CUDA card and imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import CudaEventTimer  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_verify as pv  # noqa: E402
from repro_torch.kernels.build import BUILD_DIR, CSRC_DIR, nvcc  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.quant import quantize_kv  # noqa: E402

# The block of the score loop from the scores to the state's update, and
# what replaces it in the variant where every lane computes every exponent
LANE_EXPS_FROM = "        // The scores (int8: the key's scale"
LANE_EXPS_TO = "      __syncthreads();                          // stage st"
LANE_EXPS = """#pragma unroll
        for (int g = 0; g < G; ++g) {
          bool ok[R];
          float m_new = m[g];
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            if (kQuant) sc[g][rr] *= k_sc[rr];
            sc[g][rr] *= p.scale;
            ok[rr] = valid[rr] && (!tail || t0 + r[rr] <= lim[g]);
            if (ok[rr]) m_new = fmaxf(m_new, sc[g][rr]);
          }
          const float alpha = m_new == -INFINITY ? 0.f : expf(m[g] - m_new);
          float pv[R], psum = 0.f;
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const float pr = ok[rr] ? expf(sc[g][rr] - m_new) : 0.f;
            psum += pr;
            pv[rr] = kQuant ? pr * v_sc[rr] : pr;
          }
          l[g] = l[g] * alpha + psum;
#pragma unroll
          for (int e = 0; e < kLaneElems; ++e) {
            float a = acc[g][e] * alpha;
#pragma unroll
            for (int rr = 0; rr < R; ++rr) a = fmaf(pv[rr], vf[rr][e], a);
            acc[g][e] = a;
          }
          m[g] = m_new;
        }
      }
"""
MAX_SET = "constexpr int kMaxSet = 4;"
R_RULE = "constexpr int R = G <= 2 ? 4 : 2;"
DISPATCH = ("    case 4: return launch<Q, KV, 4>(a, blocks, threads, smem, "
            "s);\n")
_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def variants() -> dict:
    """name -> the source text of each variant of csrc/paged_verify.cu."""
    src = (CSRC_DIR / "paged_verify.cu").read_text()
    i, j = src.index(LANE_EXPS_FROM), src.index(LANE_EXPS_TO)
    out = {"set4": src, "lane_exps": src[:i] + LANE_EXPS + src[j:]}
    for n in (2, 8):
        v = src.replace(MAX_SET, f"constexpr int kMaxSet = {n};")
        v = v.replace("static_assert(kMaxSet == 4", "static_assert(true")
        # sets of 5 to 8 rows: one K/V row in flight and one block an SM,
        # as paged_decode's groups of 5 to 8 heads
        v = v.replace(R_RULE, "constexpr int R = G <= 2 ? 4 : "
                              "(G <= 4 ? 2 : 1);")
        v = v.replace("kMinBlocks<KV>)", "(G <= 4 ? kMinBlocks<KV> : 1))")
        more = "".join(f"    case {g}: return launch<Q, KV, {g}>(a, blocks, "
                       f"threads, smem, s);\n" for g in range(5, n + 1))
        out[f"set{n}"] = v.replace(DISPATCH, DISPATCH + more)
    return out


def build(name: str, text: str) -> subprocess.Popen:
    path = BUILD_DIR / f"pv_sweep_{name}.cu"
    path.write_text(text)
    return subprocess.Popen(
        [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
         str(path.with_suffix(".so")), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_all(v1_source) -> tuple:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    texts = variants()
    if v1_source:
        with open(v1_source) as f:
            texts["v1"] = f.read()
    procs = {name: build(name, text) for name, text in texts.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(BUILD_DIR / f"pv_sweep_{name}.so"))
        if name != "v1":
            pv._declare(libs[name])
    v1 = libs.pop("v1", None)
    if v1 is not None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        v1.paged_verify_launch.argtypes = (
            [vp] * 8 + [i32] * 8 + [ctypes.c_float] + [i32] * 5 + [vp])
        v1.paged_verify_launch.restype = i32
    return libs, v1


def v1_call(v1, args, scales, block_kv, pack, num_warps):
    """The earlier design's launch (its own C interface)."""
    q, kp, vp, tables, lens = args
    out = torch.empty_like(q)
    B, K, Hq, D = q.shape
    ks, vs = scales.get("k_scales"), scales.get("v_scales")
    err = v1.paged_verify_launch(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None, tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(), B, K, Hq, kp.shape[0], D,
        kp.shape[1], kp.shape[2], tables.shape[1], float(D ** -0.5),
        block_kv, int(pack), num_warps, _CODE[q.dtype], _CODE[kp.dtype],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"v1 launch: cudaError {err}")
    return out


def chip_smoke_operands(ctx, K: int, seed: int):
    """chip_smoke's serving-layout operands: its verify_lens, shuffled
    pages, int8 pools quantized from f32 by the kv8 wire format."""
    import numpy as np
    B, Hq, D = ctx.shape("q")
    Hkv, cap = ctx.shape("k")[1], ctx.shape("k")[2]
    ps = ctx.extra["page_size"]
    max_pages = cap // ps
    lens = [0, 1, K - 1, K, cap, cap + 1, cap // 3 + 5, (2 * cap) // 3 - 1]
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_pages
    tables = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = tables.reshape(B, max_pages).copy()
    for b, n in enumerate(lens):
        tables[b, -(-min(max(n, 0), cap) // ps):] = 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    int8 = ctx.dtype == "int8"
    dtype = torch.float32 if int8 else torch.bfloat16
    rand = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
    q = rand(B, K, Hq, D).bfloat16()
    kp, vp = rand(Hkv, n_pages, ps, D), rand(Hkv, n_pages, ps, D)
    scales = {}
    if int8:
        kp, ks, vp, vs = quantize_kv(kp, vp)
        scales = {"k_scales": ks, "v_scales": vs}
    return (q, kp, vp, torch.from_numpy(tables).cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda")), scales


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--v1-source", default=None)
    ap.add_argument("--out", default=None)
    args_ = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_verify_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    lines = []

    def emit(**rec):
        rec["card"] = card
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    libs, v1 = load_all(args_.v1_source)
    timer = CudaEventTimer(reps=50, warmup=5)
    chip = ops.device_chip(0)

    def run(lib, args, scales, **cfg):
        pv.LIB._lib = libs[lib]
        return pv.paged_verify(*args, **scales, **cfg)

    def held(got, want, what):
        err = float((got.float() - want).abs().max())
        if err > 2e-2 * max(1.0, float(want.abs().max())):
            raise AssertionError(f"{what}: max abs err {err}")

    # The serving layout: every valid config of the engine's context
    for quant in (None, "kv8"):
        ctx = ops.paged_verify_context(
            chip, 8, 24, 8, 128, 896, "int8" if quant else "bfloat16", 128,
            2, "bfloat16" if quant else None)
        heur = ops.PAGED_VERIFY.default_config(ctx)
        inputs = {"tuner": ops._pool_operands(ctx, 128,
                                              ops._verify_lens(ctx, 2),
                                              "cuda", 2),
                  "chip_smoke": chip_smoke_operands(ctx, 2, 7)}
        for label, (args, scales) in inputs.items():
            want = ref.paged_verify(*args, **scales).float()
            times = {}
            for cfg in ops.PAGED_VERIFY.space.valid_configs(ctx):
                kw = {k: v for k, v in cfg.items()
                      if k not in ("page_size", "draft_k")}
                held(run("set4", args, scales, **kw), want, f"{cfg}")
                times[json.dumps(kw, sort_keys=True)] = timer.time_runner(
                    lambda: run("set4", args, scales, **kw)) * 1e3
            best = min(times, key=times.get)
            hk = json.dumps({k: v for k, v in heur.items()
                             if k not in ("page_size", "draft_k")},
                            sort_keys=True)
            rec = {"shape": "serving", "pools": quant or "bf16",
                   "lengths": label, "lens": args[4].tolist(),
                   "best": json.loads(best), "best_ms": times[best],
                   "heuristic_ms": times[hk], "configs": len(times)}
            for name in ("set2", "set8", "lane_exps"):
                rec[f"{name}_ms_at_best"] = timer.time_runner(
                    lambda: run(name, args, scales, **json.loads(best)))
                rec[f"{name}_ms_at_best"] *= 1e3
            if v1 is not None:
                v1_times = {}
                for pack in (True, False):
                    for warps in (4, 8, 16):
                        for bkv in (64, 128, 256):
                            try:
                                held(v1_call(v1, args, scales, bkv, pack,
                                             warps), want, "v1")
                            except RuntimeError:   # over its shared memory
                                continue
                            v1_times[f"b{bkv} p{int(pack)} w{warps}"] = \
                                timer.time_runner(lambda: v1_call(
                                    v1, args, scales, bkv, pack,
                                    warps)) * 1e3
                vb = min(v1_times, key=v1_times.get)
                rec.update(v1_best=vb, v1_best_ms=v1_times[vb])
            emit(**rec)
        ops.release_tuning_operands()

    # The deployment shape
    grid = [{"block_kv": b, "pack_gqa": p, "kv_splits": s}
            for b in (64, 128) for p in (True, False) for s in (2, 4, 8)]
    v1_shipped = {("phi4-mini-3.8b", None): (128, True),
                  ("phi4-mini-3.8b", "kv8"): (256, False),
                  ("stablelm-12b", None): (128, True),
                  ("stablelm-12b", "kv8"): (256, False)}
    for arch in ("phi4-mini-3.8b", "stablelm-12b"):
        for quant in (None, "kv8"):
            ctx = serve.verify_deployment_context(get_config(arch), chip,
                                                  quant)
            rec = {"shape": "deployment", "arch": arch,
                   "pools": quant or "bf16"}
            runner = None
            for name in libs:
                times = {}
                for cfg in grid:
                    runner = ops._paged_verify_runner(
                        dict(cfg, draft_k=2, page_size=128), ctx)
                    times[json.dumps(cfg, sort_keys=True)] = \
                        timer.time_runner(
                            lambda: run(name, runner.args,
                                        {k: runner.kwargs[k] for k in
                                         ("k_scales", "v_scales")
                                         if k in runner.kwargs}, **cfg)
                        ) * 1e3
                best = min(times, key=times.get)
                rec[f"{name}_best"] = json.loads(best)
                rec[f"{name}_ms"] = times[best]
            args = runner.args
            scales = {k: runner.kwargs[k] for k in ("k_scales", "v_scales")
                      if k in runner.kwargs}
            want = ref.paged_verify(*args, **scales).float()
            for name in libs:
                held(run(name, args, scales, **rec[f"{name}_best"]), want,
                     f"{arch} {quant} {name}")
            if v1 is not None:
                bkv, pack = v1_shipped[(arch, quant)]
                held(v1_call(v1, args, scales, bkv, pack, 16), want, "v1")
                rec["v1_shipped_ms"] = timer.time_runner(
                    lambda: v1_call(v1, args, scales, bkv, pack, 16)) * 1e3
            emit(**rec)
            del runner, args, scales, want
            ops.release_tuning_operands()
            torch.cuda.empty_cache()
    if args_.out:
        with open(args_.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
