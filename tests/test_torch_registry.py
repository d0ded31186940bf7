"""The port's kernel registry held against the reference's: the eleven
ported kernels (every kernel the reference registers) under the same
names, scenarios, precision and bench cases, and the registry's own
rules."""

import pytest
import torch

from repro.kernels import registry as jreg

from repro_torch.core import TunableKernel, cpu_host
from repro_torch.kernels import registry

PORTED = ("decode_attention", "flash_attention", "flash_attention_bwd",
          "gqa_decode_kv8", "gqa_decode_ragged", "matmul", "matmul_w8a8",
          "mla_decode", "paged_decode", "paged_verify", "rms_norm")
INT8 = ("gqa_decode_kv8", "matmul_w8a8")


def _cases(spec):
    return [(c.label, {k: tuple(v) for k, v in c.shapes.items()}, c.dtype,
             dict(c.extra), c.scale) for c in spec.bench_cases]


@pytest.mark.parametrize("name", PORTED)
def test_ported_kernels_match_the_reference_registry(name):
    ours, theirs = registry.get_kernel(name), jreg.get_kernel(name)
    assert ours.name == theirs.name == name
    assert ours.scenarios == theirs.scenarios
    assert ours.precision == theirs.precision
    assert ours.precision == ("int8" if name in INT8 else "float")
    assert ours.description == theirs.description
    assert _cases(ours) == _cases(theirs)
    assert ours.reference is not None and ours.entry_point is not None
    assert ours.operands is not None


def test_list_kernels_is_a_subset_of_the_reference():
    assert registry.kernel_names() == sorted(PORTED)
    ours = registry.kernel_names(scenario="decode")
    assert set(ours) <= set(jreg.kernel_names(scenario="decode"))
    assert set(ours) == {"decode_attention", "gqa_decode_kv8",
                         "gqa_decode_ragged", "mla_decode", "paged_decode",
                         "paged_verify", "rms_norm"}
    assert registry.kernel_names(scenario="mla") == \
        jreg.kernel_names(scenario="mla") == ["mla_decode"]
    assert registry.kernel_names(scenario="speculative") == ["paged_verify"]
    assert registry.kernel_names(precision="int8") == list(INT8)
    assert registry.kernel_names(scenario="quant", precision="int8") == \
        jreg.kernel_names(scenario="quant", precision="int8") == list(INT8)
    assert registry.kernel_names(scenario="prefill") == \
        ["flash_attention", "matmul", "matmul_w8a8", "rms_norm"]
    assert registry.kernel_names(scenario="training") == \
        ["flash_attention", "flash_attention_bwd", "matmul", "matmul_w8a8",
         "rms_norm"]
    assert set(registry.kernel_names(scenario="training")) == \
        set(jreg.kernel_names(scenario="training"))
    assert set(registry.scenarios()) <= set(jreg.scenarios())


def test_register_refuses_duplicates_and_unregisters():
    spec = registry.get_kernel("rms_norm")
    with pytest.raises(ValueError, match="already registered"):
        registry.register(spec)
    throwaway = registry.KernelSpec(
        tunable=TunableKernel(name="throwaway", space=spec.space),
        scenarios=("test",))
    registry.register(throwaway)
    try:
        assert registry.get_kernel("throwaway") is throwaway
        assert "test" in registry.scenarios()
    finally:
        registry.unregister("throwaway")
    with pytest.raises(KeyError, match="throwaway"):
        registry.get_kernel("throwaway")
    with pytest.raises(ValueError, match="no scenarios"):
        registry.register(registry.KernelSpec(tunable=throwaway.tunable,
                                              scenarios=()))
    with pytest.raises(TypeError):
        registry.register(throwaway.tunable)


@pytest.mark.parametrize("name", PORTED)
def test_operands_feed_entry_point_and_reference(name):
    """Each host bench case's operands (built on the CPU here, where the
    entry point runs the plain version) go through the entry point under
    the heuristic config and through the reference with the same result;
    on the card ``chip_smoke.py`` runs this sweep over every valid config."""
    spec = registry.get_kernel(name)
    for case in spec.cases("host"):
        ctx = case.context(cpu_host())
        cfg = spec.tunable.default_config(ctx)
        args, kw = spec.operands(ctx, cfg, "cpu")
        want = spec.reference(*args, **kw)
        got = spec.entry_point(*args, **kw, config=cfg)
        assert got.shape == want.shape and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        if name == "matmul_w8a8":
            # int8 x (M, K) and w (K, N) stored K-major, as QTensor holds
            # a weight, with the config's granularity of f32 scales
            x, w, xs, ws = args
            M, K = case.shapes["x"]
            N = case.shapes["y"][1]
            assert x.dtype == w.dtype == torch.int8 and not kw
            assert w.shape == (K, N) and w.stride() == (1, K)
            assert xs.dtype == ws.dtype == torch.float32
            n = 1 if cfg["scale_gran"] == "per_tensor" else None
            assert xs.numel() == (n or M) and ws.numel() == (n or N)
            assert got.dtype == torch.float32 and got.shape == (M, N)
        elif name == "flash_attention":
            # (B, H, S, D) views of (B, S, H, D) activations, the layout
            # the prefill hands the kernel, with the case's mask
            q, k, v = args
            assert kw == {"causal": case.extra["causal"],
                          "window": case.extra["window"] or None}
            assert q.shape == case.shapes["q"] and k.shape == v.shape == \
                case.shapes["k"]
            assert q.transpose(1, 2).is_contiguous()
            assert k.transpose(1, 2).is_contiguous()
            assert got.shape == q.shape
            with_lse = spec.entry_point(*args, **kw, config=cfg,
                                        return_lse=True)
            assert with_lse[1].shape == q.shape[:3]
        elif name == "mla_decode":
            # q_abs, q_rope, ckv, krope in the case's dtype, every request
            # attending all T (the reference's runner passes no lengths),
            # at the context's scale; the latent context comes out f32
            qa, qr, ckv, kr = args
            assert kw == {"scale": 1.0}
            for t, key in ((qa, "q_abs"), (qr, "q_rope"), (ckv, "ckv"),
                           (kr, "krope")):
                assert t.shape == case.shapes[key] and t.is_contiguous()
            assert got.dtype == torch.float32 and got.shape == qa.shape
        elif spec.precision == "int8":
            # the int8 operands are the serving layout: (B, Hkv, T, D) and
            # (B, Hkv, T) views of caches quantized through the wire format
            q, k, v, ks, vs = args
            assert k.dtype == v.dtype == torch.int8
            assert ks.dtype == torch.float32 and ks.shape == k.shape[:3]
            assert k.transpose(1, 2).is_contiguous()
            assert ks.transpose(1, 2).is_contiguous()
            assert q.dtype == torch.float32
        elif case.dtype == "int8":
            # the int8 cases of paged_decode and paged_verify: int8 pools
            # with (Hkv, P, page_size) f32 scale pools quantized through
            # the wire format, f32 q ((B, K, Hq, D) for a verify of depth
            # K, with every length at least K)
            q, kp, vp, _, lens = args
            assert kp.dtype == vp.dtype == torch.int8
            assert q.dtype == torch.float32
            for key in ("k_scales", "v_scales"):
                assert kw[key].dtype == torch.float32
                assert kw[key].shape == kp.shape[:3]
            if name == "paged_verify":
                K = case.extra["draft_k"]
                assert q.shape[1] == K and (lens >= K).all()
