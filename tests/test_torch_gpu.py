"""The port's kernels on the card, held against their plain versions.

Every test here needs a CUDA card and skips with a reason where there is
none; the decision is made inside a fixture, never at import. The file
imports no JAX, so it runs on the card's machine as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import Autotuner, default_tuner, set_default_tuner
from repro_torch.kernels import decode_attention as da_kernel
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import flash_attention_bwd as fab_kernel
from repro_torch.kernels import gqa_decode as gqa_kernel
from repro_torch.kernels import gqa_decode_kv8 as kv8_kernel
from repro_torch.kernels import matmul as mm_kernel
from repro_torch.kernels import matmul_w8a8 as mm8_kernel
from repro_torch.kernels import mla_decode as mla_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_decode as pd_kernel
from repro_torch.kernels import paged_verify as pv_kernel
from repro_torch.kernels import rms_norm as rms_kernel
from repro_torch.models import lm
from repro_torch.models.param import init_params
from repro_torch.quant import (
    absmax_scale, quantize, quantize_kv, quantize_params,
)
from repro_torch.quant.qtensor import k_major
from repro_torch.serving import Request, ServingEngine

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the w8a8 GEMM against its plain version (dequantize, then an f32 product):
# the reference's int8 tolerance, atol and rtol
W8A8_TOL = 2e-3
# int8 caches: the kernel scales the finished dot product and the
# probability where the plain version dequantizes first, so an f32 q takes
# the reference's int8 tolerance (tests/test_kernel_oracles.py); bf16 q
# keeps bf16's
KV8_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-3}


@pytest.fixture()
def cuda():
    """The card, or a skip: decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; runs on the card's machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def paged_operands(seed, B, Hq, Hkv, D, page_size, max_pages, kv_len, dtype,
                   device):
    """Pool with page 0 as scratch, each sequence on shuffled pages."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_pages
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = perm.reshape(B, max_pages).copy()
    for b, n in enumerate(kv_len):
        tables[b, -(-min(max(n, 0), max_pages * page_size) // page_size):] = 0
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)  # noqa: E731
    return (rand(B, Hq, D), rand(Hkv, n_pages, page_size, D),
            rand(Hkv, n_pages, page_size, D),
            torch.from_numpy(tables).to(device),
            torch.tensor(kv_len, dtype=torch.int32, device=device))


# (B, Hq, Hkv, D, page_size, max_pages, dtype): phi4-mini's heads, phi3-mini
# (group 1, D 96), stablelm-12b (group 4, D 160), an f32 pool
SHAPES = [(8, 24, 8, 128, 16, 36, torch.bfloat16),
          (4, 32, 32, 96, 16, 8, torch.bfloat16),
          (3, 32, 8, 160, 8, 6, torch.bfloat16),
          (5, 8, 2, 64, 32, 4, torch.float32)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[3]}-{s[6]}")
def test_paged_decode_every_valid_config_matches_plain(cuda, shape):
    B, Hq, Hkv, D, ps, max_pages, dtype = shape
    cap = ps * max_pages
    kv_len = ([0, cap + 1, 1, cap] + [int(x) for x in
                                      np.linspace(2, cap - 1, B)])[:B]
    args = paged_operands(D, B, Hq, Hkv, D, ps, max_pages, kv_len, dtype,
                          cuda)
    want = ref.paged_decode(*args).float()
    chip = ops.device_chip(cuda.index or 0)
    ctx = ops.paged_decode_context(chip, B, Hq, Hkv, D, cap,
                                   ops.dtype_name(dtype), ps)
    configs = ops.PAGED_DECODE.space.valid_configs(ctx)
    assert configs
    for cfg in configs:
        before = pd_kernel.paged_decode.launches
        out = ops.paged_decode(*args, config=cfg)
        torch.cuda.synchronize()
        assert pd_kernel.paged_decode.launches == before + 1
        torch.testing.assert_close(out.float(), want, atol=TOL[dtype],
                                   rtol=TOL[dtype], msg=lambda m: f"{cfg}: {m}")
        assert not out[0].any(), "kv_len == 0 must give exact zeros"


def test_paged_decode_rejects_what_it_does_not_take(cuda):
    args = paged_operands(0, 2, 4, 2, 16, 8, 2, [3, 4], torch.float32, cuda)
    with pytest.raises(ValueError, match="block_kv"):
        pd_kernel.paged_decode(*args, block_kv=0)
    with pytest.raises(ValueError, match="dtype"):
        pd_kernel.paged_decode(args[0].bfloat16(), *args[1:])


def kv8_pools(args, device):
    """The float pools of ``paged_operands`` (rebuilt in f32) quantized by
    the kv8 wire format: (k_pages, v_pages, k_scales, v_scales)."""
    kq, ks, vq, vs = quantize_kv(args[1].float(), args[2].float())
    return kq, vq, ks, vs


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[3]}-{s[6]}")
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32],
                         ids=["q-bf16", "q-f32"])
def test_paged_decode_kv8_every_valid_config_matches_plain(cuda, shape,
                                                           q_dtype):
    """The int8 branch: every valid config of the int8 context, ragged
    lengths with kv_len == 0 and past the capacity, against the plain
    version (dequantize, gather, decode)."""
    B, Hq, Hkv, D, ps, max_pages, _ = shape
    cap = ps * max_pages
    kv_len = ([0, cap + 1, 1, cap] + [int(x) for x in
                                      np.linspace(2, cap - 1, B)])[:B]
    q, kp, vp, tables, lens = paged_operands(D + 1, B, Hq, Hkv, D, ps,
                                             max_pages, kv_len,
                                             torch.float32, cuda)
    kq, vq, ks, vs = kv8_pools((q, kp, vp), cuda)
    args = (q.to(q_dtype), kq, vq, tables, lens)
    scales = {"k_scales": ks, "v_scales": vs}
    want = ref.paged_decode(*args, **scales).float()
    chip = ops.device_chip(cuda.index or 0)
    ctx = ops.paged_decode_context(chip, B, Hq, Hkv, D, cap, "int8", ps,
                                   ops.dtype_name(q_dtype))
    configs = ops.PAGED_DECODE.space.valid_configs(ctx)
    assert configs
    for cfg in configs:
        before = pd_kernel.paged_decode.launches
        out = ops.paged_decode(*args, **scales, config=cfg)
        torch.cuda.synchronize()
        assert pd_kernel.paged_decode.launches == before + 1
        assert out.dtype == q_dtype
        torch.testing.assert_close(out.float(), want, atol=KV8_TOL[q_dtype],
                                   rtol=KV8_TOL[q_dtype],
                                   msg=lambda m: f"{cfg}: {m}")
        assert not out[0].any(), "kv_len == 0 must give exact zeros"


@pytest.mark.parametrize("ps", [4, 256])
def test_paged_decode_kv8_off_space_pages_dispatch_a_fixed_config(cuda, ps):
    """An int8 pool with an off-space page size launches the fixed config
    sized by the pool's own rows (pages of 256 stage whole), with no
    tuning, and matches the plain version for q in bf16 and f32."""
    tuner = Autotuner(on_miss="error")
    B, Hq, Hkv, D = 4, 24, 8, 128
    max_pages = max(1, 320 // ps)
    cap = ps * max_pages
    q, kp, vp, tables, lens = paged_operands(ps, B, Hq, Hkv, D, ps,
                                             max_pages, [0, cap, 3,
                                                         cap // 2 + 1],
                                             torch.float32, cuda)
    kq, vq, ks, vs = kv8_pools((q, kp, vp), cuda)
    cfg = ops.paged_decode_config(q.bfloat16(), kq, tables)
    assert cfg["block_kv"] == min(ps, 256)
    assert cfg["kv_splits"] == 1
    for q_dtype in (torch.bfloat16, torch.float32):
        args = (q.to(q_dtype), kq, vq, tables, lens)
        before = pd_kernel.paged_decode.path_launches["bulk"]
        out = ops.paged_decode(*args, k_scales=ks, v_scales=vs, tuner=tuner)
        assert pd_kernel.paged_decode.path_launches["bulk"] == before + 1
        torch.testing.assert_close(
            out.float(), ref.paged_decode(*args, k_scales=ks,
                                          v_scales=vs).float(),
            atol=KV8_TOL[q_dtype], rtol=KV8_TOL[q_dtype])
    assert tuner.stats()["misses"] == 0


def test_paged_decode_kv8_rejects_what_it_does_not_take(cuda):
    q, kp, vp, tables, lens = paged_operands(0, 2, 4, 2, 16, 8, 2, [3, 4],
                                             torch.float32, cuda)
    kq, vq, ks, vs = kv8_pools((q, kp, vp), cuda)
    with pytest.raises(ValueError, match="int8 pools"):
        pd_kernel.paged_decode(q, kq, vq, tables, lens)
    with pytest.raises(ValueError, match="int8 pools"):
        pd_kernel.paged_decode(q, kp, vp, tables, lens, k_scales=ks,
                               v_scales=vs)
    with pytest.raises(ValueError, match="float32"):
        pd_kernel.paged_decode(q, kq, vq, tables, lens,
                               k_scales=ks.bfloat16(), v_scales=vs)
    with pytest.raises(ValueError, match="float32"):
        pd_kernel.paged_decode(q, kq, vq, tables, lens,
                               k_scales=ks[:, :1], v_scales=vs[:, :1])
    with pytest.raises(ValueError, match="16-byte"):
        pd_kernel.paged_decode(q[..., :8].contiguous(),
                               kq[..., :8].contiguous(),
                               vq[..., :8].contiguous(), tables, lens,
                               k_scales=ks, v_scales=vs)
    lib = pd_kernel.LIB.load()
    for D, item, block_kv, g, pack, warps in (
            (128, 1, 128, 3, 1, 4), (128, 1, 16, 3, 1, 8),
            (96, 1, 64, 1, 0, 2), (160, 1, 32, 4, 1, 8),
            (128, 2, 64, 3, 1, 4), (64, 4, 32, 4, 0, 8)):
        assert lib.paged_decode_smem_bytes(D, item, block_kv, g, pack,
                                           warps) == \
            pd_kernel.smem_bytes(D, item, block_kv, g, bool(pack), warps)
    with pytest.raises(ValueError, match="kv_splits"):
        pd_kernel.paged_decode(q, kq, vq, tables, lens, k_scales=ks,
                               v_scales=vs, kv_splits=3)
    with pytest.raises(TypeError, match="num_stages"):
        pd_kernel.paged_decode(q, kq, vq, tables, lens, k_scales=ks,
                               v_scales=vs, num_stages=3)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_decode_kv_splits_8_is_repeatable(cuda, int8):
    """Eight blocks a row, merged by rank 0 in rank order: two calls give
    the same bits, and both match the plain version (lengths 0, past the
    capacity and fewer than eight chunks among them)."""
    B, Hq, Hkv, D, ps, max_pages = 8, 24, 8, 128, 16, 36
    cap = ps * max_pages
    kv_len = [0, cap + 1, 1, 5 * ps, cap, 17, cap // 2 + 3, cap - 1]
    q, kp, vp, tables, lens = paged_operands(8, B, Hq, Hkv, D, ps, max_pages,
                                             kv_len, torch.float32, cuda)
    scales = {}
    if int8:
        kp, vp, ks, vs = kv8_pools((q, kp, vp), cuda)
        scales = {"k_scales": ks, "v_scales": vs}
    args = (q.bfloat16(), kp if int8 else kp.bfloat16(),
            vp if int8 else vp.bfloat16(), tables, lens)
    cfg = dict(block_kv=16, pack_gqa=True, num_warps=4, kv_splits=8)
    one = pd_kernel.paged_decode(*args, **scales, **cfg)
    two = pd_kernel.paged_decode(*args, **scales, **cfg)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    torch.testing.assert_close(one.float(),
                               ref.paged_decode(*args, **scales).float(),
                               atol=2e-2, rtol=2e-2)
    assert not one[0].any()


@pytest.mark.parametrize("ps", [16, 128])
def test_paged_decode_takes_the_bulk_path_at_serving_pages(cuda, ps):
    """Float and int8 pools at pages of 16 and 128 copy their chunks by
    bulk copies; an int8 pool whose scale runs are not 16-byte multiples
    (a block of 2 rows) takes cp.async, and both are right."""
    B, Hq, Hkv, D, max_pages = 4, 24, 8, 128, max(2, 512 // ps)
    cap = ps * max_pages
    kv_len = [0, cap, 3, cap // 2 + 1]
    q, kp, vp, tables, lens = paged_operands(ps + 1, B, Hq, Hkv, D, ps,
                                             max_pages, kv_len,
                                             torch.float32, cuda)
    kq, vq, ks, vs = kv8_pools((q, kp, vp), cuda)
    q = q.bfloat16()
    runs = [("bulk", (q, kp.bfloat16(), vp.bfloat16(), tables, lens), {},
             ps),
            ("bulk", (q, kq, vq, tables, lens),
             {"k_scales": ks, "v_scales": vs}, ps),
            ("cp_async", (q, kq, vq, tables, lens),
             {"k_scales": ks, "v_scales": vs}, 2)]
    for route, args, scales, block_kv in runs:
        assert pd_kernel.path(args[1].element_size(), ps, block_kv) == route
        before = dict(pd_kernel.paged_decode.path_launches)
        out = pd_kernel.paged_decode(*args, **scales, block_kv=block_kv,
                                     kv_splits=2)
        assert pd_kernel.paged_decode.path_launches[route] == \
            before[route] + 1
        torch.testing.assert_close(
            out.float(), ref.paged_decode(*args, **scales).float(),
            atol=2e-2, rtol=2e-2, msg=lambda m: f"{route}: {m}")
        assert not out[0].any()


@pytest.mark.parametrize("draft_k", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[3]}-{s[6]}")
def test_paged_verify_every_valid_config_matches_plain(cuda, shape, draft_k):
    B, Hq, Hkv, D, ps, max_pages, dtype = shape
    cap = ps * max_pages
    # inactive slot, past capacity, a tail shorter than K, exactly K, full,
    # ragged
    kv_len = ([0, cap + 1, draft_k - 1, draft_k, cap]
              + [int(x) for x in np.linspace(draft_k + 1, cap - 1, B)])[:B]
    _, kp, vp, tables, lens = paged_operands(D, B, Hq, Hkv, D, ps,
                                             max_pages, kv_len, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(draft_k)
    q = torch.randn(B, draft_k, Hq, D, generator=g, device=cuda).to(dtype)
    args = (q, kp, vp, tables, lens)
    want = ref.paged_verify(*args).float()
    chip = ops.device_chip(cuda.index or 0)
    ctx = ops.paged_verify_context(chip, B, Hq, Hkv, D, cap,
                                   ops.dtype_name(dtype), ps, draft_k)
    configs = ops.PAGED_VERIFY.space.valid_configs(ctx)
    assert configs
    for cfg in configs:
        before = pv_kernel.paged_verify.launches
        out = ops.paged_verify(*args, config=cfg)
        torch.cuda.synchronize()
        assert pv_kernel.paged_verify.launches == before + 1
        torch.testing.assert_close(out.float(), want, atol=TOL[dtype],
                                   rtol=TOL[dtype], msg=lambda m: f"{cfg}: {m}")
        assert not out[0].any(), "kv_len == 0 must give exact zeros"
        assert not out[2, 0].any(), "an empty causal window gives zeros"


def test_paged_verify_rejects_what_it_does_not_take(cuda):
    _, kp, vp, tables, lens = paged_operands(0, 2, 4, 2, 16, 8, 2, [5, 6],
                                             torch.float32, cuda)
    q = torch.zeros(2, 4, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="block_kv"):
        pv_kernel.paged_verify(q, kp, vp, tables, lens, block_kv=0)
    with pytest.raises(ValueError, match="dtype"):
        pv_kernel.paged_verify(q.bfloat16(), kp, vp, tables, lens)
    with pytest.raises(ValueError, match="draft_k"):
        pv_kernel.paged_verify(q[:, :1].contiguous(), kp, vp, tables, lens)
    with pytest.raises(ValueError, match="pool shapes"):
        pv_kernel.paged_verify(q[..., :8].contiguous(), kp, vp, tables, lens)
    with pytest.raises(ValueError, match="kv_len"):
        pv_kernel.paged_verify(q, kp, vp, tables, lens[:1])
    with pytest.raises(ValueError, match="int8 pools"):
        pv_kernel.paged_verify(q, kp.to(torch.int8), vp.to(torch.int8),
                               tables, lens)


# (page_size, block_kv) of the int8 verify: blocks smaller than a page and
# not dividing it
BLOCKS_OFF_PAGE_KV8 = [(16, 8), (8, 12), (32, 20)]


@pytest.mark.parametrize("draft_k", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[3]}-{s[6]}")
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32],
                         ids=["q-bf16", "q-f32"])
def test_paged_verify_kv8_every_valid_config_matches_plain(cuda, shape,
                                                           draft_k, q_dtype):
    """The int8 branch of the verify: every valid config of the int8
    context at depths 2, 4 and 8, lengths with kv_len 0, a tail shorter
    than K and past the capacity, against the plain version (gather,
    dequantize, verify); empty windows are exact zeros."""
    B, Hq, Hkv, D, ps, max_pages, _ = shape
    cap = ps * max_pages
    kv_len = ([0, cap + 1, draft_k - 1, draft_k, cap]
              + [int(x) for x in np.linspace(draft_k + 1, cap - 1, B)])[:B]
    _, kp, vp, tables, lens = paged_operands(D + 2, B, Hq, Hkv, D, ps,
                                             max_pages, kv_len,
                                             torch.float32, cuda)
    kq, vq, ks, vs = kv8_pools((None, kp, vp), cuda)
    g = torch.Generator(device=cuda).manual_seed(draft_k)
    q = torch.randn(B, draft_k, Hq, D, generator=g, device=cuda).to(q_dtype)
    args = (q, kq, vq, tables, lens)
    scales = {"k_scales": ks, "v_scales": vs}
    want = ref.paged_verify(*args, **scales).float()
    chip = ops.device_chip(cuda.index or 0)
    ctx = ops.paged_verify_context(chip, B, Hq, Hkv, D, cap, "int8", ps,
                                   draft_k, ops.dtype_name(q_dtype))
    configs = ops.PAGED_VERIFY.space.valid_configs(ctx)
    assert configs
    for cfg in configs:
        before = pv_kernel.paged_verify.launches
        out = ops.paged_verify(*args, **scales, config=cfg)
        torch.cuda.synchronize()
        assert pv_kernel.paged_verify.launches == before + 1
        assert out.dtype == q_dtype
        torch.testing.assert_close(out.float(), want, atol=KV8_TOL[q_dtype],
                                   rtol=KV8_TOL[q_dtype],
                                   msg=lambda m: f"{cfg}: {m}")
        assert not out[0].any(), "kv_len == 0 must give exact zeros"
        assert not out[2, 0].any(), "an empty causal window gives zeros"


@pytest.mark.parametrize("ps,block_kv", BLOCKS_OFF_PAGE_KV8)
def test_paged_verify_kv8_blocks_and_depths_off_the_grid(cuda, ps, block_kv):
    """The int8 branch takes any block size (smaller than a page, not
    dividing it, spanning pages) at depths in and out of the tuned set
    (K 5 among them), packed and unpacked, for q in bf16 and f32; then
    the depth-5 verify through ``ops`` launches the fixed config sized by
    the int8 rows, with no tuning."""
    B, Hq, Hkv, D, max_pages = 8, 24, 8, 128, 96 // ps
    cap = ps * max_pages
    kv_len = [0, cap + 1, 1, 5, cap, 17, cap // 2 + 3, cap - 1]
    _, kp, vp, tables, lens = paged_operands(ps + 3, B, Hq, Hkv, D, ps,
                                             max_pages, kv_len,
                                             torch.float32, cuda)
    kq, vq, ks, vs = kv8_pools((None, kp, vp), cuda)
    scales = {"k_scales": ks, "v_scales": vs}
    g = torch.Generator(device=cuda).manual_seed(ps)
    for K in (2, 5, 9):
        q = torch.randn(B, K, Hq, D, generator=g, device=cuda)
        for q_dtype in (torch.bfloat16, torch.float32):
            args = (q.to(q_dtype), kq, vq, tables, lens)
            want = ref.paged_verify(*args, **scales).float()
            for pack in (True, False):
                out = pv_kernel.paged_verify(*args, **scales,
                                             block_kv=block_kv,
                                             pack_gqa=pack)
                torch.testing.assert_close(
                    out.float(), want, atol=KV8_TOL[q_dtype],
                    rtol=KV8_TOL[q_dtype],
                    msg=lambda m: f"K {K} {q_dtype} pack {pack}: {m}")
                assert not out[0].any()
    tuner = Autotuner(on_miss="error")
    q = torch.randn(B, 5, Hq, D, generator=g, device=cuda).bfloat16()
    args = (q, kq, vq, tables, lens)
    before = pv_kernel.paged_verify.launches
    out = ops.paged_verify(*args, **scales, tuner=tuner)
    assert pv_kernel.paged_verify.launches == before + 1
    torch.testing.assert_close(out.float(),
                               ref.paged_verify(*args, **scales).float(),
                               atol=2e-2, rtol=2e-2)
    assert tuner.stats()["misses"] == 0


def test_paged_verify_kv8_rejects_what_it_does_not_take(cuda):
    _, kp, vp, tables, lens = paged_operands(0, 2, 4, 2, 16, 8, 2, [5, 6],
                                             torch.float32, cuda)
    kq, vq, ks, vs = kv8_pools((None, kp, vp), cuda)
    q = torch.zeros(2, 4, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="int8 pools"):
        pv_kernel.paged_verify(q, kq, vq, tables, lens)
    with pytest.raises(ValueError, match="int8 pools"):
        pv_kernel.paged_verify(q, kp, vp, tables, lens, k_scales=ks,
                               v_scales=vs)
    with pytest.raises(ValueError, match="float32"):
        pv_kernel.paged_verify(q, kq, vq, tables, lens,
                               k_scales=ks.bfloat16(), v_scales=vs)
    with pytest.raises(ValueError, match="float32"):
        pv_kernel.paged_verify(q, kq, vq, tables, lens,
                               k_scales=ks[:, :1], v_scales=vs[:, :1])
    with pytest.raises(ValueError, match="16-byte"):
        pv_kernel.paged_verify(q[..., :8].contiguous(),
                               kq[..., :8].contiguous(),
                               vq[..., :8].contiguous(), tables, lens,
                               k_scales=ks, v_scales=vs)
    lib = pv_kernel.LIB.load()
    for D, kv_item, block_kv, K, g, pack, warps in (
            (128, 1, 128, 4, 3, 1, 4), (128, 1, 16, 8, 3, 1, 8),
            (96, 1, 64, 2, 1, 0, 2), (160, 1, 32, 4, 4, 1, 8),
            (128, 2, 64, 4, 3, 1, 4), (64, 4, 32, 2, 4, 0, 8)):
        assert lib.paged_verify_smem_bytes(D, kv_item, block_kv, K, g, pack,
                                           warps) == \
            pv_kernel.smem_bytes(D, kv_item, block_kv, K, g, bool(pack),
                                 warps)
    with pytest.raises(ValueError, match="kv_splits"):
        pv_kernel.paged_verify(q, kq, vq, tables, lens, k_scales=ks,
                               v_scales=vs, kv_splits=3)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_verify_kv_splits_8_is_repeatable(cuda, int8):
    """Eight blocks a row, merged by rank 0 in rank order: two calls give
    the same bits and match the plain version, at K 2 and at K 8 (24
    query rows a block: four sets), lengths 0, shorter than K, past the
    capacity and fewer than eight chunks among them."""
    B, Hq, Hkv, D, ps, max_pages = 8, 24, 8, 128, 16, 36
    cap = ps * max_pages
    kv_len = [0, cap + 1, 1, 5 * ps, cap, 17, cap // 2 + 3, cap - 1]
    _, kp, vp, tables, lens = paged_operands(9, B, Hq, Hkv, D, ps, max_pages,
                                             kv_len, torch.float32, cuda)
    scales = {}
    if int8:
        kp, vp, ks, vs = kv8_pools((None, kp, vp), cuda)
        scales = {"k_scales": ks, "v_scales": vs}
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    g = torch.Generator(device=cuda).manual_seed(8)
    for K in (2, 8):
        q = torch.randn(B, K, Hq, D, generator=g, device=cuda).bfloat16()
        args = (q, kp, vp, tables, lens)
        cfg = dict(block_kv=16, pack_gqa=True, kv_splits=8)
        one = pv_kernel.paged_verify(*args, **scales, **cfg)
        two = pv_kernel.paged_verify(*args, **scales, **cfg)
        torch.cuda.synchronize()
        assert torch.equal(one, two)
        torch.testing.assert_close(one.float(),
                                   ref.paged_verify(*args, **scales).float(),
                                   atol=2e-2, rtol=2e-2)
        assert not one[0].any() and not one[2, 0].any()


@pytest.mark.parametrize("num_warps", [1, 2, 8])
def test_paged_verify_streams_once_per_pass_of_query_sets(cuda, num_warps):
    """A block with more query sets than row groups (f32 pools at D 128:
    one 32-lane row group a warp; K 8 x group 3 = four sets) streams its
    span once per pass; every pass, split and packing matches the plain
    version at f32's tolerance."""
    B, Hq, Hkv, D, ps, max_pages = 4, 24, 8, 128, 16, 8
    cap = ps * max_pages
    kv_len = [0, cap + 1, 7, cap // 2 + 3]
    _, kp, vp, tables, lens = paged_operands(10, B, Hq, Hkv, D, ps,
                                             max_pages, kv_len,
                                             torch.float32, cuda)
    g = torch.Generator(device=cuda).manual_seed(num_warps)
    for K in (8, 9):
        q = torch.randn(B, K, Hq, D, generator=g, device=cuda)
        args = (q, kp, vp, tables, lens)
        want = ref.paged_verify(*args).float()
        for pack in (True, False):
            for splits in (1, 4):
                out = pv_kernel.paged_verify(*args, block_kv=16,
                                             pack_gqa=pack,
                                             num_warps=num_warps,
                                             kv_splits=splits)
                torch.testing.assert_close(
                    out, want, atol=1e-4, rtol=1e-4,
                    msg=lambda m: f"K {K} pack {pack} splits {splits}: {m}")
                assert not out[0].any()


@pytest.mark.parametrize("ps", [16, 128])
def test_paged_verify_takes_the_bulk_path_at_serving_pages(cuda, ps):
    """Float and int8 pools at pages of 16 and 128 copy their chunks by
    bulk copies; an int8 pool whose scale runs are not 16-byte multiples
    (a block of 2 rows) takes cp.async, and both are right."""
    B, Hq, Hkv, D, K, max_pages = 4, 24, 8, 128, 2, max(2, 512 // ps)
    cap = ps * max_pages
    kv_len = [0, cap, 3, cap // 2 + 1]
    _, kp, vp, tables, lens = paged_operands(ps + 2, B, Hq, Hkv, D, ps,
                                             max_pages, kv_len,
                                             torch.float32, cuda)
    kq, vq, ks, vs = kv8_pools((None, kp, vp), cuda)
    g = torch.Generator(device=cuda).manual_seed(ps)
    q = torch.randn(B, K, Hq, D, generator=g, device=cuda).bfloat16()
    runs = [("bulk", (q, kp.bfloat16(), vp.bfloat16(), tables, lens), {},
             ps),
            ("bulk", (q, kq, vq, tables, lens),
             {"k_scales": ks, "v_scales": vs}, ps),
            ("cp_async", (q, kq, vq, tables, lens),
             {"k_scales": ks, "v_scales": vs}, 2)]
    for route, args, scales, block_kv in runs:
        assert pv_kernel.path(args[1].element_size(), ps, block_kv) == route
        before = dict(pv_kernel.paged_verify.path_launches)
        out = pv_kernel.paged_verify(*args, **scales, block_kv=block_kv,
                                     kv_splits=2)
        assert pv_kernel.paged_verify.path_launches[route] == \
            before[route] + 1
        torch.testing.assert_close(
            out.float(), ref.paged_verify(*args, **scales).float(),
            atol=2e-2, rtol=2e-2, msg=lambda m: f"{route}: {m}")
        assert not out[0].any()


# (page_size, block_kv): blocks smaller than a page, not dividing it, and
# spanning pages without being a multiple of one
BLOCKS_OFF_PAGE = [(16, 8), (8, 12), (32, 48), (4, 4)]


@pytest.mark.parametrize("ps,block_kv", BLOCKS_OFF_PAGE)
def test_paged_kernels_take_blocks_off_the_page_grid(cuda, ps, block_kv):
    """The copies chase the block table row by row, so any block size is
    right, at depths in and out of the tuned set."""
    B, Hq, Hkv, D, max_pages = 8, 24, 8, 128, 96 // ps
    cap = ps * max_pages
    kv_len = [0, cap + 1, 1, 5, cap, 17, cap // 2 + 3, cap - 1]
    args = paged_operands(ps, B, Hq, Hkv, D, ps, max_pages, kv_len,
                          torch.bfloat16, cuda)
    for pack in (True, False):
        out = pd_kernel.paged_decode(*args, block_kv=block_kv, pack_gqa=pack)
        torch.testing.assert_close(out.float(), ref.paged_decode(*args).float(),
                                   atol=2e-2, rtol=2e-2)
        assert not out[0].any()
    g = torch.Generator(device=cuda).manual_seed(ps)
    for K in (2, 5, 9):
        q = torch.randn(B, K, Hq, D, generator=g, device=cuda).bfloat16()
        vargs = (q,) + args[1:]
        want = ref.paged_verify(*vargs).float()
        for pack in (True, False):
            out = pv_kernel.paged_verify(*vargs, block_kv=block_kv,
                                         pack_gqa=pack)
            torch.testing.assert_close(out.float(), want, atol=2e-2,
                                       rtol=2e-2, msg=lambda m: f"K {K}: {m}")


@pytest.mark.parametrize("ps,K", [(4, 2), (4, 5), (256, 4), (256, 5),
                                  (16, 5)])
def test_off_space_layouts_dispatch_a_fixed_config(cuda, ps, K):
    """A pool with an off-space page size, or a verify at an off-space
    depth, launches the fixed config through ``ops`` with no tuning (an
    erroring tuner would raise) and matches the plain version."""
    tuner = Autotuner(on_miss="error")
    B, Hq, Hkv, D = 4, 24, 8, 128
    max_pages = max(1, 320 // ps)
    cap = ps * max_pages
    kv_len = [0, cap, 3, cap // 2 + 1]
    args = paged_operands(K, B, Hq, Hkv, D, ps, max_pages, kv_len,
                          torch.bfloat16, cuda)
    if ps not in ops.PAGE_SIZES:
        before = pd_kernel.paged_decode.launches
        out = ops.paged_decode(*args, tuner=tuner)
        assert pd_kernel.paged_decode.launches == before + 1
        torch.testing.assert_close(out.float(), ref.paged_decode(*args).float(),
                                   atol=2e-2, rtol=2e-2)
    g = torch.Generator(device=cuda).manual_seed(K)
    q = torch.randn(B, K, Hq, D, generator=g, device=cuda).bfloat16()
    vargs = (q,) + args[1:]
    before = pv_kernel.paged_verify.launches
    out = ops.paged_verify(*vargs, tuner=tuner)
    assert pv_kernel.paged_verify.launches == before + 1
    torch.testing.assert_close(out.float(), ref.paged_verify(*vargs).float(),
                               atol=2e-2, rtol=2e-2)
    assert tuner.stats()["misses"] == 0


def dense_operands(seed, B, Hq, Hkv, D, T, dtype, device):
    """q and a (B, T, Hkv, D) cache handed over as (B, Hkv, T, D) views,
    as the serving path hands it."""
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)  # noqa: E731
    return (rand(B, Hq, D), rand(B, T, Hkv, D).transpose(1, 2),
            rand(B, T, Hkv, D).transpose(1, 2))


# (B, Hq, Hkv, D, T, dtype): phi4-mini's heads, phi3-mini (group 1, D 96),
# stablelm-12b (group 4, D 160), an f32 cache
DENSE_SHAPES = [(8, 24, 8, 128, 200, torch.bfloat16),
                (4, 32, 32, 96, 120, torch.bfloat16),
                (3, 32, 8, 160, 90, torch.bfloat16),
                (5, 8, 2, 64, 150, torch.float32)]


@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=lambda s: f"D{s[3]}-{s[5]}")
def test_dense_decode_every_valid_config_matches_plain(cuda, shape):
    """Both entry points of the gqa_decode kernel, every valid config of
    their spaces, ragged lengths with kv_len == 0 and kv_len > T."""
    B, Hq, Hkv, D, T, dtype = shape
    q, k, v = dense_operands(D, B, Hq, Hkv, D, T, dtype, cuda)
    lens = torch.tensor(([0, T + 5, 1, T, 33] + list(range(7, T, 29)))[:B],
                        dtype=torch.int32, device=cuda)
    want = ref.gqa_decode(q, k, v, kv_len=lens).float()
    full = ref.gqa_decode(q, k, v).float()
    chip = ops.device_chip(cuda.index or 0)
    dt = ops.dtype_name(dtype)
    for tunable, entry, fn, ctx, expect in (
            (ops.GQA_DECODE_RAGGED, ops.ragged_decode, gqa_kernel.gqa_decode,
             ops.gqa_decode_context(chip, B, Hq, Hkv, D, T, dt), want),
            (ops.DECODE_ATTENTION, ops.decode, da_kernel.decode_attention,
             ops.decode_attention_context(chip, B, Hq, Hkv, D, T, dt), full)):
        configs = tunable.space.valid_configs(ctx)
        assert configs
        for cfg in configs:
            before = fn.launches
            kw = {"kv_len": lens} if expect is want else {}
            out = entry(q, k, v, config=cfg, **kw)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            torch.testing.assert_close(out.float(), expect, atol=TOL[dtype],
                                       rtol=TOL[dtype],
                                       msg=lambda m: f"{cfg}: {m}")
            if expect is want:
                assert not out[0].any(), "kv_len == 0 must give exact zeros"


def test_gqa_decode_rejects_what_it_does_not_take(cuda):
    q, k, v = dense_operands(0, 2, 4, 2, 16, 40, torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        gqa_kernel.gqa_decode(q.bfloat16(), k, v)
    # one cluster of 1, 2, 4 or 8 blocks a row: no 0, 3, or v1's 16 and 32
    for splits in (0, 3, 16, 32):
        with pytest.raises(ValueError, match="k_splits"):
            gqa_kernel.gqa_decode(q, k, v, k_splits=splits)
    with pytest.raises(ValueError, match="block_kv"):
        gqa_kernel.gqa_decode(q, k, v, block_kv=40)
    with pytest.raises(ValueError, match="num_warps"):
        gqa_kernel.gqa_decode(q, k, v, num_warps=16)
    with pytest.raises(ValueError, match="contiguous"):
        gqa_kernel.gqa_decode(q, k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError, match="gqa_decode_kv8"):
        gqa_kernel.gqa_decode(q, k.to(torch.int8), v.to(torch.int8))
    lib = gqa_kernel.LIB.load()
    for D, item, block_kv, g, warps in ((128, 2, 64, 3, 2), (96, 2, 256, 1, 8),
                                        (160, 2, 128, 4, 4), (64, 4, 32, 1, 1),
                                        (80, 4, 128, 8, 4)):
        assert lib.gqa_decode_smem_bytes(D, item, block_kv, g, warps) == \
            gqa_kernel.float_smem_bytes(D, item, block_kv, g, g > 1, warps)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_gqa_decode_k_splits_8_is_one_launch_and_repeatable(cuda, dtype):
    """Eight blocks a row in one cluster, merged by rank 0 in rank order:
    one kernel a call and the same bits from call to call."""
    q, k, v = dense_operands(5, 8, 24, 8, 128, 544, dtype, cuda)
    lens = torch.tensor([0, 600, 1, 31, 32, 300, 528, 544],
                        dtype=torch.int32, device=cuda)
    cfg = dict(block_kv=32, k_splits=8, pack_gqa=True, num_warps=1)
    one = gqa_kernel.gqa_decode(q, k, v, kv_len=lens, **cfg)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        two = gqa_kernel.gqa_decode(q, k, v, kv_len=lens, **cfg)
        torch.cuda.synchronize()
    assert torch.equal(one, two)
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "gqa_decode_kernel" in kernels[0], kernels
    torch.testing.assert_close(
        one.float(), ref.gqa_decode(q, k, v, kv_len=lens).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


def kv8_operands(seed, B, Hq, Hkv, D, T, dtype, device):
    """q, and a (B, T, Hkv, D) cache quantized by the kv8 wire format,
    handed over as the (B, Hkv, T, D) and (B, Hkv, T) views serving hands
    the kernel: (q, k, v, k_scale, v_scale)."""
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device=device)  # noqa: E731
    kq, ks, vq, vs = quantize_kv(rand(B, T, Hkv, D), rand(B, T, Hkv, D))
    return (rand(B, Hq, D).to(dtype), kq.transpose(1, 2), vq.transpose(1, 2),
            ks.transpose(1, 2), vs.transpose(1, 2))


@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=lambda s: f"D{s[3]}-{s[5]}")
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32],
                         ids=["q-bf16", "q-f32"])
def test_gqa_decode_kv8_every_valid_config_matches_plain(cuda, shape,
                                                         q_dtype):
    """The int8 kernel, every valid config of its space, ragged lengths
    with kv_len == 0 and kv_len > T, against the plain dequantize-then-
    decode version."""
    B, Hq, Hkv, D, T, _ = shape
    args = kv8_operands(D, B, Hq, Hkv, D, T, q_dtype, cuda)
    lens = torch.tensor(([0, T + 5, 1, T, 33] + list(range(7, T, 29)))[:B],
                        dtype=torch.int32, device=cuda)
    want = ref.gqa_decode_kv8(*args, kv_len=lens).float()
    chip = ops.device_chip(cuda.index or 0)
    ctx = ops.gqa_decode_kv8_context(chip, B, Hq, Hkv, D, T,
                                     ops.dtype_name(q_dtype))
    configs = ops.GQA_DECODE_KV8.space.valid_configs(ctx)
    assert configs
    for cfg in configs:
        before = kv8_kernel.gqa_decode_kv8.launches
        out = ops.ragged_decode_kv8(*args, kv_len=lens, config=cfg)
        torch.cuda.synchronize()
        assert kv8_kernel.gqa_decode_kv8.launches == before + 1
        assert out.dtype == q_dtype
        torch.testing.assert_close(out.float(), want, atol=KV8_TOL[q_dtype],
                                   rtol=KV8_TOL[q_dtype],
                                   msg=lambda m: f"{cfg}: {m}")
        assert not out[0].any(), "kv_len == 0 must give exact zeros"


def test_gqa_decode_kv8_rejects_what_it_does_not_take(cuda):
    q, k, v, ks, vs = kv8_operands(0, 2, 4, 2, 16, 40, torch.float32, cuda)
    with pytest.raises(ValueError, match="int8 cache"):
        kv8_kernel.gqa_decode_kv8(q, k.float(), v.float(), ks, vs)
    with pytest.raises(ValueError, match="float32"):
        kv8_kernel.gqa_decode_kv8(q, k, v, ks.bfloat16(), vs.bfloat16())
    with pytest.raises(ValueError, match="B, Hkv, T"):
        kv8_kernel.gqa_decode_kv8(q, k, v, ks[:, :, :8], vs[:, :, :8])
    with pytest.raises(ValueError, match="16-byte"):
        kv8_kernel.gqa_decode_kv8(q[..., :8], k[..., :8], v[..., :8], ks, vs)
    lib = gqa_kernel.LIB_KV8.load()
    for D, block_kv, g, warps in ((128, 128, 3, 4), (64, 256, 1, 8),
                                  (160, 32, 4, 2)):
        assert lib.gqa_decode_kv8_smem_bytes(D, block_kv, g, warps) == \
            gqa_kernel.smem_bytes(D, 1, block_kv, g, g > 1, warps)


def test_dense_serving_on_card_matches_cpu(cuda):
    """Smoke phi4-mini in f32: dense prefill and decode steps on the card
    through the gqa_decode kernel give the CPU's plain path tokens, and its
    logits at the f32 tolerance."""
    set_default_tuner(Autotuner(on_miss="heuristic"))
    try:
        cfg = get_config("phi4-mini-3.8b", smoke=True)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        prompts = torch.from_numpy(np.random.default_rng(3).integers(
            1, cfg.vocab_size, (3, 11)))
        G = 6

        def run(m, device, impl):
            opts = lm.ForwardOpts(attn_chunk=4, decode_impl=impl)
            logits, cache = lm.prefill(m, cfg, prompts.to(device),
                                       max_len=11 + G, opts=opts)
            rows, tok = [logits.cpu()], torch.argmax(logits, -1,
                                                     keepdim=True)
            toks = [tok.cpu()]
            for i in range(G - 1):
                logits, cache = lm.decode_step(m, cfg, tok, cache, 11 + i,
                                               opts)
                tok = torch.argmax(logits, -1, keepdim=True)
                rows.append(logits.cpu())
                toks.append(tok.cpu())
            return torch.cat(toks, 1), rows

        cpu_toks, cpu_rows = run(model, "cpu", "plain")
        before = gqa_kernel.gqa_decode.launches
        gpu_toks, gpu_rows = run(model.to(cuda), cuda, "kernel")
        assert gqa_kernel.gqa_decode.launches == before + (G - 1) * cfg.n_layers
        assert torch.equal(gpu_toks, cpu_toks)
        for a, b in zip(gpu_rows, cpu_rows):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    finally:
        set_default_tuner(None)


def test_dense_kv8_serving_on_card_matches_cpu(cuda):
    """Smoke phi4-mini in f32 with int8 caches (kv8): dense prefill and
    decode steps on the card through the gqa_decode_kv8 kernel give the
    CPU's plain path tokens, and its logits at the int8 tolerance."""
    set_default_tuner(Autotuner(on_miss="heuristic"))
    try:
        cfg = get_config("phi4-mini-3.8b", smoke=True)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        prompts = torch.from_numpy(np.random.default_rng(3).integers(
            1, cfg.vocab_size, (3, 11)))
        G = 6

        def run(m, device, impl):
            opts = lm.ForwardOpts(attn_chunk=4, decode_impl=impl,
                                  quant="kv8")
            logits, cache = lm.prefill(m, cfg, prompts.to(device),
                                       max_len=11 + G, opts=opts)
            assert cache[0]["k"].dtype == torch.int8
            rows, tok = [logits.cpu()], torch.argmax(logits, -1,
                                                     keepdim=True)
            toks = [tok.cpu()]
            for i in range(G - 1):
                logits, cache = lm.decode_step(m, cfg, tok, cache, 11 + i,
                                               opts)
                tok = torch.argmax(logits, -1, keepdim=True)
                rows.append(logits.cpu())
                toks.append(tok.cpu())
            return torch.cat(toks, 1), rows

        cpu_toks, cpu_rows = run(model, "cpu", "plain")
        before = kv8_kernel.gqa_decode_kv8.launches
        gpu_toks, gpu_rows = run(model.to(cuda), cuda, "kernel")
        assert kv8_kernel.gqa_decode_kv8.launches == \
            before + (G - 1) * cfg.n_layers
        assert torch.equal(gpu_toks, cpu_toks)
        for a, b in zip(gpu_rows, cpu_rows):
            torch.testing.assert_close(a, b, atol=2e-3, rtol=2e-3)
    finally:
        set_default_tuner(None)


@pytest.mark.parametrize("rows", [8, 37, 512])
def test_rms_norm_every_valid_config_matches_plain(cuda, rows):
    g = torch.Generator(device=cuda).manual_seed(rows)
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(rows, 3072, generator=g, device=cuda) * 3).to(dtype)
        w = torch.randn(3072, generator=g, device=cuda).to(dtype)
        want = ref.rms_norm(x, w).float()
        ctx = ops.rmsnorm_context(ops.device_chip(cuda.index or 0), x.shape,
                                  ops.dtype_name(dtype))
        for cfg in ops.RMS_NORM.space.valid_configs(ctx):
            before = rms_kernel.rms_norm.launches
            out = ops.rmsnorm(x, w, config=cfg)
            torch.cuda.synchronize()
            assert rms_kernel.rms_norm.launches == before + 1
            torch.testing.assert_close(out.float(), want, atol=TOL[dtype],
                                       rtol=TOL[dtype])


@pytest.mark.parametrize("speculative", [0, 4])
def test_engine_on_card_matches_cpu(cuda, speculative):
    """Smoke phi4-mini in f32: the engine on the card through its kernels
    (paged_decode, or paged_verify under speculation, and rms_norm) gives
    the CPU engine's tokens, and its logits at the f32 tolerance."""
    set_default_tuner(Autotuner(on_miss="heuristic"))
    try:
        cfg = get_config("phi4-mini-3.8b", smoke=True)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(42)
        spec = [(rng.integers(1, cfg.vocab_size, int(p)).astype(np.int32),
                 int(g)) for p, g in zip(rng.integers(2, 10, 5),
                                         rng.integers(1, 5, 5))]

        def run(m, device, opts):
            reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
                    for i, (p, n) in enumerate(spec)]
            eng = ServingEngine(cfg, m, num_pages=24, page_size=8,
                                max_batch=3, max_seq_len=24, prefill_chunk=4,
                                opts=opts, device=device,
                                speculative=speculative, record_logits=True)
            eng.run(reqs)
            return [r.tokens for r in reqs], eng.logits_log

        cpu_toks, cpu_logits = run(model, "cpu", lm.ForwardOpts())
        attn = pv_kernel.paged_verify if speculative else \
            pd_kernel.paged_decode
        before = (attn.launches, rms_kernel.rms_norm.launches)
        gpu_toks, gpu_logits = run(
            model.to(cuda), cuda,
            lm.ForwardOpts(decode_impl="kernel", norm_impl="kernel"))
        assert attn.launches > before[0]
        assert rms_kernel.rms_norm.launches > before[1]
        assert gpu_toks == cpu_toks
        for rid, rows in cpu_logits.items():
            for a, b in zip(gpu_logits[rid], rows):
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    finally:
        set_default_tuner(None)


def _kv8_engine_card_vs_cpu(cuda, speculative):
    """Smoke phi4-mini in f32 with int8 page pools (kv8), by plain or
    speculative decode: the engine on the card through the kernels' int8
    branches gives the CPU engine's tokens, and its logits at the int8
    tolerance. Returns the launches of the path's attention kernel."""
    set_default_tuner(Autotuner(on_miss="heuristic"))
    try:
        cfg = get_config("phi4-mini-3.8b", smoke=True)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(42)
        spec = [(rng.integers(1, cfg.vocab_size, int(p)).astype(np.int32),
                 int(g)) for p, g in zip(rng.integers(2, 10, 5),
                                         rng.integers(1, 5, 5))]

        def run(m, device, opts):
            reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
                    for i, (p, n) in enumerate(spec)]
            eng = ServingEngine(cfg, m, num_pages=24, page_size=8,
                                max_batch=3, max_seq_len=24, prefill_chunk=4,
                                opts=opts, device=device,
                                speculative=speculative, record_logits=True)
            assert eng.cache[0]["k_pages"].dtype == torch.int8
            eng.run(reqs)
            assert eng.pool.num_allocated == 0
            return [r.tokens for r in reqs], eng.logits_log

        cpu_toks, cpu_logits = run(model, "cpu", lm.ForwardOpts(quant="kv8"))
        attn = pv_kernel.paged_verify if speculative else \
            pd_kernel.paged_decode
        before = attn.launches
        gpu_toks, gpu_logits = run(
            model.to(cuda), cuda,
            lm.ForwardOpts(decode_impl="kernel", norm_impl="kernel",
                           quant="kv8"))
        assert attn.launches > before
        assert gpu_toks == cpu_toks
        for rid, rows in cpu_logits.items():
            for a, b in zip(gpu_logits[rid], rows):
                np.testing.assert_allclose(a, b, atol=2e-3, rtol=2e-3)
    finally:
        set_default_tuner(None)


def test_kv8_engine_on_card_matches_cpu(cuda):
    """kv8 plain decode through the int8 branch of paged_decode."""
    _kv8_engine_card_vs_cpu(cuda, 0)


def test_kv8_spec_engine_on_card_matches_cpu(cuda):
    """kv8 speculative decode (K 4) through the int8 branch of
    paged_verify: drafts rejected and accepted over int8 pools."""
    _kv8_engine_card_vs_cpu(cuda, 4)


def w8a8_operands(seed, M, K, N, gran, device):
    """x (M, K) and w (K, N) drawn in f32 and quantized per row and per
    column (or per tensor), w K-major as ``QTensor`` stores it: (x, w,
    x_scale, w_scale)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=device)
    w = torch.randn(K, N, generator=g, device=device)
    per_tensor = gran == "per_tensor"
    xs = absmax_scale(x, axis=None if per_tensor else -1)
    ws = absmax_scale(w, axis=None if per_tensor else 0)
    return quantize(x, xs), k_major(quantize(w, ws)), xs, ws


# (M, K, N): decode's 8 rows with a ragged K and N, a ragged size past one
# tile in each dimension, and phi4-mini's decode wo (K 8192)
W8A8_SHAPES = [(8, 200, 96), (100, 3072, 200), (257, 8192, 3072)]


@pytest.mark.parametrize("shape", W8A8_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_matmul_w8a8_every_valid_config_matches_plain(cuda, shape):
    """Every valid config, both granularities, against the plain version;
    the epilogue configs equal the exact integer-grid product bit for bit
    (the sim path's arithmetic: float32 sums of integers stay exact here,
    and the scales multiply in the same order)."""
    M, K, N = shape
    chip = ops.device_chip(cuda.index or 0)
    for gran in ("per_channel", "per_tensor"):
        args = w8a8_operands(M + K + N, M, K, N, gran, cuda)
        xq, wq, xs, ws = args
        want = ref.matmul_w8a8(*args)
        acc = xq.float() @ wq.float()
        exact = acc * (xs * ws) if gran == "per_tensor" else acc * xs * ws
        ctx = ops.matmul_w8a8_context(chip, M, K, N, gran)
        configs = ops.MATMUL_W8A8.space.valid_configs(ctx)
        assert configs and all(c["scale_gran"] == gran for c in configs)
        for cfg in configs:
            before = mm8_kernel.matmul_w8a8.launches
            out = ops.matmul_w8a8(*args, config=cfg)
            torch.cuda.synchronize()
            assert mm8_kernel.matmul_w8a8.launches == before + 1
            assert out.shape == (M, N) and out.dtype == torch.float32
            torch.testing.assert_close(out, want, atol=W8A8_TOL,
                                       rtol=W8A8_TOL,
                                       msg=lambda m: f"{cfg}: {m}")
            if cfg["dequant"] == "epilogue":
                assert torch.equal(out, exact), cfg


def test_matmul_w8a8_rejects_what_it_does_not_take(cuda):
    x, w, xs, ws = w8a8_operands(0, 16, 64, 64, "per_channel", cuda)
    with pytest.raises(ValueError, match="K-major"):
        mm8_kernel.matmul_w8a8(x, w.contiguous(), xs, ws)
    with pytest.raises(ValueError, match="int8"):
        mm8_kernel.matmul_w8a8(x.float(), w, xs, ws)
    with pytest.raises(ValueError, match="per_channel scales"):
        mm8_kernel.matmul_w8a8(x, w, xs[:8], ws)
    with pytest.raises(ValueError, match="float32"):
        mm8_kernel.matmul_w8a8(x, w, xs.double(), ws.double())
    with pytest.raises(ValueError, match="multiples of 4"):
        mm8_kernel.matmul_w8a8(x[:, :6].contiguous(), k_major(w[:6]),
                               xs, ws)
    with pytest.raises(ValueError, match="block_m"):
        mm8_kernel.matmul_w8a8(x, w, xs, ws, block_m=48)
    with pytest.raises(ValueError, match="block_k"):
        mm8_kernel.matmul_w8a8(x, w, xs, ws, block_k=48)
    # K 72: rows of no 16-byte multiple, the mma.sync kernel's registers
    big = w8a8_operands(1, 128, 72, 256, "per_channel", cuda)
    assert mm8_kernel.path(72) == "mma_sync"
    with pytest.raises(ValueError, match="registers"):
        mm8_kernel.matmul_w8a8(*big, block_m=128, block_n=256, num_warps=4)
    with pytest.raises(ValueError, match="registers"):
        mm8_kernel.matmul_w8a8(*big, block_m=128, block_n=128, num_warps=4,
                               dequant="inline")
    # K 64: the wgmma kernel's registers (inline at 256 columns) and tiles
    big = w8a8_operands(1, 128, 64, 256, "per_channel", cuda)
    with pytest.raises(ValueError, match="registers"):
        mm8_kernel.matmul_w8a8(*big, block_m=128, block_n=256,
                               dequant="inline")
    with pytest.raises(ValueError, match="wgmma kernel takes block_k"):
        mm8_kernel.matmul_w8a8(*big, block_k=64)
    with pytest.raises(ValueError, match="num_stages"):
        mm8_kernel.matmul_w8a8(*big, num_stages=5)
    with pytest.raises(ValueError, match="split_k"):
        mm8_kernel.matmul_w8a8(*big, split_k=3)
    lib = mm8_kernel.LIB.load()
    for bm, bn, bk in ((16, 64, 64), (128, 256, 128), (64, 128, 32),
                       (32, 256, 96)):
        assert lib.matmul_w8a8_smem_bytes(bm, bn, bk) == \
            mm8_kernel.smem_bytes(bm, bn, bk)
    for bm, bn, st in ((8, 128, 8), (128, 256, 2), (64, 64, 3)):
        assert lib.matmul_w8a8_wgmma_smem_bytes(bm, bn, st) == \
            mm8_kernel.wgmma_smem_bytes(bm, bn, st)
    for K, sk in ((8192, 16), (3072, 16), (256, 8)):
        assert lib.matmul_w8a8_splits(K, sk) == \
            mm8_kernel.effective_splits(K, sk)
    # the C entries refuse what their templates do not instantiate
    out = torch.empty(16, 64, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.matmul_w8a8_launch(
        x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        out.data_ptr(), 16, 64, 64, 128, 256, 64, 4, 0, 16, 0, stream) != 0
    assert lib.matmul_w8a8_wgmma_launch(
        x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        out.data_ptr(), None, None, 16, 64, 64, 16, 256, 4, 1, 0, 0,
        stream) != 0


# phi4-mini's decode wo (8 x 8192 x 3072) and prefill wo (4096 x 8192 x
# 3072): the wgmma kernel, swapped at decode
W8A8_SERVING = [(8, 8192, 3072), (4096, 8192, 3072)]


@pytest.mark.parametrize("shape", W8A8_SERVING,
                         ids=lambda s: "x".join(map(str, s)))
def test_matmul_w8a8_wgmma_at_the_serving_shapes(cuda, shape):
    """Every fourth valid config at one serving shape on the wgmma path
    against the plain version, epilogue configs equal to the exact
    integer-grid product."""
    M, K, N = shape
    args = w8a8_operands(M + N, M, K, N, "per_channel", cuda)
    xq, wq, xs, ws = args
    want = ref.matmul_w8a8(*args)
    exact = (xq.float() @ wq.float()) * xs * ws
    ctx = ops.matmul_w8a8_context(ops.device_chip(cuda.index or 0), M, K, N)
    for cfg in ops.MATMUL_W8A8.space.valid_configs(ctx)[::4]:
        before = mm8_kernel.matmul_w8a8.path_launches["wgmma"]
        out = ops.matmul_w8a8(*args, config=cfg)
        torch.cuda.synchronize()
        assert mm8_kernel.matmul_w8a8.path_launches["wgmma"] == before + 1
        torch.testing.assert_close(out, want, atol=W8A8_TOL, rtol=W8A8_TOL,
                                   msg=lambda m: f"{cfg}: {m}")
        if cfg["dequant"] == "epilogue":
            assert torch.equal(out, exact), cfg


def test_matmul_w8a8_split_k_is_exact_and_repeatable(cuda):
    """At decode wo, epilogue dequant over 8 splits is bit-equal to one
    split (int32 partials sum exactly), and inline dequant over 8 splits
    gives the same bits on two launches (f32 partials in split order)."""
    args = w8a8_operands(3, 8, 8192, 3072, "per_channel", cuda)
    cfg = {"block_m": 8, "block_n": 128, "block_k": 128, "num_stages": 4}
    one = mm8_kernel.matmul_w8a8(*args, split_k=1, **cfg)
    eight = mm8_kernel.matmul_w8a8(*args, split_k=8, **cfg)
    assert torch.equal(one, eight)
    a = mm8_kernel.matmul_w8a8(*args, split_k=8, dequant="inline", **cfg)
    b = mm8_kernel.matmul_w8a8(*args, split_k=8, dequant="inline", **cfg)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a, ref.matmul_w8a8(*args), atol=W8A8_TOL,
                               rtol=W8A8_TOL)


def test_w8a8_dense_serving_on_card_matches_cpu(cuda):
    """Smoke phi4-mini in f32 with w8a8 MLP weights: dense prefill and
    decode steps on the card through matmul_w8a8 (and gqa_decode) give the
    CPU's tokens (its plain versions), logits at the int8 tolerance, with
    two launches a layer and forward pass; the sim path on the card
    launches none and gives the CPU sim path's tokens at f32."""
    set_default_tuner(Autotuner(on_miss="heuristic"))
    try:
        cfg = get_config("phi4-mini-3.8b", smoke=True)
        model = quantize_params(init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), "w8a8")
        prompts = torch.from_numpy(np.random.default_rng(3).integers(
            1, cfg.vocab_size, (3, 11)))
        G = 6

        def run(m, device, impl, quant_impl):
            opts = lm.ForwardOpts(attn_chunk=4, decode_impl=impl,
                                  quant="w8a8", quant_impl=quant_impl)
            logits, cache = lm.prefill(m, cfg, prompts.to(device),
                                       max_len=11 + G, opts=opts)
            rows, tok = [logits.cpu()], torch.argmax(logits, -1,
                                                     keepdim=True)
            toks = [tok.cpu()]
            for i in range(G - 1):
                logits, cache = lm.decode_step(m, cfg, tok, cache, 11 + i,
                                               opts)
                tok = torch.argmax(logits, -1, keepdim=True)
                rows.append(logits.cpu())
                toks.append(tok.cpu())
            return torch.cat(toks, 1), rows

        results = {q: run(model, "cpu", "plain", q) for q in ("pallas",
                                                              "sim")}
        model.to(cuda)
        assert model.layers[0].ffn.wi.values.stride() == (1, cfg.d_model)
        for quant_impl, per_pass, tol in (("pallas", 2, W8A8_TOL),
                                          ("sim", 0, 1e-4)):
            before = mm8_kernel.matmul_w8a8.launches
            toks, rows = run(model, cuda, "kernel", quant_impl)
            assert mm8_kernel.matmul_w8a8.launches == \
                before + per_pass * G * cfg.n_layers
            cpu_toks, cpu_rows = results[quant_impl]
            assert torch.equal(toks, cpu_toks), quant_impl
            for a, b in zip(rows, cpu_rows):
                torch.testing.assert_close(a, b, atol=tol, rtol=tol)
    finally:
        set_default_tuner(None)


# (label, B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, q_offset): bf16
# causal at phi4-mini's heads; f32 with a window on ragged lengths (group
# 4); D 120 with a window of 16 (group 3); f32 D 96 with a query offset;
# bf16 rows past a window's reach (no visible key) inside running tiles;
# bf16 D 160 at stablelm's 32/8 heads and D 256 on ragged lengths (three
# and four 64-column blocks of D)
FLASH_CASES = [
    ("bf16-causal", 2, 6, 2, 256, 256, 128, torch.bfloat16, True, None, 0),
    ("f32-window", 2, 4, 1, 200, 333, 64, torch.float32, True, 100, 0),
    ("bf16-d120-window", 1, 6, 2, 130, 130, 120, torch.bfloat16, True, 16,
     0),
    ("f32-d96-offset", 2, 3, 3, 77, 300, 96, torch.float32, True, None, 211),
    ("bf16-empty-rows", 1, 4, 2, 64, 40, 64, torch.bfloat16, True, 8, 40),
    ("bf16-d160", 1, 32, 8, 300, 300, 160, torch.bfloat16, True, None, 0),
    ("bf16-d256", 1, 4, 2, 200, 200, 256, torch.bfloat16, True, None, 0),
]


def flash_operands(seed, B, Hq, Hkv, Sq, Skv, D, dtype, device):
    """q, k, v as (B, H, S, D) views of (B, S, H, D) tensors, the layout
    the prefill hands the kernel."""
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)  # noqa: E731
    return (rand(B, Sq, Hq, D).transpose(1, 2),
            rand(B, Skv, Hkv, D).transpose(1, 2),
            rand(B, Skv, Hkv, D).transpose(1, 2))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: c[0])
def test_flash_attention_every_valid_config_matches_plain(cuda, case):
    """Every valid config against the plain version: o and lse at the
    dtype's tolerance, rows with no visible key exactly zero with lse
    -1e30, o in q's layout, one launch a call."""
    _, B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, q_offset = case
    q, k, v = flash_operands(D + Sq, B, Hq, Hkv, Sq, Skv, D, dtype, cuda)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              return_lse=True)
    want, want_lse = ref.flash_attention(q, k, v, **kw)
    empty = want_lse[0, 0] <= -1e30
    chip = ops.device_chip(cuda.index or 0)
    ctx = ops.attention_context(chip, B, Hq, Hkv, Sq, Skv, D,
                                ops.dtype_name(dtype), causal, window)
    configs = ops.FLASH_ATTENTION.space.valid_configs(ctx)
    assert configs
    for cfg in configs:
        before = fa_kernel.flash_attention.launches
        out, lse = ops.attention(q, k, v, config=cfg, **kw)
        torch.cuda.synchronize()
        assert fa_kernel.flash_attention.launches == before + 1
        assert out.stride() == q.stride()
        torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype], msg=lambda m: f"{cfg}: {m}")
        torch.testing.assert_close(lse, want_lse, atol=TOL[dtype],
                                   rtol=TOL[dtype], msg=lambda m: f"{cfg}: {m}")
        assert not out[:, :, empty].any() and (lse[:, :, empty] == -1e30).all()
    if case[0] == "bf16-empty-rows":
        assert empty.sum() == 57


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q, k, v = flash_operands(0, 1, 4, 2, 32, 32, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim 272"):
        big = flash_operands(1, 1, 2, 1, 16, 16, 272, torch.bfloat16, cuda)
        fa_kernel.flash_attention(*big)
    with pytest.raises(ValueError, match="D must be contiguous"):
        fa_kernel.flash_attention(
            q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="share a dtype"):
        fa_kernel.flash_attention(q, k.float(), v.float())
    with pytest.raises(ValueError, match="window"):
        fa_kernel.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="registers"):
        fa_kernel.flash_attention(q, k, v, block_q=128, num_warps=1)
    with pytest.raises(ValueError, match="registers"):
        fa_kernel.flash_attention(q, k, v, block_kv=32)
    with pytest.raises(ValueError, match="num_stages"):
        fa_kernel.flash_attention(q.float(), k.float(), v.float(),
                                  num_stages=3)
    # a row stride TMA cannot take (a (B, S, H, D + 4) buffer cut to D)
    padded = torch.zeros(1, 32, 4, 68, dtype=torch.bfloat16,
                         device=cuda)[..., :64].transpose(1, 2)
    with pytest.raises(ValueError, match="q: strides"):
        fa_kernel.flash_attention(padded, k, v)
    lib = fa_kernel.LIB.load()
    for D, item, bq, bkv, st in ((128, 2, 64, 64, 2), (120, 2, 128, 128, 3),
                                 (96, 4, 32, 32, 2), (256, 2, 64, 64, 4),
                                 (160, 2, 128, 64, 3)):
        assert lib.flash_attention_smem_bytes(D, item, bq, bkv, st) == \
            fa_kernel.smem_bytes(D, item, bq, bkv, st)
    # the C entry refuses what its templates do not instantiate
    o = torch.empty_like(q)
    lse = torch.empty(1, 4, 32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), 1, 4, 2, 32, 32, 64, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], 0.125, 1, 0, 0,
        64, 256, 4, 2, 1, stream) != 0


# flash_attention_bwd's cases, FLASH_CASES' columns: phi4-mini's heads at a
# short sequence; Sq 200 (not a tile multiple) at group 3; group 1 with D
# 96 and a window; f32 group 4 with a query offset and Skv > Sq; D 120,
# non-causal; D 64 with rows that see no key (exact zeros) inside running
# tiles
FLASH_BWD_CASES = [
    ("bf16-causal", 2, 6, 2, 128, 128, 128, torch.bfloat16, True, None, 0),
    ("bf16-ragged-g3", 1, 6, 2, 200, 200, 128, torch.bfloat16, True, None,
     0),
    ("bf16-g1-d96-window", 2, 4, 4, 150, 150, 96, torch.bfloat16, True, 40,
     0),
    ("f32-g4-offset", 2, 8, 2, 77, 300, 64, torch.float32, True, None, 211),
    ("bf16-d120-noncausal", 1, 6, 2, 90, 130, 120, torch.bfloat16, False,
     None, 0),
    ("bf16-empty-rows", 1, 4, 2, 64, 40, 64, torch.bfloat16, True, 8, 40),
]


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: c[0])
def test_flash_attention_bwd_every_valid_config_matches_plain(cuda, case):
    """Every valid config against the plain version: dq, dk and dv at the
    dtype's tolerance (relative to each gradient's largest value), rows
    that see no key exactly zero in dq, gradients in q's and k's layouts,
    one launch a call, and two calls bit-equal (no atomics)."""
    _, B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, q_offset = case
    q, k, v = flash_operands(D + Sq + 1, B, Hq, Hkv, Sq, Skv, D, dtype, cuda)
    do = flash_operands(D + Sq + 2, B, Hq, Hkv, Sq, Skv, D, dtype,
                        cuda)[0]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = ref.flash_attention(q, k, v, return_lse=True, **kw)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    empty = lse[0, 0] <= -1e30
    chip = ops.device_chip(cuda.index or 0)
    ctx = ops.attention_context(chip, B, Hq, Hkv, Sq, Skv, D,
                                ops.dtype_name(dtype), causal, window)
    configs = ops.FLASH_ATTENTION_BWD.space.valid_configs(ctx)
    assert configs
    for cfg in configs:
        before = fab_kernel.flash_attention_bwd.launches
        got = fab_kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw, **cfg)
        torch.cuda.synchronize()
        assert fab_kernel.flash_attention_bwd.launches == before + 1
        for name, g, w, like in zip("qkv", got, want, (q, k, v)):
            assert g.stride() == like.stride() and g.dtype == like.dtype
            scale = float(w.float().abs().max())
            torch.testing.assert_close(
                g.float() / scale, w.float() / scale, atol=TOL[dtype],
                rtol=TOL[dtype], msg=lambda m: f"d{name} {cfg}: {m}")
        assert not got[0][:, :, empty].any()
        again = fab_kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw,
                                               **cfg)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    if case[0] == "bf16-empty-rows":
        assert empty.sum() == 57


def test_flash_attention_bwd_rejects_what_it_does_not_take(cuda):
    q, k, v = flash_operands(0, 1, 4, 2, 32, 32, 64, torch.bfloat16, cuda)
    o, lse = ref.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="head_dim 160"):
        big = flash_operands(1, 1, 2, 1, 16, 16, 160, torch.bfloat16, cuda)
        fab_kernel.flash_attention_bwd(*big, big[0], lse[:, :2, :16],
                                       big[0])
    with pytest.raises(ValueError, match="D must be contiguous"):
        fab_kernel.flash_attention_bwd(
            q.transpose(2, 3).contiguous().transpose(2, 3), k, v, o, lse, o)
    with pytest.raises(ValueError, match="share a dtype"):
        fab_kernel.flash_attention_bwd(q, k, v, o, lse, o.float())
    with pytest.raises(ValueError, match="lse"):
        fab_kernel.flash_attention_bwd(q, k, v, o, lse.bfloat16(), o)
    with pytest.raises(ValueError, match="registers"):
        fab_kernel.flash_attention_bwd(q, k, v, o, lse, o, block_q=64,
                                       block_kv=32, num_warps=4)
    with pytest.raises(ValueError, match="num_stages"):
        fab_kernel.flash_attention_bwd(q, k, v, o, lse, o, num_stages=5)
    # a row stride TMA cannot take (a (B, S, H, D + 4) buffer cut to D)
    padded = torch.zeros(1, 32, 4, 68, dtype=torch.bfloat16,
                         device=cuda)[..., :64].transpose(1, 2)
    with pytest.raises(ValueError, match="do: strides"):
        fab_kernel.flash_attention_bwd(q, k, v, o, lse, padded)
    lib = fab_kernel.LIB.load()
    for D, item, bq, bkv, st in ((128, 2, 64, 64, 2), (120, 2, 64, 128, 3),
                                 (96, 4, 32, 32, 2), (64, 4, 128, 128, 2),
                                 (64, 2, 128, 128, 4)):
        assert lib.flash_attention_bwd_smem_bytes(D, item, bq, bkv, st) == \
            fab_kernel.smem_bytes(D, item, bq, bkv, st)
    # the C entry refuses what its templates do not instantiate (block_q
    # 128 at D 128: the dkv kernel's dk, dv, s^T and dp^T past 192)
    q2, k2, v2 = flash_operands(2, 1, 4, 2, 32, 32, 128, torch.bfloat16,
                                cuda)
    o2, lse2 = ref.flash_attention(q2, k2, v2, return_lse=True)
    dq = torch.empty_like(q2)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    delta = torch.zeros_like(lse2)
    assert lib.flash_attention_bwd_launch(
        q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), o2.data_ptr(),
        lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(), dq.data_ptr(),
        dq.data_ptr(), 1, 4, 2, 32, 32, 128, *q2.stride()[:3],
        *k2.stride()[:3], *v2.stride()[:3], *o2.stride()[:3],
        *q2.stride()[:3], *k2.stride()[:3], *v2.stride()[:3], 32, 0.1, 1, 0,
        0, 128, 64, 4, 2, 1, stream) != 0


def test_flash_autograd_function_on_card_matches_plain(cuda):
    """The autograd function at phi4-mini's heads: one launch of each
    kernel a forward and backward (the heuristic configs: no tuning
    launches), gradients of every input in its own layout within the bf16
    tolerance of torch autograd through the plain attention in f32."""
    from repro_torch.models import attention as ATT
    set_default_tuner(Autotuner(on_miss="heuristic"))
    try:
        g = torch.Generator(device=cuda).manual_seed(5)
        q, k, v = (torch.randn(2, 200, h, 128, generator=g, device=cuda)
                   .to(torch.bfloat16) for h in (24, 8, 8))
        dout = torch.randn(2, 200, 24, 128, generator=g, device=cuda)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (fa_kernel.flash_attention.launches,
                  fab_kernel.flash_attention_bwd.launches)
        out = ATT.run_attention(*leaves, impl="pallas")
        out.backward(dout.to(out.dtype))
        assert (fa_kernel.flash_attention.launches,
                fab_kernel.flash_attention_bwd.launches) == \
            (before[0] + 1, before[1] + 1)
    finally:
        set_default_tuner(None)
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ATT.full_attention(*ref_leaves).backward(dout)
    for got, want in zip(leaves, ref_leaves):
        assert got.grad.shape == got.shape and got.grad.dtype == got.dtype
        scale = float(want.grad.abs().max())
        torch.testing.assert_close(got.grad.float() / scale,
                                   want.grad / scale, atol=2e-2, rtol=2e-2)


# mla_decode's cases, (label, B, H, C, R, T, dtype, kv_len): deepseek-v2-lite's
# serving decode (every request at 528 of 544), its widths with ragged
# lengths (0 and past T among them) in bf16 and f32, H 4 with C 64 (rows
# padded to 16), and dsv2-lite-smoke's C 32, R 8; ckv and krope are views
# of longer caches, as the serving cache is
MLA_CASES = [
    ("bf16-serving", 8, 16, 512, 64, 544, torch.bfloat16, [528] * 8),
    ("bf16-ragged", 4, 16, 512, 64, 544, torch.bfloat16, [0, 1, 300, 600]),
    ("f32-ragged", 3, 16, 512, 64, 200, torch.float32, [0, 77, 250]),
    ("bf16-h4-c64", 3, 4, 64, 16, 200, torch.bfloat16, [0, 137, 250]),
    ("f32-smoke", 2, 4, 32, 8, 40, torch.float32, [17, 40]),
]


def mla_operands(seed, B, H, C, R, T, dtype, device):
    """q_abs, q_rope, and ckv, krope as the first T rows of caches 8 rows
    longer."""
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)  # noqa: E731
    return (rand(B, H, C), rand(B, H, R), rand(B, T + 8, C)[:, :T],
            rand(B, T + 8, R)[:, :T])


@pytest.mark.parametrize("case", MLA_CASES, ids=lambda c: c[0])
def test_mla_decode_every_valid_config_matches_plain(cuda, case):
    """Every valid config against the plain version at the dtype's
    tolerance, a request with kv_len 0 exactly zero, one launch a call,
    the context in f32."""
    _, B, H, C, R, T, dtype, lens = case
    args = mla_operands(C + T, B, H, C, R, T, dtype, cuda)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    scale = (C + R) ** -0.5
    want = ref.mla_decode_ragged(*args, kv_len=kv_len, scale=scale)
    chip = ops.device_chip(cuda.index or 0)
    ctx = ops.mla_decode_context(chip, B, H, C, R, T, ops.dtype_name(dtype))
    configs = ops.MLA_DECODE.space.valid_configs(ctx)
    assert configs
    empty = kv_len == 0
    for cfg in configs:
        before = mla_kernel.mla_decode.launches
        out = ops.latent_decode(*args, kv_len=kv_len, scale=scale, config=cfg)
        torch.cuda.synchronize()
        assert mla_kernel.mla_decode.launches == before + 1
        assert out.dtype == torch.float32 and out.shape == (B, H, C)
        torch.testing.assert_close(out, want, atol=TOL[dtype],
                                   rtol=TOL[dtype], msg=lambda m: f"{cfg}: {m}")
        assert not out[empty].any()


def test_mla_decode_rejects_what_it_does_not_take(cuda):
    qa, qr, ckv, kr = mla_operands(0, 2, 16, 512, 64, 64, torch.bfloat16,
                                   cuda)
    with pytest.raises(ValueError, match="share a dtype"):
        mla_kernel.mla_decode(qa.float(), qr, ckv, kr)
    with pytest.raises(ValueError, match="latent rank 40"):
        mla_kernel.mla_decode(*mla_operands(1, 2, 4, 40, 8, 32,
                                            torch.bfloat16, cuda))
    with pytest.raises(ValueError, match="shared memory"):     # 128 rows
        mla_kernel.mla_decode(*mla_operands(2, 2, 16, 512, 64, 200,
                                            torch.bfloat16, cuda),
                              block_kv=128)
    with pytest.raises(ValueError, match="k_splits"):
        mla_kernel.mla_decode(qa, qr, ckv, kr, k_splits=3)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        mla_kernel.mla_decode(qa, qr, torch.zeros_like(ckv).repeat(
            1, 1, 2)[..., ::2], kr)
    lib = mla_kernel.LIB.load()
    for width, item, bkv, warps in ((576, 2, 64, 8), (576, 4, 32, 4),
                                    (40, 4, 16, 4), (320, 4, 128, 8)):
        assert lib.mla_decode_smem_bytes(width, item, bkv, warps) == \
            mla_kernel.smem_bytes(width, item, bkv, warps)
    # the C entry refuses what its templates do not instantiate
    o = torch.empty(2, 1, 16, 512, device=cuda)
    lse = torch.empty(2, 1, 16, device=cuda)
    lens = torch.full((2,), 64, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.mla_decode_launch(
        qa.data_ptr(), qr.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
        lens.data_ptr(), o.data_ptr(), lse.data_ptr(), 2, 16, 512, 64, 64,
        *ckv.stride()[:2], *kr.stride()[:2], 1.0, 64, 1, 64, 2, 1,
        stream) != 0


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "olmoe-1b-7b"])
def test_mla_moe_dense_serving_on_card_matches_cpu(cuda, arch):
    """The smoke MLA + MoE and MoE models in f32: dense prefill and decode
    steps on the card (deepseek: the mla_decode kernel, one launch a layer
    and step) give the CPU's plain path tokens, and its logits at the f32
    tolerance."""
    set_default_tuner(Autotuner(on_miss="heuristic"))
    try:
        cfg = get_config(arch, smoke=True)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        prompts = torch.from_numpy(np.random.default_rng(3).integers(
            1, cfg.vocab_size, (3, 11)))
        G = 6

        def run(m, device, impl):
            opts = lm.ForwardOpts(attn_chunk=4, decode_impl=impl)
            logits, cache = lm.prefill(m, cfg, prompts.to(device),
                                       max_len=11 + G, opts=opts)
            rows, tok = [logits.cpu()], torch.argmax(logits, -1,
                                                     keepdim=True)
            toks = [tok.cpu()]
            for i in range(G - 1):
                logits, cache = lm.decode_step(m, cfg, tok, cache, 11 + i,
                                               opts)
                tok = torch.argmax(logits, -1, keepdim=True)
                rows.append(logits.cpu())
                toks.append(tok.cpu())
            return torch.cat(toks, 1), rows

        cpu_toks, cpu_rows = run(model, "cpu", "plain")
        before = mla_kernel.mla_decode.launches
        gpu_toks, gpu_rows = run(model.to(cuda), cuda, "kernel")
        mla_layers = cfg.n_layers if cfg.mla is not None else 0
        assert mla_kernel.mla_decode.launches == \
            before + (G - 1) * mla_layers
        assert torch.equal(gpu_toks, cpu_toks)
        for a, b in zip(gpu_rows, cpu_rows):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    finally:
        set_default_tuner(None)


@pytest.mark.parametrize("shape", [(200, 300, 136), (37, 45, 29),
                                   (256, 256, 256)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_matmul_configs_match_plain(cuda, shape, dtype):
    """A spread of valid configs (every fourth) against the plain version,
    atol and rtol at the dtype's tolerance (a bf16 output may round the
    other way by one unit in the last place)."""
    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    y = torch.randn(K, N, generator=g, device=cuda).to(dtype)
    want = ref.matmul(x, y).float()
    ctx = ops.matmul_context(ops.device_chip(cuda.index or 0), M, K, N,
                             ops.dtype_name(dtype))
    for cfg in ops.MATMUL.space.valid_configs(ctx)[::4]:
        before = mm_kernel.matmul.launches
        out = ops.matmul(x, y, config=cfg)
        torch.cuda.synchronize()
        assert mm_kernel.matmul.launches == before + 1
        assert out.shape == (M, N) and out.dtype == dtype
        torch.testing.assert_close(out.float(), want, atol=TOL[dtype],
                                   rtol=TOL[dtype],
                                   msg=lambda m: f"{cfg}: {m}")


def test_matmul_wgmma_at_a_serving_shape(cuda):
    """Every valid bf16 config at 2048^3 on the wgmma path, and (8, 3072)
    x (3072, 64), against the plain version."""
    chip = ops.device_chip(cuda.index or 0)
    for M, K, N in ((2048, 2048, 2048), (8, 3072, 64)):
        g = torch.Generator(device=cuda).manual_seed(M + K + N)
        x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
        y = torch.randn(K, N, generator=g, device=cuda).bfloat16()
        want = ref.matmul(x, y).float()
        ctx = ops.matmul_context(chip, M, K, N, "bfloat16")
        for cfg in ops.MATMUL.space.valid_configs(ctx):
            before = mm_kernel.matmul.path_launches["wgmma"]
            out = ops.matmul(x, y, config=cfg)
            torch.cuda.synchronize()
            assert mm_kernel.matmul.path_launches["wgmma"] == before + 1
            torch.testing.assert_close(out.float(), want, atol=2e-2,
                                       rtol=2e-2, msg=lambda m: f"{cfg}: {m}")


def test_matmul_rejects_what_it_does_not_take(cuda):
    x = torch.randn(64, 64, device=cuda)
    with pytest.raises(ValueError, match="float16"):
        mm_kernel.matmul(x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        mm_kernel.matmul(x, x.t())
    with pytest.raises(ValueError, match="block_m"):
        mm_kernel.matmul(x, x, block_m=96)
    with pytest.raises(ValueError, match="registers"):
        mm_kernel.matmul(torch.randn(256, 64, device=cuda),
                         torch.randn(64, 256, device=cuda), block_m=256,
                         block_n=256, num_warps=8)
    xb = torch.randn(256, 64, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="wgmma kernel takes block_m"):
        mm_kernel.matmul(xb, xb.t().contiguous(), block_k=32)
    lib = mm_kernel.LIB.load()
    for bm, bn, st in ((64, 64, 2), (128, 256, 3), (128, 128, 4)):
        assert lib.matmul_wgmma_smem_bytes(bm, bn, st) == \
            mm_kernel.wgmma_smem_bytes(bm, bn, st)


def test_fresh_default_tuner_hits_mm8k_in_the_shipped_db(cuda):
    """A fresh process's tuner resolves the mm8k matmul from the shipped
    DB with no tune, and the config launches."""
    set_default_tuner(None)
    try:
        tuner = default_tuner()
        tuner.on_miss = "error"
        ctx = ops.matmul_context(ops.device_chip(cuda.index or 0), 8192,
                                 8192, 8192, "bfloat16")
        cfg = tuner.best_config(ops.MATMUL, ctx)
        assert tuner.stats()["hits"] == 1 and tuner.stats()["tunes"] == 0
        x = torch.randn(8192, 8192, device=cuda).bfloat16()
        y = torch.randn(8192, 8192, device=cuda).bfloat16()
        out = ops.matmul(x, y)
        assert tuner.stats()["hits"] == 2 and tuner.stats()["tunes"] == 0
        torch.testing.assert_close(out.float(), ref.matmul(x, y).float(),
                                   atol=2e-2, rtol=2e-2)
        assert ops.MATMUL.space.is_valid(cfg, ctx)
    finally:
        set_default_tuner(None)

