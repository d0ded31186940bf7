"""The Hopper flash-attention kernels' host-side rules, on the CPU.

The bf16 forward and backward run wgmma kernels fed by TMA
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``); what
decides whether a launch is taken is Python: the tensor-map eligibility of
each operand (``flash_attention.tma_layout_error``), the register and
shared-memory fits the config spaces (version 2) constrain on, and the
heuristics. Here: the fits equal the formulas of the CUDA sources (read out
of the sources and evaluated), each space has valid configs, and its
heuristic is one of them, at every shape chip_smoke and the shipped DB use
(D 64, 96, 120, 128 and 160; Sq 64 to 32,768; bf16 and f32), and the
eligibility check takes the prefill's transpose views and refuses what TMA
cannot read. The kernels themselves are held against the plain versions on
the card (``tests/test_torch_gpu.py``).
"""

import pathlib
import re

import pytest
import torch

from repro_torch.core.hardware import chip_from_properties
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import flash_attention_bwd as fab_kernel
from repro_torch.kernels import ops

H100_SXM = chip_from_properties("NVIDIA H100 80GB HBM3", 132, 232448,
                                50 * 2**20, 80 * 2**30)
CSRC = pathlib.Path(fa_kernel.__file__).resolve().parents[1] / "csrc"


TERNARY = re.compile(r"\(([^()?]*)\?([^():]*):([^()]*)\)")


def c_function(source: str, name: str, scope: dict = None):
    """A small integer function of a CUDA source (its ``const int``
    locals, ternaries and one ``return``, on one line or several) as a
    Python callable, C's integer division and logic translated;
    ``scope`` holds the constants and functions it calls."""
    text = (CSRC / source).read_text()
    m = re.search(r"\b%s\(([^)]*)\)\s*\{(?:([^\n]*)\}|(.*?)\n\})" % name,
                  text, re.S)
    assert m, name
    params = [p.split()[-1] for p in m.group(1).split(",")]
    body = []
    for stmt in (m.group(2) or m.group(3)).split(";"):
        stmt = " ".join(stmt.split())
        if not stmt:
            continue
        stmt = stmt.replace("const int ", "").replace("/", "//")
        stmt = stmt.replace("&&", " and ").replace("||", " or ")
        lhs, eq, rhs = (("return", " ", stmt[len("return "):])
                        if stmt.startswith("return ")
                        else stmt.partition(" = "))
        assert eq, stmt
        rhs = "(%s)" % rhs
        while TERNARY.search(rhs):
            rhs = TERNARY.sub(r"((\2) if (\1) else (\3))", rhs)
        body.append(lhs + eq + rhs)
    src = "def f(%s):\n    %s" % (", ".join(params), "\n    ".join(body))
    round16 = lambda d: (d + 15) // 16 * 16  # noqa: E731 (the header's)
    env = {"round16": round16,
           "row_bytes": lambda d, isz: round16(d) * isz + 16, **(scope or {})}
    exec(src, env)
    return env["f"]


HEAD_DIMS = (64, 96, 120, 128, 160)
SEQS = (64, 200, 512, 4096, 32768)


def test_forward_fits_equal_the_source():
    """``smem_bytes`` and ``regs_fit`` are ``flash_attention_smem_bytes``'s
    and the instantiation rules of ``csrc/flash_attention.cu``."""
    bf16_smem = c_function("flash_attention.cu", "bf16_smem")
    f32_smem = c_function("flash_attention.cu", "f32_smem")
    bf16_fit = c_function("flash_attention.cu", "bf16_regs_fit")
    f32_fit = c_function("flash_attention.cu", "f32_regs_fit")
    for D in range(8, 257, 8):
        for bkv in fa_kernel.BLOCK_KV:
            for bq in fa_kernel.BLOCK_Q:
                for st in fa_kernel.NUM_STAGES:
                    assert fa_kernel.smem_bytes(D, 2, bq, bkv, st) == \
                        bf16_smem(D, bq, bkv, st)
                assert fa_kernel.smem_bytes(D, 4, bq, bkv) == \
                    f32_smem(D, bq, bkv)
                for nw in fa_kernel.NUM_WARPS:
                    rt, rem = divmod(bq, 16 * nw)
                    assert fa_kernel.regs_fit(D, bq, bkv, nw, 4) == (
                        rem == 0 and rt in (1, 2) and f32_fit(
                            fa_kernel.head_dim_class(D), bkv, rt))
                    assert fa_kernel.regs_fit(D, bq, bkv, nw, 2) == (
                        bq in (64, 128) and nw == bq // 16
                        and bkv in (64, 128) and bf16_fit(
                            fa_kernel.col_blocks(D), bkv))


def test_backward_fits_equal_the_source():
    """``smem_bytes`` and ``regs_fit`` are
    ``flash_attention_bwd_smem_bytes``'s and the instantiation rules of
    ``csrc/flash_attention_bwd.cu``, both kernels."""
    src = "flash_attention_bwd.cu"
    dkv16, dq16 = (c_function(src, n) for n in ("dkv_bf16_smem",
                                                "dq_bf16_smem"))
    dkv32, dq32 = (c_function(src, n) for n in ("dkv_smem", "dq_smem"))
    dkv16_fit, dq16_fit = (c_function(src, n) for n in ("dkv_bf16_fit",
                                                        "dq_bf16_fit"))
    dkv32_fit, dq32_fit = (c_function(src, n) for n in ("dkv_regs_fit",
                                                        "dq_regs_fit"))
    for D in range(8, 129, 8):
        for bq in fab_kernel.BLOCK_Q:
            for bkv in fab_kernel.BLOCK_KV:
                for st in fab_kernel.NUM_STAGES:
                    assert fab_kernel.smem_bytes(D, 2, bq, bkv, st) == max(
                        dkv16(D, bq, bkv, st), dq16(D, bq, bkv, st))
                assert fab_kernel.smem_bytes(D, 4, bq, bkv) == max(
                    dkv32(D, 4, bq, bkv), dq32(D, 4, bq, bkv))
                nb = fa_kernel.col_blocks(D)
                hd = fab_kernel.head_dim_class(D)
                assert fab_kernel.regs_fit(D, bq, bkv, 4, 2) == (
                    bq in (64, 128) and bkv in (64, 128)
                    and dkv16_fit(nb, bq) and dq16_fit(nb, bkv))
                for nw in fab_kernel.NUM_WARPS:
                    (rkv, mkv), (rq, mq) = (divmod(bkv, 16 * nw),
                                            divmod(bq, 16 * nw))
                    assert fab_kernel.regs_fit(D, bq, bkv, nw, 4) == (
                        mkv == 0 and mq == 0 and rkv in (1, 2)
                        and rq in (1, 2) and dkv32_fit(hd, bq, rkv)
                        and dq32_fit(hd, bkv, rq))
                    if nw != 4:
                        assert not fab_kernel.regs_fit(D, bq, bkv, nw, 2)
    assert not fab_kernel.regs_fit(160, 64, 64, 4, 2)


@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_forward_space_at_every_shape(D, dtype):
    """Valid configs, the heuristic among them, at each sequence length;
    bf16 configs are the wgmma kernel's (a warpgroup per 64 rows, 2-4
    stages), f32 ones double-buffer."""
    space = ops.FLASH_ATTENTION.space
    for S in SEQS:
        ctx = ops.attention_context(H100_SXM, 8, 32, 8, S, S, D, dtype)
        valid = space.valid_configs(ctx)
        assert valid, (D, dtype, S)
        assert ops.FLASH_ATTENTION.default_config(ctx) in valid
        for c in valid:
            if dtype == "bfloat16":
                assert c["block_q"] in (64, 128)
                assert c["num_warps"] == c["block_q"] // 16
            else:
                assert c["num_stages"] == 2


@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_backward_space_at_every_shape(D, dtype):
    """Valid configs, the heuristic among them, at each sequence length up
    to D 128; none past it (the kernels take D <= 128)."""
    space = ops.FLASH_ATTENTION_BWD.space
    for S in SEQS:
        ctx = ops.attention_context(H100_SXM, 4, 24, 8, S, S, D, dtype)
        valid = space.valid_configs(ctx)
        if D > fab_kernel.MAX_HEAD_DIM:
            assert not valid
            continue
        assert valid, (D, dtype, S)
        assert ops.FLASH_ATTENTION_BWD.default_config(ctx) in valid
        assert all(c["num_warps"] == 4 for c in valid) or dtype == "float32"


@pytest.mark.parametrize("D", (64, 96, 120, 128, 160, 256))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_tma_layout_takes_the_prefill_views(D, dtype):
    """q, k and v as the prefill and training hand them over, (B, H, S, D)
    views of (B, S, H, D) activations, and contiguous (B, H, S, D)
    tensors: TMA takes them."""
    item = torch.tensor([], dtype=dtype).element_size()
    for t in (torch.empty(2, 33, 6, D, dtype=dtype).transpose(1, 2),
              torch.empty(2, 6, 33, D, dtype=dtype),
              torch.empty(1, 7, 3, D, dtype=dtype).transpose(1, 2)):
        assert fa_kernel.tma_layout_error(t.shape, t.stride(), item,
                                          t.data_ptr()) is None


def test_tma_layout_refuses_what_a_map_cannot_read():
    """A row stride that is no 16-byte multiple, D not contiguous, a
    broadcast (zero) stride, a base off 16 bytes and rows of D that are no
    16-byte multiple are refused, each with its reason."""
    def err(t):
        return fa_kernel.tma_layout_error(t.shape, t.stride(),
                                          t.element_size(), t.data_ptr())

    padded = torch.empty(2, 33, 6, 68, dtype=torch.bfloat16)[..., :64]
    assert "strides" in err(padded.transpose(1, 2))
    assert err(padded.transpose(1, 2).contiguous()) is None
    assert "contiguous" in err(
        torch.empty(2, 6, 64, 33, dtype=torch.bfloat16).transpose(2, 3))
    assert "strides" in err(
        torch.empty(2, 1, 33, 64, dtype=torch.bfloat16).expand(2, 6, 33, 64))
    flat = torch.empty(2 * 6 * 33 * 64 + 8, dtype=torch.bfloat16)
    assert "aligned" in err(flat[1:1 + 2 * 6 * 33 * 64].view(2, 6, 33, 64))
    assert "16-byte" in err(torch.empty(1, 2, 8, 12, dtype=torch.bfloat16))
