"""Unified model configuration covering the 10 assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True          # renormalize top-k weights to sum to 1
    aux_loss_coef: float = 0.01
    every: int = 1                  # MoE at layers where idx % every == rem
    rem: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256                # SSD chunk length (autotuned)
    # Hybrid pattern (jamba): attention at layer idx % attn_every == attn_rem.
    attn_every: int = 0             # 0 = pure SSM (no attention layers)
    attn_rem: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    norm: str = "rms"               # rms | layernorm
    act: str = "swiglu"             # swiglu | gelu
    rope: bool = True
    rope_theta: float = 10000.0
    learned_pos: bool = False       # whisper-style absolute positions
    max_position: int = 1 << 20
    window: Optional[int] = None    # sliding-window attention size
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None

    moe: Optional[MoEConfig] = None
    first_dense: int = 0            # first N layers dense even if MoE
    d_ff_dense: Optional[int] = None  # d_ff for dense layers of MoE models

    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # Encoder-decoder (whisper): n_layers counts DECODER layers.
    n_enc_layers: int = 0
    enc_seq: int = 0                # encoder frames (stub frontend output)

    # VLM: number of stub patch-embedding prefix positions in train shapes.
    n_prefix: int = 0

    dtype: str = "bfloat16"

    # --- derived layer plan -------------------------------------------------
    def layer_kinds(self) -> List[str]:
        """Per-decoder-layer kind string '<mixer>_<ffn>' where mixer ∈
        {attn, mamba} and ffn ∈ {mlp, moe, none}."""
        kinds = []
        for i in range(self.n_layers):
            if self.ssm is not None:
                ae = self.ssm.attn_every
                mixer = "attn" if (ae and i % ae == self.ssm.attn_rem) else "mamba"
            elif self.family == "encdec":
                mixer = "dec"           # decoder layers (self + cross attn)
            else:
                mixer = "attn"
            if self.d_ff == 0 and self.moe is None:
                ffn = "none"                      # pure mamba blocks
            elif self.moe is not None and i >= self.first_dense and \
                    i % self.moe.every == self.moe.rem:
                ffn = "moe"
            else:
                ffn = "mlp"
            kinds.append(f"{mixer}_{ffn}")
        return kinds

    def scan_plan(self) -> List[Tuple[Tuple[str, ...], int]]:
        """Greedy decomposition of layer_kinds into (unit_pattern, repeats)
        so that units can be scanned with stacked params. A unit is the
        shortest repeating pattern; leading non-repeating layers become
        repeats=1 units (e.g. deepseek's first dense layer)."""
        kinds = self.layer_kinds()
        plan: List[Tuple[Tuple[str, ...], int]] = []
        i = 0
        n = len(kinds)
        while i < n:
            best = (1, 1)  # (unit_len, repeats)
            for unit_len in range(1, min(16, n - i) + 1):
                unit = kinds[i:i + unit_len]
                reps = 1
                while i + (reps + 1) * unit_len <= n and \
                        kinds[i + reps * unit_len: i + (reps + 1) * unit_len] == unit:
                    reps += 1
                if reps * unit_len > best[0] * best[1] or \
                        (reps * unit_len == best[0] * best[1] and reps > best[1]):
                    best = (unit_len, reps)
            unit_len, reps = best
            plan.append((tuple(kinds[i:i + unit_len]), reps))
            i += unit_len * reps
        return plan

    @property
    def attn_qk_dim(self) -> int:
        if self.mla is not None:
            return self.mla.qk_nope_dim + self.mla.qk_rope_dim
        return self.head_dim

    @property
    def attn_v_dim(self) -> int:
        if self.mla is not None:
            return self.mla.v_head_dim
        return self.head_dim

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.headdim

    def validate(self) -> None:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.ssm is not None:
            assert self.d_inner % self.ssm.headdim == 0
        if self.family == "encdec":
            assert self.n_enc_layers > 0 and self.enc_seq > 0
