"""olmoe-1b-7b [arXiv:2409.02060; hf] — 64-expert top-8 MoE, 1.3B active."""
import dataclasses
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
)

SMOKE = dataclasses.replace(
    FULL, name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=32, vocab_size=512, dtype="float32",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=8.0))
