"""deepseek-v2-lite-16b [arXiv:2405.04434; hf] — MLA (kv_lora 512) +
64 routed experts top-6 + 2 shared; first layer dense (d_ff 10944)."""
import dataclasses
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2),
    first_dense=1, d_ff_dense=10944,
)

SMOKE = dataclasses.replace(
    FULL, name="dsv2-lite-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=32, vocab_size=512, dtype="float32",
    mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
                  capacity_factor=8.0),
    first_dense=1, d_ff_dense=128)
