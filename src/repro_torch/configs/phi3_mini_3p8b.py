"""phi3-mini-3.8b [arXiv:2404.14219] — RoPE SwiGLU; kv=32 of 32 heads ⇒
effectively MHA; head_dim 96 (sub-lane-width stress case)."""
import dataclasses
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
)

SMOKE = dataclasses.replace(
    FULL, name="phi3-mini-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, dtype="float32")
