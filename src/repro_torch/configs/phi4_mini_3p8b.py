"""phi4-mini-3.8b [arXiv:2412.08905; hf] — dense, RoPE SwiGLU GQA."""
import dataclasses
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=200064, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    FULL, name="phi4-mini-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, dtype="float32")
