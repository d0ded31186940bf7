"""stablelm-12b [hf:stabilityai] — dense GQA; head_dim 160 (non-128-aligned,
a deliberate stress case for kernel tiling portability)."""
import dataclasses
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=13824, vocab_size=100352,
)

SMOKE = dataclasses.replace(
    FULL, name="stablelm-smoke", n_layers=2, d_model=80, n_heads=4,
    n_kv_heads=2, head_dim=20, d_ff=192, vocab_size=512, dtype="float32")
