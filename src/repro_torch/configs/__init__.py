"""Architecture registry of the port: the archs that paged and dense
serving run.

Both serve RoPE attention archs with no sliding window, learned positions
or prefix embeddings (``models.lm._check_dense``). The paged path takes
the dense GQA family only (``models.lm._check_paged``); the dense path
also takes MoE layers and MLA attention. So of the reference's ten configs
the port carries five, each with its full and smoke variant: three dense
GQA archs, olmoe (MoE) and deepseek-v2-lite (MLA + MoE), the last two on
the dense path only.
"""

from typing import List

from repro_torch.configs import (
    deepseek_v2_lite_16b, olmoe_1b_7b, phi3_mini_3p8b, phi4_mini_3p8b,
    stablelm_12b,
)
from repro_torch.models.config import ModelConfig

_MODULES = {
    "phi4-mini-3.8b": phi4_mini_3p8b,
    "phi3-mini-3.8b": phi3_mini_3p8b,
    "stablelm-12b": stablelm_12b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
}

ARCHS: List[str] = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    cfg = _MODULES[name].SMOKE if smoke else _MODULES[name].FULL
    cfg.validate()
    return cfg
