"""Architecture registry of the port: the archs that paged and dense
serving run.

Both need a dense RoPE attention arch with no sliding window
(``models.lm._check_supported``), so of the reference's ten configs the
port carries the three that qualify, each with its full and smoke variant.
"""

from typing import List

from repro_torch.configs import phi3_mini_3p8b, phi4_mini_3p8b, stablelm_12b
from repro_torch.models.config import ModelConfig

_MODULES = {
    "phi4-mini-3.8b": phi4_mini_3p8b,
    "phi3-mini-3.8b": phi3_mini_3p8b,
    "stablelm-12b": stablelm_12b,
}

ARCHS: List[str] = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    cfg = _MODULES[name].SMOKE if smoke else _MODULES[name].FULL
    cfg.validate()
    return cfg
