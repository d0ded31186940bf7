from repro_torch.runtime.trainer import InjectedFailure, Trainer, TrainerConfig  # noqa: F401
from repro_torch.runtime.compression import ef_compress, init_ef_state  # noqa: F401
