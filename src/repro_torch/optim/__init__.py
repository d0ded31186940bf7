from repro_torch.optim.adamw import AdamWConfig, AdamWState, apply_updates, init_state, schedule_lr  # noqa: F401
