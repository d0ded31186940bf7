from repro_torch.checkpoint.checkpoint import latest_step, prune_old, restore, save  # noqa: F401
