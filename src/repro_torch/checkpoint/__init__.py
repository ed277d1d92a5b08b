from repro_torch.checkpoint.manager import CheckpointManager, as_manager  # noqa: F401
