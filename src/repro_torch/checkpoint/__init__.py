from repro_torch.checkpoint.manager import CheckpointManager, Rows  # noqa: F401
