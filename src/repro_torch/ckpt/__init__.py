from repro_torch.ckpt.manager import CheckpointManager  # noqa: F401
