"""Checkpointing: atomic save/restore, retention, elastic re-meshing."""
from repro_torch.checkpoint.manager import CheckpointManager   # noqa: F401
