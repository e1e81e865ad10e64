"""Durable-run layer of the port: atomic, async, keep-k checkpoints in the
reference's layout.  See :mod:`repro_torch.checkpoint.checkpointer`."""
from .checkpointer import (  # noqa: F401
    Checkpointer, CheckpointPolicy, atomic_write_text)

__all__ = ["Checkpointer", "CheckpointPolicy", "atomic_write_text"]
