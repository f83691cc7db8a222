"""Fault-tolerant checkpointing in the JAX store's on-disk format."""
from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint, save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
