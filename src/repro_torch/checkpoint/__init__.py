"""Checkpoints in the JAX package's format, with an async writer
(``checkpoint.manager``)."""

from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "latest_step", "restore_pytree",
           "save_pytree"]
