"""Utilities of the port: checkpointing."""

from .checkpoint import (
    checkpoint_exists,
    extract_params_from_state,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "checkpoint_exists",
           "extract_params_from_state"]
