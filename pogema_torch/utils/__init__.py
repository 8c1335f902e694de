"""Utilities of the port: checkpointing (``checkpoint``), ANSI rendering
(``render``), the rim's host copies (``host``) and gymnasium's base
classes or their stand-ins (``gym_compat``)."""

from .checkpoint import (
    checkpoint_exists,
    extract_params_from_state,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "checkpoint_exists",
           "extract_params_from_state"]
