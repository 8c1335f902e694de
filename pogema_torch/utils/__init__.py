"""Utilities of the port: checkpointing (``checkpoint``), ANSI rendering
(``render``), the rim's host copies (``host``), gymnasium's base classes
or their stand-ins (``gym_compat``), the numpy oracle (``oracle``), state
checks (``validation``), the host parity generator (``parity``) and
profiling helpers (``profiling``)."""

from .checkpoint import (
    checkpoint_exists,
    extract_params_from_state,
    restore_checkpoint,
    save_checkpoint,
)
from .oracle import OracleEnv

__all__ = ["OracleEnv", "save_checkpoint", "restore_checkpoint", "checkpoint_exists",
           "extract_params_from_state"]
