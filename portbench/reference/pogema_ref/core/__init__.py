"""Batched environment core of the reference."""

from .api import PogemaCore
from .types import EnvState, StepResult

__all__ = ["PogemaCore", "EnvState", "StepResult"]
