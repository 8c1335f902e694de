"""pogema_torch — the batched POGEMA environment core in PyTorch, for one
NVIDIA H100.

A port of ``pogema_tpu`` (which stays the reference): B envs × N agents
step together as batched tensor code on one device, and the packed
observation windows come from a hand-written CUDA kernel
(``ops/cuda_windows.py``, built from ``csrc/`` at first use). State and
resets are bit-equal to the JAX package for the same seed.

Beside the core: the policy models (``models``), flax weights loaded
through ``interop``, the batched policy evaluator and the PPO learner
(``parallel``: rollouts, GAE and the observation-based, fused and
recurrent train steps, with the optimizer in ``parallel.optim``),
checkpoints (``utils.checkpoint``) and the BFS planner with its
evaluator (``core.planner``).
"""

from .core import EnvState, PogemaCore, StepResult
from .grid_config import FREE, MOVES, NUM_ACTIONS, OBSTACLE, GridConfig

__version__ = "0.1.0"

__all__ = [
    "GridConfig",
    "PogemaCore",
    "EnvState",
    "StepResult",
    "FREE",
    "OBSTACLE",
    "MOVES",
    "NUM_ACTIONS",
]
