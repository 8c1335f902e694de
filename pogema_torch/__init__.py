"""pogema_torch — the batched POGEMA environment core in PyTorch, for one
NVIDIA H100.

A port of ``pogema_tpu`` (which stays the reference): B envs × N agents
step together as batched tensor code on one device, and the packed
observation windows come from hand-written CUDA kernels
(``ops/cuda_windows.py``, built from ``csrc/`` at first use), as does the
threefry hash of every random draw (``ops/cuda_threefry.py``). State and
resets are bit-equal to the JAX package for the same seed.

Beside the core: the policy models (``models``), flax weights loaded
through ``interop``, the batched policy evaluator and the PPO learner
(``parallel``: rollouts, GAE and the observation-based, fused and
recurrent train steps, with the optimizer in ``parallel.optim``),
checkpoints (``utils.checkpoint``) and the BFS planner with its
evaluator (``core.planner``).

The host rim (upstream: pogema's user-facing surface): ``pogema_v0`` and
the ``Pogema*`` envs (``envs``), the wrappers and framework adapters
(``wrappers``, ``integrations``), the batched numpy
``PogemaVectorEnv``, the named maps (``maps``), the A* and planner
policies, the evaluation harness (``toolbox``) and the SVG episode
animation (``animation``). Where gymnasium is
installed, ``gymnasium.make("PogemaTorch-v0", grid_config=...,
device=...)`` builds a ``pogema_v0`` env; the JAX package keeps the id
``Pogema-v0``.
"""

from .core import EnvState, PogemaCore, StepResult
from .grid_config import FREE, MOVES, NUM_ACTIONS, OBSTACLE, GridConfig

__version__ = "0.1.0"


def _register_gym_env():
    try:
        import gymnasium
    except ImportError:  # gymnasium is optional: the rim runs without it
        return
    if "PogemaTorch-v0" not in gymnasium.registry:
        gymnasium.register(id="PogemaTorch-v0",
                           entry_point="pogema_torch.envs:_make_pogema_gym_entry",
                           disable_env_checker=True)


_register_gym_env()

__all__ = [
    "GridConfig",
    "PogemaCore",
    "EnvState",
    "StepResult",
    "FREE",
    "OBSTACLE",
    "MOVES",
    "NUM_ACTIONS",
    "__version__",
]


def __getattr__(name):
    # The rim is imported lazily, so the core does not load it.
    if name in ("pogema_v0", "Pogema", "PogemaLifeLong", "PogemaCoopFinish", "ActionsSampler"):
        from . import envs

        return getattr(envs, name)
    if name in ("AnimationMonitor", "AnimationConfig"):
        from . import animation

        return getattr(animation, name)
    if name in ("AStarAgent", "BatchAStarAgent"):
        from . import a_star_policy

        return getattr(a_star_policy, name)
    if name == "GlobalPlannerPolicy":
        from .planner_policy import GlobalPlannerPolicy

        return GlobalPlannerPolicy
    if name == "PogemaVectorEnv":
        from .integrations.vector import PogemaVectorEnv

        return PogemaVectorEnv
    raise AttributeError(f"module 'pogema_torch' has no attribute {name!r}")
