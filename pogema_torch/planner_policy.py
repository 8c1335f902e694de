"""Global shortest-path planner as a toolbox algo (name: "Planner").

Counterpart of ``pogema_tpu/planner_policy.py``: a host rim over
:mod:`pogema_torch.core.planner`. It consumes 'MAPF' observations (the
global obstacle map and every agent's and target's coordinates), computes
per-agent BFS distance-to-goal fields on ``device`` (the card unless the
caller asks for the CPU) and descends them greedily with agent avoidance
and the random escape move.

The fields are cached per (map, targets) pair, so they are computed again
only for a new episode or, under LifeLong, when a respawn moves a target.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import random as jr
from .core.planner import distance_fields, greedy_actions


class GlobalPlannerPolicy:
    """Toolbox policy: ``act(observations) -> list[int]``.

    Requires ``observation_type='MAPF'`` (raises otherwise: the global map
    is what makes a centralized planner centralized)."""

    def __init__(self, avoid_agents: bool = True, seed: int = 0,
                 on_goal_inactive: bool = True, device="cuda"):
        """on_goal_inactive: treat agents standing on their goal as
        passable. Matches on_target='finish' (the default mode), where the
        env hides finished agents but MAPF obs still report their last
        coordinates. Pass False for on_target='nothing', where on-goal
        agents keep occupying their cells. device: "cuda" (the default)
        raises without a card."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GlobalPlannerPolicy(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the host")
        self._avoid_agents = bool(avoid_agents)
        self._on_goal_inactive = bool(on_goal_inactive)
        self._seed = int(seed)
        self.reset_states()

    def reset_states(self):
        self._step_idx = 0
        self._cache_key = None
        self._dist = None

    def act(self, observations) -> list:
        ob0 = observations[0]
        if not isinstance(ob0, dict) or "global_obstacles" not in ob0:
            raise ValueError("GlobalPlannerPolicy needs observation_type='MAPF' "
                             "(global_obstacles/global_xy/global_target_xy in obs)")
        grid = np.asarray(ob0["global_obstacles"], np.uint8)
        targets = np.asarray(ob0["global_target_xy"], np.int32)
        xy = np.asarray(ob0["global_xy"], np.int32)
        dev = self.device

        key = (grid.tobytes(), targets.tobytes())
        if key != self._cache_key:
            # A 1-cell obstacle border: the planner's candidate cells
            # assume the padded-grid convention.
            padded = np.pad(grid, 1, constant_values=1)
            self._dist = distance_fields(torch.as_tensor(padded[None], device=dev),
                                         torch.as_tensor(targets[None] + 1, device=dev))
            self._cache_key = key

        step_key = jr.fold_in(jr.key(self._seed, dev), self._step_idx)
        self._step_idx += 1
        if self._on_goal_inactive:
            active = ~np.all(xy == targets, axis=-1)
        else:
            active = np.ones(xy.shape[0], bool)
        actions = greedy_actions(self._dist, torch.as_tensor(xy[None] + 1, device=dev),
                                 torch.as_tensor(active[None], device=dev),
                                 avoid_agents=self._avoid_agents, keys=step_key[None])
        return actions[0].cpu().numpy().astype(int).tolist()
