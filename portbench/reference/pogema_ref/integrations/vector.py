"""A plain vector adapter: B envs × N agents stepped by
:meth:`~..core.api.PogemaCore.step_autoreset` and handed to the host as
flat ``[B*N, ...]`` numpy arrays under gymnasium's
``AutoresetMode.SAME_STEP`` contract, written as plainly as it can be:

* every returned tensor goes to numpy by ``.cpu().numpy()``;
* the returned observation of an env that ended is the first of its new
  episode, and its terminal observation is in ``infos["final_obs"]``:
  the whole pre-reset observation, with the rows of the envs that did
  not end set to zero (no gather);
* ``infos["_final_obs"]`` and ``infos["_metrics"]`` are the ended envs'
  mask and ``infos["metrics/<k>"]`` each episode metric, zero where the
  env did not end, all repeated per agent slot.

Only 'default' observations, in the grid or the packed layout. ``rows``
keeps a subset of a B-env batch: the reset splits the key into B env
keys as the whole batch would and keeps those rows, so the kept envs
step as they step in the whole batch (env rows are independent); ``step``
then takes the actions of the kept envs' slots only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import random as jr, step as step_mod
from ..core.api import PogemaCore
from ..grid_config import GridConfig


class VectorEnv:
    def __init__(self, grid_config: GridConfig, num_vec_envs: int, obs_layout: str = "grid",
                 auto_reset_mode: str = "cached", maze: bool = False, device="cpu",
                 rows: Optional[Sequence[int]] = None):
        self.num_vec_envs = int(num_vec_envs)
        self.rows = list(range(self.num_vec_envs)) if rows is None else [int(r) for r in rows]
        self.core = PogemaCore(grid_config, num_envs=len(self.rows), maze=maze,
                               auto_reset_mode=auto_reset_mode, obs_layout=obs_layout,
                               device=device)
        self.num_agents = self.core.cfg.num_agents
        self.state = self.init = None

    def _flat(self, t: torch.Tensor) -> np.ndarray:
        a = t.cpu().numpy()
        return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])

    def reset(self, seed: int):
        """The reset from ``seed`` (``jax.random.key(seed)``), as the first
        reset of ``PogemaVectorEnv``."""
        dev = self.core.device
        keys = jr.split(jr.key(seed, dev), self.num_vec_envs)[torch.tensor(self.rows, device=dev)]
        self.state = self.init = self.core._reset_envs(keys)
        return self._flat(step_mod.observe_state(self.core.cfg, self.state)), {}

    def step(self, actions):
        """``actions``: the kept envs' slots, ``len(rows) * N`` integers."""
        acts = torch.as_tensor(np.asarray(actions, np.int32).reshape(len(self.rows), -1),
                               device=self.core.device)
        self.state, obs, res, done, metrics = self.core.step_autoreset(self.state, self.init,
                                                                       acts)
        infos = {}
        ended = done.cpu().numpy()
        if ended.any():
            mask = np.repeat(ended, self.num_agents)
            final = self._flat(res.observations)
            keep = mask.reshape((-1,) + (1,) * (final.ndim - 1))
            infos["final_obs"] = np.where(keep, final, 0).astype(final.dtype)
            infos["_final_obs"] = mask
            infos["_metrics"] = mask
            for k, v in metrics.items():
                infos[f"metrics/{k}"] = np.repeat(np.where(ended, v.cpu().numpy(), 0.0),
                                                  self.num_agents)
        return (self._flat(obs), self._flat(res.rewards).astype(np.float32),
                self._flat(res.terminated), self._flat(res.truncated), infos)
