"""Vectorized numpy adapter for learners outside this package.

Counterpart of ``pogema_tpu/integrations/vector.py``. External learners
(SampleFactory, CleanRL, SB3) consume batched numpy arrays.
:class:`PogemaVectorEnv` is a ``gymnasium.vector.VectorEnv`` over
:class:`~pogema_torch.core.api.PogemaCore`: B envs × N agents advance
together on ``device`` per call, and the host sees flat ``[B*N, ...]``
numpy arrays. Each agent slot is one "vector env"
(``single_action_space=Discrete(5)``), the batch shape an external PPO
consumes.

* The host copy: a step's observations, rewards, flags, done flags and
  metrics go to pinned host memory by non-blocking copies, followed by
  one wait for the device (:func:`pogema_torch.utils.host.fetch`). Only
  on a step where an episode ended is there a second copy: the terminal
  observations of the envs that ended, and of no other env. On the card
  the returned arrays therefore sit in pinned host memory, which stays
  page-locked once freed (PyTorch caches it for the next copies): a
  learner that keeps a rollout's observations should store copies of
  them (``np.array(obs)``, or its own preallocated buffer), not the
  arrays themselves.
* ``obs_dtype=torch.bfloat16`` keeps the observations in bf16 on the
  device and across the copy, which halves the bytes; numpy has no bf16,
  so the host widens them to float32 after the copy.
* ``obs_layout='packed'`` gives ``[B*N, 3*W*W]`` float rows (a reshape of
  the grid layout, built by one K1b launch per observation set on the
  card); the grid layout and 'POMAPF' take their obstacle windows from
  K1.
* Auto-reset follows gymnasium's ``AutoresetMode.SAME_STEP``: when an
  episode ends, the returned obs are the FIRST obs of the new episode;
  the terminal obs land in ``infos["final_obs"]`` (mask
  ``infos["_final_obs"]``, zeros elsewhere) and the episode metrics
  (ISR/CSR/ep_length, avg_throughput for LifeLong) in
  ``infos["metrics/<k>"]`` (mask ``infos["_metrics"]``), broadcast per
  agent slot.
* Tracing: :meth:`PogemaVectorEnv.step` runs in the span
  ``pogema.vector.step`` and the terminal copy in
  ``pogema.vector.final_obs``; ``PogemaVectorEnv._final_obs.rows`` counts
  the env rows that copy took (the attribute sits on the traced method),
  and ``fetch.bytes`` the bytes of every host copy.

Upstream parity anchor: pogema/integrations/sample_factory.py is the
reference's only auto-reset consumer (B=1); this generalizes it to B
envs per call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import random as jr
from ..core.api import PogemaCore
from ..grid_config import NUM_ACTIONS, GridConfig
from ..utils.gym_compat import SAME_STEP, VectorEnv, gymnasium, spaces
from ..utils.host import fetch
from ..utils.profiling import traced


def _host_dtype(obs_dtype) -> np.dtype:
    """The numpy dtype of the float observations at the host edge: that of
    ``obs_dtype`` where numpy has it, float32 otherwise (bf16)."""
    if obs_dtype is None:
        return np.dtype(np.float32)
    try:
        dt = torch.empty((), dtype=obs_dtype).numpy().dtype
    except TypeError:
        return np.dtype(np.float32)
    return dt if dt.kind in "fiub" else np.dtype(np.float32)


class PogemaVectorEnv(VectorEnv):
    """``num_envs`` in the gymnasium sense is ``num_vec_envs *
    grid_config.num_agents`` (one slot per agent). Supports the 'default'
    (per-agent window tensors) and 'POMAPF' (dict of per-agent windows and
    coordinates) observation types. ``device``: "cuda" (the default)
    raises without a card; "cpu" runs on the host."""

    metadata = {"autoreset_mode": SAME_STEP, "render_modes": []}

    def __init__(
        self,
        grid_config: Optional[GridConfig] = None,
        num_vec_envs: int = 64,
        obs_layout: str = "grid",
        obs_dtype: Optional[torch.dtype] = None,
        auto_reset_mode: str = "cached",
        maze: bool = False,
        map_bank=None,
        device="cuda",
        **kwargs,
    ):
        if grid_config is None:
            grid_config = GridConfig(**kwargs)
        if grid_config.observation_type not in ("default", "POMAPF"):
            raise ValueError(
                "PogemaVectorEnv supports observation_type='default' (per-agent window "
                "tensors) and 'POMAPF' (dict of per-agent windows + coordinates); 'MAPF' has "
                "per-ENV global leaves (global_obstacles [S,S]) that the one-slot-per-agent "
                "vector layout would duplicate num_agents times — centralized consumers "
                "should drive PogemaCore directly")
        self.grid_config = grid_config
        self._core = PogemaCore(grid_config, num_envs=num_vec_envs,
                                auto_reset_mode=auto_reset_mode, maze=maze, map_bank=map_bank,
                                obs_dtype=obs_dtype, device=device, obs_layout=obs_layout)
        cfg = self._core.cfg
        self.device = self._core.device
        self.num_vec_envs = int(num_vec_envs)
        self.num_agents = cfg.num_agents
        self.num_envs = self.num_vec_envs * self.num_agents
        self._host_obs_dtype = dt = _host_dtype(obs_dtype)
        w = cfg.window
        obs_shape = (3 * w * w,) if obs_layout == "packed" else (3, w, w)
        self.single_observation_space = self.observation_space = None
        self.single_action_space = self.action_space = None
        if spaces is not None:
            if cfg.observation_type == "POMAPF":
                # Coordinates are unpadded logical grid coordinates: active
                # agents lie in [0, size); r is headroom for any
                # border-parked inactive slot.
                r, s = cfg.obs_radius, cfg.size
                self.single_observation_space = spaces.Dict({
                    "obstacles": spaces.Box(0.0, 1.0, shape=(w, w), dtype=dt),
                    "agents": spaces.Box(0.0, 1.0, shape=(w, w), dtype=dt),
                    "xy": spaces.Box(-r, s - 1 + r, shape=(2,), dtype=np.int32),
                    "target_xy": spaces.Box(-r, s - 1 + r, shape=(2,), dtype=np.int32),
                })
                self.observation_space = gymnasium.vector.utils.batch_space(
                    self.single_observation_space, self.num_envs)
            else:
                self.single_observation_space = spaces.Box(0.0, 1.0, shape=obs_shape, dtype=dt)
                self.observation_space = spaces.Box(0.0, 1.0, shape=(self.num_envs,) + obs_shape,
                                                    dtype=dt)
            self.single_action_space = spaces.Discrete(NUM_ACTIONS)
            self.action_space = spaces.MultiDiscrete(np.full(self.num_envs, NUM_ACTIONS))

        self._state = None
        self._initial_state = None
        self._episode = 0
        self._base_seed = (grid_config.seed if grid_config.seed is not None
                           else int(np.random.SeedSequence().entropy % 2**31))

    # -- helpers ----------------------------------------------------------

    def _flat(self, a: np.ndarray) -> np.ndarray:
        """[B, N, ...] -> [B*N, ...]."""
        return a.reshape((self.num_envs,) + a.shape[2:])

    def _host_obs(self, x):
        """Host observations [B, N, ...] as the flat arrays of the edge:
        float leaves in the host obs dtype, integer leaves as int32."""
        if isinstance(x, dict):
            return {k: self._host_obs(v) if v.dtype.kind == "f" else self._flat(v).astype(np.int32)
                    for k, v in x.items()}
        a = self._flat(x)
        return a if a.dtype == self._host_obs_dtype else a.astype(self._host_obs_dtype)

    @traced("pogema.vector.final_obs")
    def _final_obs(self, observations, done: np.ndarray):
        """The terminal observations of the envs that ended (``done``),
        zeros in every other slot. Copies only the ended envs' rows, and
        adds their number to ``PogemaVectorEnv._final_obs.rows``."""
        idx = np.nonzero(done)[0]
        PogemaVectorEnv._final_obs.rows += len(idx)
        sel = torch.as_tensor(idx, device=self.device)

        def place(rows):
            full = np.zeros((self.num_vec_envs,) + rows.shape[1:], rows.dtype)
            full[idx] = rows
            return full

        if isinstance(observations, dict):
            rows = fetch({k: v[sel] for k, v in observations.items()})
            return self._host_obs({k: place(v) for k, v in rows.items()})
        return self._host_obs(place(fetch(observations[sel])))

    # -- gymnasium VectorEnv API ------------------------------------------

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._base_seed = int(seed)
            self._episode = 0
        key = self._core.make_key(self._base_seed)
        if self._episode:
            key = jr.fold_in(key, self._episode)
        self._episode += 1
        self._state, obs = self._core.reset(key)
        self._initial_state = self._state
        return self._host_obs(fetch(obs)), {}

    @traced("pogema.vector.step")
    def step(self, actions):
        """``actions``: B*N integers (numpy, a list, or a tensor on any
        device)."""
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        acts = (actions.to(torch.int32) if isinstance(actions, torch.Tensor)
                else np.asarray(actions, np.int32)).reshape(self.num_vec_envs, self.num_agents)
        self._state, obs, res, done, metrics = self._core.step_autoreset(
            self._state, self._initial_state, acts)
        obs, rew, term, trunc, done, metrics = fetch(
            (obs, res.rewards, res.terminated, res.truncated, done, metrics))
        infos = {}
        if done.any():
            mask = np.repeat(done, self.num_agents)
            infos["final_obs"] = self._final_obs(res.observations, done)
            infos["_final_obs"] = mask
            infos["_metrics"] = mask
            for k, v in metrics.items():
                infos[f"metrics/{k}"] = np.repeat(np.where(done, v, 0.0), self.num_agents)
        return (self._host_obs(obs), self._flat(rew).astype(np.float32), self._flat(term),
                self._flat(trunc), infos)

    def close_extras(self, **kwargs):
        self._state = self._initial_state = None


PogemaVectorEnv._final_obs.rows = 0
