"""Batched public core API: ``PogemaCore`` over B envs × N agents.

Counterpart of ``pogema_tpu/core/api.py``. All state is explicit
(``EnvState`` in, ``EnvState`` out) and lives on one device, the card
unless the caller asks for the CPU.

Auto-reset comes in two modes:

* ``'cached'`` (default): finished envs go back to their reset-time state
  (``initial_state``) with their key advanced, so maps and placements
  repeat per env. The episode-invariant leaves (obstacles, placement_ok,
  and targets_xy or, in LifeLong, target_queue) are taken from the
  running state instead of being selected.
* ``'regen'``: finished envs get a newly generated map and placement,
  drawn from their advanced key; an env whose draw cannot be placed
  falls back to its reset-time state. Nothing is generated on a step
  where no env finished.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..grid_config import GridConfig, StaticConfig
from . import metrics as metrics_mod
from . import random as jr
from . import step as step_mod
from .types import FIELDS, EnvState


def _select(mask, a, b):
    """Per env: ``a`` where ``mask`` [B] is set, else ``b``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def select_state(mask, a: EnvState, b: EnvState) -> EnvState:
    """Per env, every leaf of ``a`` where ``mask`` [B] is set, else of ``b``."""
    return EnvState(**{f: None if getattr(a, f) is None else _select(mask, getattr(a, f), getattr(b, f))
                       for f in FIELDS})


def _advance_key(keys):
    return jr.split(keys, 1)[:, 0]


class PogemaCore:
    """Batched environment: holds the static config and the fixed map,
    placements and map bank as tensors on ``device``."""

    def __init__(
        self,
        grid_config: GridConfig,
        num_envs: int = 1,
        auto_reset_mode: str = "cached",
        maze: bool = False,
        map_bank: Optional[np.ndarray] = None,
        obs_dtype: Optional[torch.dtype] = None,
        device="cuda",
        obs_layout: str = "grid",
    ):
        """obs_dtype: cast float observation leaves (default f32).
        device: where state and work live; 'cuda' (the default) raises
        when no card is present instead of running on the CPU."""
        self.grid_config = grid_config
        cfg = grid_config.to_static()
        if obs_layout != "grid":
            kv = {k: getattr(cfg, k) for k in StaticConfig.__slots__}
            kv["obs_layout"] = obs_layout
            cfg = StaticConfig(**kv)
        self.cfg: StaticConfig = cfg
        self.num_envs = int(num_envs)
        if auto_reset_mode not in ("cached", "regen"):
            raise ValueError("auto_reset_mode must be 'cached' or 'regen'")
        self.auto_reset_mode = auto_reset_mode
        self.obs_dtype = obs_dtype
        self.maze = bool(maze)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PogemaCore(device='cuda') needs a CUDA device; pass device='cpu' to run on the host")

        if grid_config.map is None and grid_config.agents_xy is None:
            expected_free = cfg.size * cfg.size * (1.0 - cfg.density)
            if expected_free < 2.0 * cfg.num_agents:
                warnings.warn(
                    f"config is unlikely to fit {cfg.num_agents} agents+targets: "
                    f"~{expected_free:.0f} free cells expected on a {cfg.size}x{cfg.size} "
                    f"grid at density {cfg.density}; reset() will raise if placement "
                    f"actually fails", stacklevel=2)

        fixed_map = None
        if grid_config.map is not None:
            m = np.asarray(grid_config.map, np.uint8)
            if m.shape != (cfg.size, cfg.size):
                padded = np.ones((cfg.size, cfg.size), np.uint8)
                padded[: m.shape[0], : m.shape[1]] = m
                m = padded
            fixed_map = m
        fixed_agents = (np.asarray(grid_config.agents_xy, np.int32)[: cfg.num_agents]
                        if grid_config.agents_xy is not None else None)
        fixed_targets = (np.asarray(grid_config.targets_xy, np.int32)[: cfg.num_agents]
                         if grid_config.targets_xy is not None else None)
        if fixed_map is not None and fixed_agents is not None:
            # Explicit placements on an explicit map are validated here
            # instead of carving cells free (the reference raises too).
            for label, pts in (("agents_xy", fixed_agents), ("targets_xy", fixed_targets)):
                if (pts < 0).any() or (pts >= cfg.size).any():
                    raise ValueError(f"{label} out of bounds for a {cfg.size}x{cfg.size} "
                                     f"map: {pts.tolist()}")
                on_obst = fixed_map[pts[:, 0], pts[:, 1]] != 0
                if on_obst.any():
                    raise ValueError(f"{label} placed on obstacle cells: {pts[on_obst].tolist()}")
                if len({tuple(p) for p in pts.tolist()}) < len(pts):
                    raise ValueError(f"duplicate cells in {label}: {pts.tolist()}")

        def dev(a):
            return None if a is None else torch.as_tensor(a, device=self.device)

        self._gen_args = (dev(fixed_map), dev(fixed_agents), dev(fixed_targets), self.maze,
                          dev(None if map_bank is None else np.asarray(map_bank, np.uint8)))

    # -- helpers ---------------------------------------------------------

    def _reset_envs(self, keys) -> EnvState:
        return step_mod.reset(self.cfg, keys, *self._gen_args)

    def _cast_obs(self, obs):
        if self.obs_dtype is None or obs is None:
            return obs
        if isinstance(obs, dict):
            return {k: v.to(self.obs_dtype) if v.is_floating_point() else v
                    for k, v in obs.items()}
        return obs.to(self.obs_dtype)

    def _as_actions(self, actions) -> torch.Tensor:
        return torch.as_tensor(actions, device=self.device)

    # -- plain (no auto-reset) -------------------------------------------

    def make_key(self, seed: int) -> torch.Tensor:
        """The key words of ``jax.random.key(seed)`` on this core's device."""
        return jr.key(seed, self.device)

    def reset(self, seed_or_key, with_obs: bool = True):
        """(state, observations) for B envs from one seed or key
        (int64[2]). ``with_obs=False`` returns (state, None).

        Raises ValueError when placement failed for any env after the
        bounded retries (an unplaceable config)."""
        if isinstance(seed_or_key, int):
            key = jr.key(seed_or_key, self.device)
        else:
            key = torch.as_tensor(seed_or_key, device=self.device).to(torch.int64)
        keys = jr.split(key, self.num_envs)
        state = self._reset_envs(keys)
        if not bool(state.placement_ok.all()):
            n_bad = int((~state.placement_ok).sum())
            raise ValueError(
                f"agent/target placement failed for {n_bad}/{self.num_envs} env(s) after "
                f"bounded retries: the map cannot fit {self.cfg.num_agents} agents with "
                f"mutually-reachable targets (need >=2 free cells per agent in shared "
                f"components)")
        obs = self._cast_obs(step_mod.observe_state(self.cfg, state)) if with_obs else None
        return state, obs

    def step(self, state: EnvState, actions):
        """No auto-reset: finished envs keep returning their final state.
        Returns (state, StepResult, done bool[B], metrics dict of f32[B])."""
        new_state, res = step_mod.step(self.cfg, state, self._as_actions(actions))
        res.observations = self._cast_obs(res.observations)
        done = step_mod.episode_done(self.cfg, new_state)
        metrics = metrics_mod.episode_metrics(self.cfg, new_state)
        return new_state, res, done, metrics

    # -- auto-reset --------------------------------------------------------

    def _cached_reset(self, new_state, initial_state, done) -> EnvState:
        invariant = {"obstacles", "placement_ok",
                     "target_queue" if self.cfg.on_target == "restart" else "targets_xy"}
        kw = {}
        for f in FIELDS:
            cur = getattr(new_state, f)
            if f in invariant or cur is None:
                kw[f] = cur
                continue
            fresh = _advance_key(cur) if f == "key" else getattr(initial_state, f)
            kw[f] = _select(done, fresh, cur)
        return EnvState(**kw)

    def _regen_reset(self, new_state, initial_state, done) -> EnvState:
        if not bool(done.any()):
            return new_state
        idx = torch.nonzero(done).flatten()
        keys = _advance_key(new_state.key[idx])
        fresh = self._reset_envs(keys)
        ok = fresh.placement_ok
        kw = {}
        for f in FIELDS:
            cur = getattr(new_state, f)
            if cur is None:
                kw[f] = None
                continue
            fallback = keys if f == "key" else getattr(initial_state, f)[idx]
            cur = cur.clone()
            cur[idx] = _select(ok, getattr(fresh, f), fallback)
            kw[f] = cur
        return EnvState(**kw)

    def step_autoreset(self, state: EnvState, initial_state: EnvState, actions,
                       with_obs: bool = True):
        """Auto-resetting step. ``initial_state`` must be the unmodified
        state that :meth:`reset` returned (pass the same object each
        call): cached mode restores finished envs from it, and takes the
        episode-invariant leaves from the running state. Returns (state,
        obs_after_reset, StepResult, done, metrics); the StepResult holds
        this step's pre-reset rewards, flags and observations, and
        ``obs_after_reset`` is what a learner sees next."""
        cfg = self.cfg
        new_state, res = step_mod.step(cfg, state, self._as_actions(actions), with_obs=False)
        done = step_mod.episode_done(cfg, new_state)
        metrics = metrics_mod.episode_metrics(cfg, new_state)
        if self.auto_reset_mode == "cached":
            reset_state = self._cached_reset(new_state, initial_state, done)
        else:
            reset_state = self._regen_reset(new_state, initial_state, done)
        if not with_obs:
            return reset_state, None, res, done, metrics
        res.observations = self._cast_obs(step_mod.observe_state(cfg, new_state))
        obs = self._cast_obs(step_mod.observe_state(cfg, reset_state))
        return reset_state, obs, res, done, metrics
