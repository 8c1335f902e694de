"""The user-facing envs of the port: ``Pogema``, ``PogemaLifeLong``,
``PogemaCoopFinish`` and the ``pogema_v0`` factory (upstream:
pogema/envs.py), counterparts of ``pogema_tpu/envs.py``.

A ``Pogema`` is a B = 1 slice of :class:`pogema_torch.core.PogemaCore`:
per-agent lists in and out (the Gymnasium multi-agent convention), numpy
at the edge, tensors on ``device`` inside (the card unless the caller
asks for the CPU). The core holds every rule (collisions, rewards,
termination, truncation, metrics); this layer seeds episodes, copies
results to the host, assembles info and metrics dicts and renders.

A step copies what it returns (observations, rewards, flags, the done
flag and the metrics) to the host with one wait for the device
(:func:`pogema_torch.utils.host.fetch`). The accessors read one host
copy of the agents, targets and grid, made once per state.
"""

from __future__ import annotations

import random as _pyrandom
from typing import Optional

import numpy as np

from .core import random as jr
from .core.api import PogemaCore
from .grid_config import NUM_ACTIONS, GridConfig
from .utils.gym_compat import Env, spaces
from .utils.host import fetch


class ActionsSampler:
    """Uniform random action sampler with its own RNG."""

    def __init__(self, num_actions: int = NUM_ACTIONS, seed: Optional[int] = None):
        self._num_actions = num_actions
        self._rng = np.random.default_rng(seed)

    def sample_actions(self, dim: int = 1):
        return self._rng.integers(self._num_actions, size=dim).tolist()


def _observation_space(cfg):
    """The per-agent space of the reference (None without gymnasium)."""
    if spaces is None:
        return None
    w = cfg.window
    if cfg.observation_type == "default":
        return spaces.Box(0.0, 1.0, shape=(3, w, w))
    d = {
        "obstacles": spaces.Box(0.0, 1.0, shape=(w, w)),
        "agents": spaces.Box(0.0, 1.0, shape=(w, w)),
        "xy": spaces.Box(-1024, 1024, shape=(2,), dtype=int),
        "target_xy": spaces.Box(-1024, 1024, shape=(2,), dtype=int),
    }
    if cfg.observation_type == "MAPF":
        s, n = cfg.size, cfg.num_agents
        d["global_obstacles"] = spaces.Box(0.0, 1.0, shape=(s, s))
        d["global_xy"] = spaces.Box(-1024, 1024, shape=(n, 2), dtype=int)
        d["global_target_xy"] = spaces.Box(-1024, 1024, shape=(n, 2), dtype=int)
    return spaces.Dict(d)


class Pogema(Env):
    """Multi-agent grid env, Gymnasium 5-tuple convention with per-agent
    lists (upstream: pogema/envs.py Pogema). ``device``: where the core
    runs; "cuda" (the default) raises without a card."""

    metadata = {"render_modes": ["ansi"]}

    def __init__(self, grid_config: Optional[GridConfig] = None, device="cuda", **kwargs):
        if grid_config is None:
            grid_config = GridConfig(**kwargs)
        self.grid_config = grid_config
        self._core = PogemaCore(grid_config, num_envs=1, device=device)
        self._cfg = self._core.cfg
        self.device = self._core.device
        self._state = None
        self._host = None
        self._episode = 0
        self._base_seed = (grid_config.seed if grid_config.seed is not None
                           else _pyrandom.randint(0, 2**31 - 1))
        self._fresh_each_reset = grid_config.seed is None
        self.action_space = None if spaces is None else spaces.Discrete(NUM_ACTIONS)
        self.observation_space = _observation_space(self._cfg)

    # -- properties mirroring the reference surface ----------------------

    @property
    def num_agents(self) -> int:
        return self._cfg.num_agents

    def get_num_agents(self) -> int:
        return self.num_agents

    @property
    def is_multiagent(self) -> bool:
        return True

    # -- seeding ---------------------------------------------------------

    def _episode_key(self):
        base = self._core.make_key(self._base_seed)
        return jr.fold_in(base, self._episode) if self._fresh_each_reset else base

    # -- gym API ---------------------------------------------------------

    def _set_state(self, state):
        self._state, self._host = state, None

    def reset(self, seed: Optional[int] = None, options=None, **kwargs):
        if seed is not None:
            self._base_seed = seed
            self._fresh_each_reset = False
        state, obs = self._core.reset(self._episode_key())
        self._set_state(state)
        self._episode += 1
        return self._split_obs(fetch(obs)), self._fresh_infos()

    def step(self, actions):
        acts = np.asarray(actions, np.int32)[None, :]
        state, res, done, mets = self._core.step(self._state, acts)
        self._set_state(state)
        obs, rew, term, trunc, done, mets = fetch(
            (res.observations, res.rewards, res.terminated, res.truncated, done, mets))
        infos = self._fresh_infos()
        if bool(done[0]):
            metrics = {k: float(v[0]) for k, v in mets.items()}
            for info in infos:
                info["metrics"] = dict(metrics)
        return (self._split_obs(obs), rew[0].astype(float).tolist(),
                term[0].astype(bool).tolist(), trunc[0].astype(bool).tolist(), infos)

    def _fresh_infos(self):
        return [{} for _ in range(self.num_agents)]

    def _split_obs(self, obs):
        """Host observations of the one env as a per-agent list."""
        if self._cfg.observation_type == "default":
            arr = obs[0]
            return [arr[i] for i in range(self.num_agents)]
        host = {k: v[0] for k, v in obs.items()}
        out = []
        for i in range(self.num_agents):
            d = {k: host[k][i] for k in ("obstacles", "agents", "xy", "target_xy")}
            if self._cfg.observation_type == "MAPF":
                for k in ("global_obstacles", "global_xy", "global_target_xy"):
                    d[k] = host[k]
            out.append(d)
        return out

    # -- reference Grid accessors (upstream: pogema/grid.py) -------------

    def _host_state(self) -> dict:
        """Host copies of the state's grid, agents, targets and active
        mask (env 0), fetched together once per state."""
        if self._host is None:
            st = self._state
            self._host = fetch({"obstacles": st.obstacles[0], "agents_xy": st.agents_xy[0],
                                "targets_xy": st.targets_xy[0], "active": st.active[0]})
        return self._host

    def get_obstacles(self, ignore_borders: bool = True):
        g = self._host_state()["obstacles"]
        if ignore_borders:
            r = self._cfg.obs_radius
            g = g[r:-r, r:-r]
        return g.copy()

    def _coords(self, field, only_active, ignore_borders):
        host = self._host_state()
        xy = host[field]
        if ignore_borders:
            xy = xy - self._cfg.obs_radius
        out = [tuple(map(int, p)) for p in xy]
        if only_active:
            out = [p for p, a in zip(out, host["active"]) if a]
        return out

    def get_agents_xy(self, only_active: bool = False, ignore_borders: bool = True):
        return self._coords("agents_xy", only_active, ignore_borders)

    def get_targets_xy(self, only_active: bool = False, ignore_borders: bool = True):
        return self._coords("targets_xy", only_active, ignore_borders)

    def get_lifelong_targets_xy(self, ignore_borders: bool = True):
        return self.get_targets_xy(ignore_borders=ignore_borders)

    def has_obstacle(self, x: int, y: int, ignore_borders: bool = True) -> bool:
        """True iff cell (x, y) is an obstacle (upstream: Grid.has_obstacle).
        Coordinates follow :meth:`get_obstacles`: logical map coordinates
        with ``ignore_borders=True`` (the default), padded ones otherwise.
        A cell outside the grid raises IndexError in either direction."""
        if ignore_borders:
            r = self._cfg.obs_radius
            x, y = x + r, y + r
        grid = self._host_state()["obstacles"]
        if not (0 <= x < grid.shape[0] and 0 <= y < grid.shape[1]):
            raise IndexError(f"cell ({x}, {y}) outside the "
                             f"{'padded ' if not ignore_borders else ''}grid {grid.shape}")
        return bool(grid[x, y])

    def hide_agent(self, agent_idx: int) -> bool:
        """Deactivate one agent: it vanishes from other agents' windows and
        no longer moves or blocks (upstream: Grid.hide_agent). False for an
        index out of range."""
        return self._set_agent_visibility(agent_idx, False)

    def show_agent(self, agent_idx: int) -> bool:
        """Re-activate an agent hidden with :meth:`hide_agent`."""
        return self._set_agent_visibility(agent_idx, True)

    def _set_agent_visibility(self, agent_idx: int, value: bool) -> bool:
        if not 0 <= agent_idx < self.num_agents:
            return False
        active = self._state.active.clone()
        active[0, agent_idx] = value
        self._set_state(self._state.replace(active=active))
        return True

    def get_state(self):
        """Flat global state vector (used by the PyMARL integration)."""
        host = self._host_state()
        r = self._cfg.obs_radius
        return np.concatenate([
            self.get_obstacles().astype(np.float32).reshape(-1),
            (host["agents_xy"] - r).astype(np.float32).reshape(-1),
            (host["targets_xy"] - r).astype(np.float32).reshape(-1),
            host["active"].astype(np.float32)])

    @property
    def active(self):
        return {i: bool(a) for i, a in enumerate(self._host_state()["active"])}

    # -- rendering -------------------------------------------------------

    def render(self):
        """ANSI render like the reference's console output: obstacles '#',
        free '.', agents as capitals, their targets in lower case."""
        from .utils.render import render_ansi

        out = render_ansi(self.get_obstacles(), self.get_agents_xy(), self.get_targets_xy(),
                          [bool(a) for a in self._host_state()["active"]])
        print(out)
        return out


class PogemaLifeLong(Pogema):
    """LifeLong MAPF: reached goals respawn (upstream: pogema/envs.py)."""

    def __init__(self, grid_config: Optional[GridConfig] = None, device="cuda", **kwargs):
        if grid_config is None:
            grid_config = GridConfig(**kwargs)
        if grid_config.on_target != "restart":
            grid_config = grid_config.model_copy(update={"on_target": "restart"})
        super().__init__(grid_config, device=device)


class PogemaCoopFinish(Pogema):
    """Cooperative-finish MAPF: success = all agents on goals at once
    (upstream: pogema/envs.py, on_target='nothing')."""

    def __init__(self, grid_config: Optional[GridConfig] = None, device="cuda", **kwargs):
        if grid_config is None:
            grid_config = GridConfig(**kwargs)
        if grid_config.on_target != "nothing":
            grid_config = grid_config.model_copy(update={"on_target": "nothing"})
        super().__init__(grid_config, device=device)


def _make_pogema(grid_config: GridConfig, device="cuda") -> Pogema:
    if grid_config.on_target == "restart":
        return PogemaLifeLong(grid_config, device=device)
    if grid_config.on_target == "nothing":
        return PogemaCoopFinish(grid_config, device=device)
    return Pogema(grid_config, device=device)


def _make_pogema_gym_entry(grid_config: Optional[GridConfig] = None, device="cuda", **kwargs):
    """``gymnasium.make('PogemaTorch-v0', grid_config=..., device=...)``."""
    if grid_config is None:
        grid_config = GridConfig(**kwargs)
    return pogema_v0(grid_config, device=device)


def pogema_v0(grid_config: Optional[GridConfig] = None, device="cuda", **kwargs):
    """The reference's single entry point (upstream: pogema/envs.py
    pogema_v0): the env for ``grid_config.on_target``, wrapped for
    ``grid_config.integration``. ``device``: "cuda" (the default) or
    "cpu"."""
    if grid_config is None:
        grid_config = GridConfig(**kwargs)
    env = _make_pogema(grid_config, device=device)
    if grid_config.persistent:
        from .wrappers.persistence import PersistentWrapper

        env = PersistentWrapper(env)
    integration = grid_config.integration
    auto_reset = grid_config.auto_reset
    if auto_reset and integration not in (None, "gymnasium", "SampleFactory"):
        raise ValueError(f"auto_reset=True is not supported with integration={integration!r}: "
                         "that adapter owns the reset cycle (PARITY_RISKS.md row 15)")
    if auto_reset:
        # Episode auto-reset on the lists rim, before any adapter.
        from .integrations.sample_factory import AutoResetWrapper

        env = AutoResetWrapper(env)
    if integration is None:
        return env
    if integration == "gymnasium":
        from .integrations.single_agent import SingleAgentWrapper

        return SingleAgentWrapper(env) if grid_config.num_agents == 1 else env
    if integration == "PettingZoo":
        from .integrations.pettingzoo import parallel_env

        return parallel_env(env)
    if integration == "PyMARL":
        from .integrations.pymarl import PyMarlPogema

        return PyMarlPogema(env)
    if integration == "SampleFactory":
        from .integrations.sample_factory import (AutoResetWrapper, IsMultiAgentWrapper,
                                                  MetricsForwardingWrapper)

        env = MetricsForwardingWrapper(IsMultiAgentWrapper(env))
        # SampleFactory's contract wants auto-reset by default;
        # auto_reset=False opts out, auto_reset=True already wrapped above.
        if auto_reset is None:
            env = AutoResetWrapper(env)
        return env
    if integration == "rllib":
        from .integrations.rllib import RLlibPogema

        return RLlibPogema(env)
    raise ValueError(f"unknown integration {integration!r}")
