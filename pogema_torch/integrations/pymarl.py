"""PyMARL (SMAC-style) adapter for QMIX-family codebases (upstream:
pogema/integrations/pymarl.py, SURVEY.md §2 "Integration: PyMARL"):
``get_obs/get_obs_agent/get_obs_size/get_state/get_state_size/
get_avail_actions/step(actions) -> (team_reward, done, info)``."""

from __future__ import annotations

import numpy as np

from ..envs import Pogema
from ..grid_config import NUM_ACTIONS


class PyMarlPogema:
    def __init__(self, env: Pogema):
        self._env = env
        self.n_agents = env.num_agents
        self.n_actions = NUM_ACTIONS
        self.episode_limit = env.grid_config.max_episode_steps
        self._obs = None
        self._last_infos = None

    def reset(self):
        self._obs, self._last_infos = self._env.reset()
        return self.get_obs(), self.get_state()

    def _ensure_started(self):
        # PyMARL queries get_env_info()/get_state() BEFORE the first
        # reset() (runners build networks from the shapes first).
        if self._obs is None:
            self.reset()

    def step(self, actions):
        obs, rewards, terminated, truncated, infos = self._env.step(
            [int(a) for a in actions]
        )
        self._obs = obs
        self._last_infos = infos
        done = all(t or tr for t, tr in zip(terminated, truncated))
        info = dict(infos[0]) if infos else {}
        return float(np.sum(rewards)), bool(done), info

    def get_obs(self):
        self._ensure_started()
        return [np.asarray(o, np.float32).reshape(-1) for o in self._obs]

    def get_obs_agent(self, agent_id: int):
        return np.asarray(self._obs[agent_id], np.float32).reshape(-1)

    def get_obs_size(self) -> int:
        return int(self.get_obs_agent(0).size)

    def get_state(self):
        self._ensure_started()
        return self._env.get_state().astype(np.float32)

    def get_state_size(self) -> int:
        return int(self.get_state().size)

    def get_avail_actions(self):
        return [[1] * self.n_actions for _ in range(self.n_agents)]

    def get_avail_agent_actions(self, agent_id: int):
        return [1] * self.n_actions

    def get_env_info(self):
        return {
            "state_shape": self.get_state_size(),
            "obs_shape": self.get_obs_size(),
            "n_actions": self.n_actions,
            "n_agents": self.n_agents,
            "episode_limit": self.episode_limit,
        }

    def render(self):
        return self._env.render()

    def close(self):
        pass

    def save_replay(self):
        pass
