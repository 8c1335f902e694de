"""Multi-agent time limit (upstream: pogema/wrappers/multi_time_limit.py,
SURVEY.md §2 "Time limit wrapper"): at step ``max_episode_steps`` every
agent's truncated flag becomes True."""

from __future__ import annotations

from ..utils.gym_compat import Wrapper


class MultiTimeLimit(Wrapper):
    def __init__(self, env, max_episode_steps: int):
        super().__init__(env)
        self._max_episode_steps = int(max_episode_steps)
        self._elapsed_steps = None

    def reset(self, **kwargs):
        self._elapsed_steps = 0
        return self.env.reset(**kwargs)

    def step(self, actions):
        assert self._elapsed_steps is not None, "reset() before step()"
        obs, rewards, terminated, truncated, infos = self.env.step(actions)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self._max_episode_steps:
            truncated = [True] * len(truncated)
        return obs, rewards, terminated, truncated, infos
