"""Single-agent Gymnasium adapter: unwraps the per-agent lists when
num_agents == 1 (upstream: pogema's gymnasium single-agent registration,
SURVEY.md §2 "Integration: Gymnasium")."""

from __future__ import annotations

from ..utils.gym_compat import Wrapper


class SingleAgentWrapper(Wrapper):
    def reset(self, **kwargs):
        obs, infos = self.env.reset(**kwargs)
        return obs[0], infos[0]

    def step(self, action):
        obs, rew, term, trunc, infos = self.env.step([action])
        return obs[0], rew[0], term[0], trunc[0], infos[0]
