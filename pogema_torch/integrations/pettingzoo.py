"""PettingZoo ParallelEnv adapter (upstream: pogema/integrations/
pettingzoo.py, SURVEY.md §2): string agent ids, per-agent dict-keyed
spaces and step/reset dicts."""

from __future__ import annotations

import functools

from pettingzoo import ParallelEnv

from ..envs import Pogema


def parallel_env(env: Pogema) -> "PogemaParallelEnv":
    return PogemaParallelEnv(env)


class PogemaParallelEnv(ParallelEnv):
    metadata = {"render_modes": ["ansi"], "name": "pogema_torch"}

    def __init__(self, env: Pogema):
        self._env = env
        n = env.num_agents
        self.possible_agents = [f"agent_{i}" for i in range(n)]
        self.agents = list(self.possible_agents)

    @functools.lru_cache(maxsize=None)
    def observation_space(self, agent):
        return self._env.observation_space

    @functools.lru_cache(maxsize=None)
    def action_space(self, agent):
        return self._env.action_space

    def reset(self, seed=None, options=None):
        obs, infos = self._env.reset(seed=seed, options=options)
        self.agents = list(self.possible_agents)
        return (
            {a: obs[i] for i, a in enumerate(self.agents)},
            {a: infos[i] for i, a in enumerate(self.agents)},
        )

    def step(self, actions: dict):
        acts = [int(actions.get(a, 0)) for a in self.possible_agents]
        obs, rew, term, trunc, infos = self._env.step(acts)
        names = list(self.agents)
        out = tuple(
            {a: seq[self.possible_agents.index(a)] for a in names}
            for seq in (obs, rew, term, trunc, infos)
        )
        # PettingZoo convention: drop agents whose episode ended.
        self.agents = [
            a
            for a in names
            if not (
                term[self.possible_agents.index(a)]
                or trunc[self.possible_agents.index(a)]
            )
        ]
        return out

    def render(self):
        return self._env.render()

    def close(self):
        pass
