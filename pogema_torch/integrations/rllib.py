"""RLlib MultiAgentEnv-style adapter (upstream: pogema possibly ships one,
SURVEY.md §2 flags it MED). Implemented dependency-free: matches RLlib's
MultiAgentEnv duck-type (dict-keyed obs/rewards with an ``__all__`` done
key) without importing ray."""

from __future__ import annotations

from ..envs import Pogema


class RLlibPogema:
    def __init__(self, env: Pogema):
        self._env = env
        self._agent_ids = [str(i) for i in range(env.num_agents)]
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, *, seed=None, options=None):
        obs, infos = self._env.reset(seed=seed, options=options)
        return (
            {a: obs[i] for i, a in enumerate(self._agent_ids)},
            {a: infos[i] for i, a in enumerate(self._agent_ids)},
        )

    def step(self, action_dict):
        acts = [int(action_dict.get(a, 0)) for a in self._agent_ids]
        obs, rew, term, trunc, infos = self._env.step(acts)
        obs_d = {a: obs[i] for i, a in enumerate(self._agent_ids)}
        rew_d = {a: rew[i] for i, a in enumerate(self._agent_ids)}
        term_d = {a: term[i] for i, a in enumerate(self._agent_ids)}
        trunc_d = {a: trunc[i] for i, a in enumerate(self._agent_ids)}
        term_d["__all__"] = all(term)
        trunc_d["__all__"] = all(trunc)
        infos_d = {a: infos[i] for i, a in enumerate(self._agent_ids)}
        return obs_d, rew_d, term_d, trunc_d, infos_d
