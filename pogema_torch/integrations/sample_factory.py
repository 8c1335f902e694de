"""SampleFactory adapter (upstream: pogema/integrations/sample_factory.py):
auto-reset on episode end, multi-agent flags, metric forwarding into the
terminal info dicts; and :class:`SampleFactoryBatchedEnv`, B envs per
call. Counterpart of ``pogema_tpu/integrations/sample_factory.py``."""

from __future__ import annotations

import numpy as np

from ..utils.gym_compat import Env, Wrapper


class _ForwardFlags(Wrapper):
    """gymnasium 1.x wrappers no longer forward attributes; expose the
    flags SampleFactory sniffs for explicitly at every layer."""

    @property
    def is_multiagent(self):
        return getattr(self.env, "is_multiagent", True)

    @property
    def num_agents(self):
        return self.env.num_agents


class IsMultiAgentWrapper(_ForwardFlags):
    is_multiagent = True


class MetricsForwardingWrapper(_ForwardFlags):
    """Copies episode-end metrics into ``info['episode_extra_stats']``
    (SampleFactory's stats channel)."""

    def step(self, actions):
        obs, rew, term, trunc, infos = self.env.step(actions)
        for info in infos:
            if "metrics" in info:
                info.setdefault("episode_extra_stats", {}).update(info["metrics"])
        return obs, rew, term, trunc, infos


class AutoResetWrapper(_ForwardFlags):
    """Resets on episode end and returns the first observations of the new
    episode, per SampleFactory's contract."""

    def step(self, actions):
        obs, rew, term, trunc, infos = self.env.step(actions)
        if all(t or tr for t, tr in zip(term, trunc)):
            obs, _ = self.env.reset()
        return obs, rew, term, trunc, infos


class SampleFactoryBatchedEnv(Env):
    """B envs × N agents behind SampleFactory's multi-agent contract
    (``is_multiagent=True``, ``num_agents = B*N``, lists in and out,
    auto-reset inside step, metrics in ``episode_extra_stats``), over
    :class:`~pogema_torch.integrations.vector.PogemaVectorEnv`: every
    step advances all B envs on ``device`` at once. ``obs_layout='packed'``
    gives flat ``[3*W*W]`` per-agent observations (one K1b launch per
    observation set on the card)."""

    is_multiagent = True

    def __init__(self, grid_config=None, num_vec_envs: int = 64, obs_layout: str = "grid",
                 obs_dtype=None, auto_reset_mode: str = "cached", device="cuda", **kwargs):
        from .vector import PogemaVectorEnv

        self._vec = PogemaVectorEnv(grid_config, num_vec_envs=num_vec_envs, obs_layout=obs_layout,
                                    obs_dtype=obs_dtype, auto_reset_mode=auto_reset_mode,
                                    device=device, **kwargs)
        self.grid_config = self._vec.grid_config
        self.num_agents = self._vec.num_envs  # B*N agent slots
        self.observation_space = self._vec.single_observation_space
        self.action_space = self._vec.single_action_space

    def _split(self, obs):
        """[B*N, ...] array -> per-agent list; dict obs (POMAPF) -> list
        of per-agent dicts."""
        if isinstance(obs, dict):
            return [{k: v[i] for k, v in obs.items()} for i in range(self.num_agents)]
        return list(obs)

    def reset(self, seed=None, options=None, **kwargs):
        obs, _ = self._vec.reset(seed=seed, options=options)
        return self._split(obs), [{} for _ in range(self.num_agents)]

    def step(self, actions):
        obs, rew, term, trunc, infos = self._vec.step(actions)
        out_infos = [{} for _ in range(self.num_agents)]
        if "_metrics" in infos:
            mask = infos["_metrics"]
            keys = [k for k in infos if k.startswith("metrics/")]
            for i in np.nonzero(mask)[0]:
                out_infos[i]["episode_extra_stats"] = {
                    k.split("/", 1)[1]: float(infos[k][i]) for k in keys}
        return self._split(obs), rew.tolist(), term.tolist(), trunc.tolist(), out_infos
