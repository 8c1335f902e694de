"""The port's ``step`` against the port's slow NumPy oracle
(``pogema_torch/utils/oracle.py::OracleEnv``) on random actions, for
every collision system x ``on_target``: positions, rewards, terminated and
truncated flags and the observations are equal exactly (integers, 0/1
floats). One case also holds the step to the JAX package's oracle
(``pogema_tpu/utils/oracle.py``); ``tests/test_torch_utils.py`` holds the
two oracles equal. In LifeLong ('restart') the oracle leaves the respawn to its
caller, so the new goals are copied from the port's state after each
step and everything else is still held to the oracle.
"""

import numpy as np
import pytest
import torch

import pogema_tpu
from pogema_torch import GridConfig, PogemaCore
from pogema_torch.utils.oracle import OracleEnv
from pogema_tpu.utils.oracle import OracleEnv as JaxOracleEnv

STEPS, ENVS = 12, 4


@pytest.mark.parametrize("on_target", ["finish", "nothing", "restart"])
@pytest.mark.parametrize("system", ["priority", "block_both", "soft"])
@pytest.mark.parametrize("seed,n", [(0, 5), (7, 2)])
def test_step_matches_oracle(seed, n, system, on_target):
    _run(seed, n, system, on_target, OracleEnv, GridConfig)


def test_step_matches_the_jax_oracle():
    _run(3, 4, "soft", "restart", JaxOracleEnv, pogema_tpu.GridConfig)


def _run(seed, n, system, on_target, oracle_cls, config_cls):
    kw = dict(seed=seed, size=7, density=0.2, num_agents=n, obs_radius=2, max_episode_steps=8,
              collision_system=system, on_target=on_target)
    core = PogemaCore(GridConfig(**kw), num_envs=ENVS, device="cpu")
    ocfg = config_cls(**kw).to_static()
    state, obs = core.reset(seed)
    oracles = [oracle_cls(ocfg, state.obstacles[b].numpy(), state.agents_xy[b].numpy(),
                          state.targets_xy[b].numpy()) for b in range(ENVS)]
    for b, o in enumerate(oracles):
        np.testing.assert_array_equal(obs[b].numpy(), o.observe(), err_msg=f"reset obs, env {b}")
    rng = np.random.default_rng(seed)
    moved = scored = 0
    for t in range(STEPS):
        before = state.agents_xy.clone()
        actions = rng.integers(0, 5, size=(ENVS, n)).astype(np.int32)
        state, res, done, _ = core.step(state, torch.as_tensor(actions))
        moved += int((state.agents_xy != before).any(-1).sum())
        for b, o in enumerate(oracles):
            rew, term, trunc, on_goal = o.step(actions[b])
            where = f"{system}/{on_target} step {t} env {b}"
            assert state.agents_xy[b].tolist() == [list(xy) for xy in o.agents_xy], where
            assert res.rewards[b].tolist() == rew, where
            assert res.terminated[b].tolist() == term, where
            assert res.truncated[b].tolist() == trunc, where
            assert state.active[b].tolist() == o.active, where
            assert state.goals_achieved[b].tolist() == o.goals_achieved, where
            assert int(state.step_count[b]) == o.step_count, where
            scored += sum(on_goal)
            if on_target == "restart":
                o.targets_xy = [tuple(xy) for xy in state.targets_xy[b].tolist()]
            np.testing.assert_array_equal(res.observations[b].numpy(), o.observe(), err_msg=where)
            assert bool(done[b]) == (all(term) or all(trunc)), where
    assert moved > 0
