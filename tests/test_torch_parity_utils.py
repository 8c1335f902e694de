"""The port's host parity generator against pogema_tpu's, and the
port's step against the port's oracle as a hypothesis property (the
counterpart of ``tests/test_parity_and_properties.py``), on the CPU.

``host_generate`` is numpy in both packages: the same config gives the
same map and placements (exact). ``parity_config`` bakes them into a
``GridConfig`` that the port's engine replays. The property test drives
``PogemaCore.step`` and ``utils.oracle.OracleEnv`` with the same states
and actions over random configs: positions, rewards and flags equal.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import pogema_tpu
from pogema_torch import GridConfig, PogemaCore
from pogema_torch.utils.oracle import OracleEnv
from pogema_torch.utils.parity import host_generate, parity_config
from pogema_tpu.utils.parity import host_generate as jax_host_generate


@pytest.mark.parametrize("seed,size,density,n", [(11, 10, 0.3, 4), (3, 8, 0.25, 3),
                                                 (0, 16, 0.35, 12), (42, 6, 0.1, 2)])
def test_host_generate_equals_the_jax_one(seed, size, density, n):
    kw = dict(seed=seed, size=size, density=density, num_agents=n)
    got = host_generate(GridConfig(**kw))
    assert got == jax_host_generate(pogema_tpu.GridConfig(**kw))
    assert got == host_generate(GridConfig(**kw))  # the same seed, the same draw
    grid = np.asarray(got[0])
    for (ax, ay), (tx, ty) in zip(got[1], got[2]):
        assert grid[ax, ay] == 0 and grid[tx, ty] == 0 and [ax, ay] != [tx, ty]


def test_host_generate_raises_when_nothing_fits():
    with pytest.raises(RuntimeError, match="could not place"):
        host_generate(GridConfig(seed=0, size=4, density=0.9, num_agents=8), max_retries=3)


def test_parity_config_replays_in_engine():
    cfg = parity_config(GridConfig(seed=3, size=8, density=0.25, num_agents=3, obs_radius=2,
                                   max_episode_steps=8))
    core = PogemaCore(cfg, num_envs=1, device="cpu")
    state, obs = core.reset(0)
    r = core.cfg.obs_radius
    assert state.agents_xy[0].tolist() == [[x + r, y + r] for x, y in cfg.agents_xy]
    assert state.targets_xy[0].tolist() == [[x + r, y + r] for x, y in cfg.targets_xy]
    inner = state.obstacles[0, r:-r, r:-r].numpy()
    assert inner.astype(int).tolist() == cfg.map


@settings(max_examples=15, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    n=st.integers(1, 6),
    system=st.sampled_from(["priority", "block_both", "soft"]),
    on_target=st.sampled_from(["finish", "nothing"]),
)
def test_property_step_matches_oracle(seed, n, system, on_target):
    cfg_m = GridConfig(seed=seed, size=7, density=0.2, num_agents=n, obs_radius=2,
                       max_episode_steps=6, collision_system=system, on_target=on_target)
    core = PogemaCore(cfg_m, num_envs=1, device="cpu")
    state, obs = core.reset(seed)
    oracle = OracleEnv(core.cfg, state.obstacles[0].numpy(), state.agents_xy[0].numpy(),
                       state.targets_xy[0].numpy())
    np.testing.assert_array_equal(obs[0].numpy(), oracle.observe())
    rng = np.random.default_rng(seed)
    for _ in range(6):
        actions = rng.integers(0, 5, size=(1, n))
        state, res, done, _ = core.step(state, torch.as_tensor(actions, dtype=torch.int32))
        rew, term, trunc, _ = oracle.step(actions[0])
        assert state.agents_xy[0].tolist() == [list(t) for t in oracle.agents_xy]
        assert res.rewards[0].tolist() == rew
        assert res.terminated[0].tolist() == term
        assert res.truncated[0].tolist() == trunc
        np.testing.assert_array_equal(res.observations[0].numpy(), oracle.observe())
