"""The port's framework adapters against ``pogema_tpu``'s on the CPU:
PettingZoo (its own ``parallel_api_test`` too), PyMARL, SampleFactory
(single env and batched), RLlib and single-agent Gymnasium, each step for
step equal to the JAX adapter, and the runner call sequences of
``tests/test_framework_harness.py`` on the port."""

import numpy as np
import pytest

import pogema_torch
import pogema_tpu
from test_framework_harness import MiniPyMarlRunner, MiniSampleFactoryRunner
from torch_parity import assert_host_equal

BASE = dict(size=8, density=0.2, num_agents=3, obs_radius=2, max_episode_steps=8)


def _pair(**kw):
    return (pogema_tpu.pogema_v0(pogema_tpu.GridConfig(**kw)),
            pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw), device="cpu"))


def test_pettingzoo_api_compliance():
    from pettingzoo.test import parallel_api_test

    env = pogema_torch.pogema_v0(pogema_torch.GridConfig(**dict(BASE, integration="PettingZoo")),
                                 device="cpu")
    parallel_api_test(env, num_cycles=30)


def test_pettingzoo_equal():
    je, te = _pair(**dict(BASE, seed=3, integration="PettingZoo"))
    assert te.possible_agents == je.possible_agents
    assert te.observation_space("agent_0") == je.observation_space("agent_0")
    assert_host_equal(je.reset(seed=4), te.reset(seed=4))
    rng = np.random.default_rng(0)
    while te.agents:
        acts = {a: int(rng.integers(0, 5)) for a in te.agents}
        assert_host_equal(je.step(acts), te.step(acts))
        assert te.agents == je.agents


def test_pymarl_equal():
    je, te = _pair(**dict(BASE, seed=4, integration="PyMARL"))
    assert te.get_env_info() == je.get_env_info()  # before the first reset
    assert_host_equal(je.reset(), te.reset())
    rng = np.random.default_rng(1)
    for _ in range(BASE["max_episode_steps"]):
        a = rng.integers(0, 5, size=3).tolist()
        assert_host_equal(je.step(a), te.step(a))
        assert_host_equal(je.get_obs(), te.get_obs())
        assert_host_equal(je.get_state(), te.get_state())
        assert_host_equal(je.get_obs_agent(1), te.get_obs_agent(1))
    assert te.get_avail_actions() == je.get_avail_actions()
    assert te.get_avail_agent_actions(0) == [1] * 5


def test_pymarl_call_sequence():
    env = pogema_torch.pogema_v0(pogema_torch.GridConfig(
        seed=4, size=8, density=0.2, num_agents=3, obs_radius=2, max_episode_steps=10,
        integration="PyMARL"), device="cpu")
    runner = MiniPyMarlRunner(env)
    for ep in range(3):
        t, ret = runner.run_episode(seed=ep)
        assert 1 <= t <= 10 and ret >= 0.0


@pytest.mark.parametrize("on_target", ["finish", "restart"])
def test_sample_factory_equal(on_target):
    je, te = _pair(**dict(BASE, seed=3, on_target=on_target, integration="SampleFactory"))
    assert te.is_multiagent and te.num_agents == 3
    assert_host_equal(je.reset(), te.reset())
    rng = np.random.default_rng(2)
    stats = 0
    for _ in range(20):  # through two auto-resets
        a = rng.integers(0, 5, size=3).tolist()
        j, t = je.step(a), te.step(a)
        assert_host_equal(j, t)
        stats += "episode_extra_stats" in t[4][0]
    assert stats == 2


def test_sample_factory_call_sequence():
    env = pogema_torch.pogema_v0(pogema_torch.GridConfig(
        seed=3, size=8, density=0.2, num_agents=3, obs_radius=2, max_episode_steps=8,
        integration="SampleFactory"), device="cpu")
    episodes, stats = MiniSampleFactoryRunner(env).run(total_steps=40)
    assert episodes >= 4
    for extra in stats:
        assert {"ISR", "CSR", "ep_length"} <= set(extra)


@pytest.mark.parametrize("layout,observation_type", [("packed", "default"), ("grid", "POMAPF")])
def test_sample_factory_batched_equal(layout, observation_type):
    from pogema_torch.integrations.sample_factory import SampleFactoryBatchedEnv as TEnv
    from pogema_tpu.integrations.sample_factory import SampleFactoryBatchedEnv as JEnv

    kw = dict(BASE, observation_type=observation_type)
    je = JEnv(pogema_tpu.GridConfig(**kw), num_vec_envs=2, obs_layout=layout)
    te = TEnv(pogema_torch.GridConfig(**kw), num_vec_envs=2, obs_layout=layout, device="cpu")
    assert te.is_multiagent and te.num_agents == je.num_agents == 6
    assert te.observation_space == je.observation_space
    assert_host_equal(je.reset(seed=5), te.reset(seed=5))
    rng = np.random.default_rng(0)
    stats = 0
    for _ in range(BASE["max_episode_steps"] + 2):
        a = rng.integers(0, 5, size=6)
        j, t = je.step(a), te.step(a)
        assert_host_equal(j, t)
        stats += sum("episode_extra_stats" in i for i in t[4])
    assert stats >= 3


def test_rllib_equal():
    je, te = _pair(**dict(BASE, seed=6, integration="rllib"))
    assert te.observation_space == je.observation_space and te.action_space == je.action_space
    assert_host_equal(je.reset(), te.reset())
    rng = np.random.default_rng(3)
    for _ in range(BASE["max_episode_steps"]):
        a = {str(i): int(rng.integers(0, 5)) for i in range(3)}
        j, t = je.step(a), te.step(a)
        assert_host_equal(j, t)
    assert t[3]["__all__"]


def test_single_agent_equal():
    je, te = _pair(seed=0, size=6, num_agents=1, obs_radius=2, max_episode_steps=8,
                   integration="gymnasium")
    assert type(te).__name__ == "SingleAgentWrapper"
    assert_host_equal(je.reset(), te.reset())
    for a in (0, 1, 2, 3, 4, 1, 1, 3):
        j, t = je.step(a), te.step(a)
        assert_host_equal(j, t)
    assert t[3] is True
    multi = pogema_torch.pogema_v0(pogema_torch.GridConfig(**dict(BASE, integration="gymnasium")),
                                   device="cpu")
    assert isinstance(multi, pogema_torch.Pogema)
