"""The port's ``PogemaVectorEnv`` on the CPU: bit-equal to ``pogema_tpu``'s
over 32 steps (packed, grid and POMAPF; cached and regen; bf16 on the
wire), and the checks of ``tests/test_vector_env.py`` on the port: spaces,
the packed layout as a reshape of the grid, equality with the port's
``PogemaCore``, SAME_STEP ``final_obs``, the LifeLong metrics key,
reset-seed reproducibility, MAPF refused, POMAPF dicts, tensor actions,
and the SampleFactory batched adapter."""

import numpy as np
import pytest
import torch

import pogema_torch
import pogema_tpu
from pogema_torch import GridConfig, PogemaCore, PogemaVectorEnv
from torch_parity import assert_host_equal

CFG = dict(seed=7, size=8, density=0.2, num_agents=3, obs_radius=2, max_episode_steps=16)


def _env(num_vec_envs=4, **kw):
    return PogemaVectorEnv(GridConfig(**{**CFG, **kw.pop("grid", {})}), num_vec_envs=num_vec_envs,
                           device="cpu", **kw)


@pytest.mark.parametrize("layout,observation_type,mode", [
    ("packed", "default", "cached"), ("packed", "default", "regen"),
    ("grid", "default", "cached"), ("grid", "POMAPF", "regen")])
def test_bit_equal_to_jax(layout, observation_type, mode):
    """32 steps of both adapters from the same seed and actions: two
    episodes of every env, so the SAME_STEP resets, final_obs and
    metrics of both auto-reset modes are compared."""
    kw = dict(CFG, observation_type=observation_type, on_target="finish")
    je = pogema_tpu.PogemaVectorEnv(pogema_tpu.GridConfig(**kw), num_vec_envs=4,
                                    obs_layout=layout, auto_reset_mode=mode)
    te = PogemaVectorEnv(GridConfig(**kw), num_vec_envs=4, obs_layout=layout,
                         auto_reset_mode=mode, device="cpu")
    assert te.single_observation_space == je.single_observation_space
    assert te.observation_space == je.observation_space
    assert te.action_space == je.action_space
    assert_host_equal(je.reset(seed=3), te.reset(seed=3), "reset")
    rng = np.random.default_rng(1)
    ended = 0
    for t in range(32):
        a = rng.integers(0, 5, size=te.num_envs)
        j, got = je.step(a), te.step(a)
        assert_host_equal(j, got, f"step {t}")
        ended += int(got[4].get("_final_obs", np.zeros(1, bool)).sum())
    assert ended >= 2 * te.num_envs
    # a second reset folds the episode index into the key, as in JAX
    assert_host_equal(je.reset(), te.reset(), "second reset")


def test_bf16_on_the_wire_float32_at_the_edge():
    kw = dict(CFG, on_target="restart")
    import jax.numpy as jnp

    je = pogema_tpu.PogemaVectorEnv(pogema_tpu.GridConfig(**kw), num_vec_envs=3,
                                    obs_layout="packed", obs_dtype=jnp.bfloat16)
    te = PogemaVectorEnv(GridConfig(**kw), num_vec_envs=3, obs_layout="packed",
                         obs_dtype=torch.bfloat16, device="cpu")
    assert te._core.obs_dtype == torch.bfloat16
    assert te.single_observation_space.dtype == np.float32
    assert_host_equal(je.reset(), te.reset())
    rng = np.random.default_rng(2)
    for t in range(CFG["max_episode_steps"]):  # the last step ends every episode
        a = rng.integers(0, 5, size=te.num_envs)
        j, got = je.step(a), te.step(a)
        assert_host_equal(j, got, f"step {t}")
    assert got[0].dtype == np.float32 and "metrics/avg_throughput" in j[4]


def test_spaces_and_shapes():
    env = _env()
    w = 2 * CFG["obs_radius"] + 1
    assert env.num_envs == 4 * CFG["num_agents"]
    assert env.single_observation_space.shape == (3, w, w)
    assert env.single_action_space.n == 5
    assert env.metadata["autoreset_mode"].value == "SameStep"
    obs, infos = env.reset()
    assert obs.shape == (env.num_envs, 3, w, w) and obs.dtype == np.float32
    obs, rew, term, trunc, infos = env.step(np.zeros(env.num_envs, np.int64))
    assert obs.shape == (env.num_envs, 3, w, w)
    for a in (rew, term, trunc):
        assert a.shape == (env.num_envs,)
    assert rew.dtype == np.float32 and term.dtype == bool and trunc.dtype == bool


def test_packed_layout_is_bit_exact_reshape():
    grid, packed = _env(), _env(obs_layout="packed")
    w = 2 * CFG["obs_radius"] + 1
    assert packed.single_observation_space.shape == (3 * w * w,)
    og, _ = grid.reset()
    op, _ = packed.reset()
    np.testing.assert_array_equal(og.reshape(op.shape), op)
    rng = np.random.default_rng(3)
    for _ in range(8):
        acts = rng.integers(0, 5, size=grid.num_envs)
        np.testing.assert_array_equal(grid.step(acts)[0].reshape(op.shape), packed.step(acts)[0])


def test_matches_pogema_core_and_takes_tensor_actions():
    b = 4
    env = _env(b)
    core = PogemaCore(GridConfig(**CFG), num_envs=b, device="cpu")
    state, obs_c = core.reset(core.make_key(CFG["seed"]))
    init = state
    obs_v, _ = env.reset()
    np.testing.assert_array_equal(obs_v, obs_c.numpy().reshape(obs_v.shape))
    rng = np.random.default_rng(0)
    for t in range(20):
        acts = rng.integers(0, 5, size=env.num_envs)
        # tensors are taken as they are, numpy and lists are converted
        given = torch.as_tensor(acts) if t % 2 else acts.tolist()
        obs_v, rew_v, term_v, _, _ = env.step(given)
        state, obs_c, res, _, _ = core.step_autoreset(state, init,
                                                      torch.as_tensor(acts.reshape(b, -1)))
        np.testing.assert_array_equal(obs_v, obs_c.numpy().reshape(obs_v.shape))
        np.testing.assert_array_equal(rew_v, res.rewards.numpy().reshape(-1))
        np.testing.assert_array_equal(term_v, res.terminated.numpy().reshape(-1))


def test_same_step_autoreset_and_final_obs():
    env = _env(3)
    obs0, _ = env.reset()
    rng = np.random.default_rng(1)
    saw_done = False
    for _ in range(CFG["max_episode_steps"]):
        obs, rew, term, trunc, infos = env.step(rng.integers(0, 5, size=env.num_envs))
        if "_final_obs" in infos:
            saw_done = True
            mask = infos["_final_obs"]
            assert mask.shape == (env.num_envs,) and infos["final_obs"].shape == obs.shape
            assert np.array_equal(infos["_metrics"], mask)
            assert {"metrics/ep_length", "metrics/ISR", "metrics/CSR"} <= set(infos)
            assert (infos["metrics/ep_length"][mask] >= 1).all()
            assert (infos["final_obs"][~mask] == 0).all()
            done_slots = np.nonzero(mask)[0]
            np.testing.assert_array_equal(obs[done_slots], obs0[done_slots])
    assert saw_done


def test_lifelong_metrics_key():
    env = _env(2, grid={"on_target": "restart"})
    env.reset()
    rng = np.random.default_rng(0)
    for _ in range(CFG["max_episode_steps"]):
        *_, infos = env.step(rng.integers(0, 5, size=env.num_envs))
    assert "metrics/avg_throughput" in infos and "metrics/ISR" not in infos


def test_reset_seed_reproducibility():
    env = _env(2)
    o1, _ = env.reset(seed=123)
    o2, _ = env.reset(seed=123)
    np.testing.assert_array_equal(o1, o2)
    o3, _ = env.reset()
    assert not np.array_equal(o1, o3)
    env.close()
    assert env.closed and env._state is None
    with pytest.raises(RuntimeError, match="reset"):
        env.step(np.zeros(env.num_envs, np.int64))


def test_mapf_obs_type_rejected():
    with pytest.raises(ValueError, match="global"):
        PogemaVectorEnv(GridConfig(**{**CFG, "observation_type": "MAPF"}), device="cpu")


def test_pomapf_dict_obs():
    import gymnasium

    env = _env(3, grid={"observation_type": "POMAPF"})
    w = 2 * CFG["obs_radius"] + 1
    assert isinstance(env.single_observation_space, gymnasium.spaces.Dict)
    obs, _ = env.reset(seed=11)
    assert set(obs) == {"obstacles", "agents", "xy", "target_xy"}
    assert obs["obstacles"].shape == (env.num_envs, w, w) and obs["obstacles"].dtype == np.float32
    assert obs["xy"].shape == (env.num_envs, 2) and obs["xy"].dtype == np.int32
    assert (obs["xy"] >= 0).all() and (obs["xy"] < CFG["size"]).all()
    for i in range(env.num_envs):
        assert env.single_observation_space.contains({k: v[i] for k, v in obs.items()})
    rng = np.random.default_rng(2)
    saw_done = False
    for _ in range(CFG["max_episode_steps"]):
        obs, rew, term, trunc, infos = env.step(rng.integers(0, 5, size=env.num_envs))
        if "_final_obs" in infos:
            saw_done = True
            fin, mask = infos["final_obs"], infos["_final_obs"]
            assert set(fin) == set(obs)
            for k in fin:
                assert fin[k].shape == obs[k].shape and (fin[k][~mask] == 0).all()
    assert saw_done


def test_sample_factory_batched_env():
    from pogema_torch.integrations.sample_factory import SampleFactoryBatchedEnv

    env = SampleFactoryBatchedEnv(GridConfig(**CFG), num_vec_envs=2, obs_layout="packed",
                                  device="cpu")
    assert env.is_multiagent and env.num_agents == 2 * CFG["num_agents"]
    w = 2 * CFG["obs_radius"] + 1
    assert env.observation_space.shape == (3 * w * w,)
    obs, infos = env.reset(seed=5)
    assert isinstance(obs, list) and len(obs) == env.num_agents
    rng = np.random.default_rng(0)
    got_stats = False
    for _ in range(CFG["max_episode_steps"]):
        obs, rew, term, trunc, infos = env.step(rng.integers(0, 5, size=env.num_agents))
        assert len(obs) == len(rew) == len(term) == len(infos) == env.num_agents
        got_stats |= any("ep_length" in i.get("episode_extra_stats", {}) for i in infos)
    assert got_stats
    assert pogema_torch.PogemaVectorEnv is PogemaVectorEnv
