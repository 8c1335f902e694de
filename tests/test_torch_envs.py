"""The port's ``pogema_v0`` envs against ``pogema_tpu``'s on the CPU: whole
seeded episodes bit-equal for every on_target x observation type, the
folded key of later unseeded episodes, the accessors, hide/show, the
global state, the ANSI render, the spaces, the factory, auto_reset and
persistent, the gymnasium id, and the rim without gymnasium. Mirrors
``tests/test_envs_rim.py`` (animation aside)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pogema_torch
import pogema_tpu
import pogema_torch.wrappers
import pogema_tpu.wrappers
from torch_parity import assert_host_equal, rim_episode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(size=8, density=0.2, num_agents=6, obs_radius=2, max_episode_steps=32)


def _pair(**kw):
    """(JAX env, port env) from the same GridConfig kwargs."""
    return (pogema_tpu.pogema_v0(pogema_tpu.GridConfig(**kw)),
            pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw), device="cpu"))


def _actions(n, steps, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 5, size=n).tolist() for _ in range(steps)]


@pytest.mark.parametrize("observation_type", ["default", "POMAPF", "MAPF"])
@pytest.mark.parametrize("on_target", ["finish", "nothing", "restart"])
def test_seeded_episodes_bit_equal(on_target, observation_type):
    kw = dict(BASE, seed=3, on_target=on_target, observation_type=observation_type)
    je, te = _pair(**kw)
    acts = _actions(6, 32, seed=1)
    for episode in range(2):  # a seeded env replays its episode
        j, t = rim_episode(je, acts), rim_episode(te, acts)
        assert_host_equal(j, t, f"{on_target}/{observation_type} episode {episode}")
    metrics = j[-1][4][0]["metrics"]
    assert set(metrics) == ({"ep_length", "avg_throughput"} if on_target == "restart"
                            else {"ep_length", "ISR", "CSR"})


@pytest.mark.parametrize("on_target", ["finish", "restart"])
def test_unseeded_episodes_fold_the_key(on_target):
    """An unseeded env draws a base seed and folds the episode index into
    its key; with the same base seed both packages give the same worlds,
    and the second episode differs from the first."""
    je, te = _pair(**dict(BASE, on_target=on_target, max_episode_steps=8))
    for env in (je, te):
        env._base_seed = 12345
    acts = _actions(6, 8, seed=2)
    eps = []
    for episode in range(3):
        j, t = rim_episode(je, acts), rim_episode(te, acts)
        assert_host_equal(j, t, f"episode {episode}")
        assert_host_equal(je.get_obstacles(), te.get_obstacles(), f"grid {episode}")
        eps.append(te.get_obstacles())
    assert not np.array_equal(eps[0], eps[1])
    # reset(seed=...) pins the key, as in the JAX rim
    assert_host_equal(je.reset(seed=5), te.reset(seed=5), "reset(seed=5)")


def test_unseeded_varies():
    env = pogema_torch.pogema_v0(pogema_torch.GridConfig(**dict(BASE, size=6)), device="cpu")
    env.reset()
    g1 = env.get_obstacles()
    env.reset()
    assert not np.array_equal(g1, env.get_obstacles())


@pytest.fixture(scope="module")
def finish_pair():
    """One JAX and one port env ('finish', default obs) a few steps into
    an episode, with some agents finished."""
    kw = dict(BASE, seed=18, size=6)
    je, te = _pair(**kw)
    je.reset(), te.reset()
    for a in _actions(6, 12, seed=3):
        assert_host_equal(je.step(a), te.step(a), "step")
    return je, te


def test_accessors_equal(finish_pair):
    je, te = finish_pair
    for ib in (True, False):
        assert_host_equal(je.get_obstacles(ignore_borders=ib), te.get_obstacles(ignore_borders=ib))
        for oa in (True, False):
            assert je.get_agents_xy(oa, ib) == te.get_agents_xy(oa, ib)
            assert je.get_targets_xy(oa, ib) == te.get_targets_xy(oa, ib)
        assert je.get_lifelong_targets_xy(ib) == te.get_lifelong_targets_xy(ib)
    assert je.active == te.active
    assert not all(te.active.values()), "no agent finished: the only_active case is not exercised"
    assert_host_equal(je.get_state(), te.get_state(), "get_state")
    assert te.num_agents == te.get_num_agents() == 6 and te.is_multiagent


def test_has_obstacle_equal(finish_pair):
    je, te = finish_pair
    p, r = te.get_obstacles(ignore_borders=False).shape[0], BASE["obs_radius"]
    # Logical coordinates reach into the border; only cells outside the
    # padded grid raise, in both directions.
    for ib, lo, hi in ((True, -r, 6 + r), (False, 0, p)):
        for x in range(lo, hi):
            for y in range(lo, hi):
                assert je.has_obstacle(x, y, ib) == te.has_obstacle(x, y, ib)
        for cell in ((lo - 1, 0), (0, lo - 1), (hi, 0), (0, hi)):
            for env in (je, te):
                with pytest.raises(IndexError):
                    env.has_obstacle(*cell, ignore_borders=ib)
    assert te.has_obstacle(0, 0, ignore_borders=False) and te.has_obstacle(-1, 0)


def test_render_equal(finish_pair, capsys):
    je, te = finish_pair
    assert je.render() == te.render()
    out = capsys.readouterr().out
    assert out.count("\n") == 2 * 6


def test_hide_show_agent():
    kw = dict(seed=0, size=6, num_agents=2, obs_radius=2, max_episode_steps=16,
              map="......\n" * 5 + "......", agents_xy=[[2, 2], [2, 3]],
              targets_xy=[[0, 0], [5, 5]])
    je = pogema_tpu.Pogema(pogema_tpu.GridConfig(**kw))
    te = pogema_torch.Pogema(pogema_torch.GridConfig(**kw), device="cpu")
    assert_host_equal(je.reset(), te.reset())
    obs, *_ = te.step([0, 0])
    assert obs[1][1][2, 1] == 1.0  # agent 0 visible in agent 1's window
    je.step([0, 0])
    for change in ("hide", "show"):
        assert getattr(je, f"{change}_agent")(0) and getattr(te, f"{change}_agent")(0)
        assert je.active == te.active
        j, t = je.step([0, 0]), te.step([0, 0])
        assert_host_equal(j, t, change)
        assert t[0][1][1][2, 1] == (0.0 if change == "hide" else 1.0)
    assert not te.hide_agent(5) and not te.show_agent(-1)


@pytest.mark.parametrize("observation_type", ["default", "POMAPF", "MAPF"])
def test_observation_space_equal(observation_type):
    kw = dict(BASE, seed=1, observation_type=observation_type)
    je, te = _pair(**kw)
    assert te.observation_space == je.observation_space
    assert te.action_space == je.action_space
    obs, _ = te.reset()
    for o in obs:
        assert te.observation_space.contains(o)


def test_factory_picks_class():
    cfg = pogema_torch.GridConfig(**dict(BASE, seed=0))
    assert type(pogema_torch.pogema_v0(cfg, device="cpu")) is pogema_torch.Pogema
    for ot, cls in (("restart", pogema_torch.PogemaLifeLong),
                    ("nothing", pogema_torch.PogemaCoopFinish)):
        env = pogema_torch.pogema_v0(cfg.model_copy(update={"on_target": ot}), device="cpu")
        assert isinstance(env, cls) and env.grid_config.on_target == ot
    # the subclasses force their mode, as in the reference
    assert pogema_torch.PogemaLifeLong(cfg, device="cpu").grid_config.on_target == "restart"
    assert pogema_torch.PogemaCoopFinish(device="cpu", **dict(BASE, seed=0)).grid_config.on_target \
        == "nothing"


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise")
    from pogema_torch.integrations.sample_factory import SampleFactoryBatchedEnv
    from pogema_torch.toolbox import PPOPolicy, evaluate

    cfg = pogema_torch.GridConfig(**dict(BASE, seed=0))
    npz = os.path.join(ROOT, "pogema_torch", "weights", "rec128_ft.npz")
    for make in (lambda: pogema_torch.pogema_v0(cfg), lambda: pogema_torch.Pogema(cfg),
                 lambda: pogema_torch.PogemaLifeLong(cfg),
                 lambda: pogema_torch.PogemaVectorEnv(cfg, num_vec_envs=2),
                 lambda: SampleFactoryBatchedEnv(cfg, num_vec_envs=2),
                 lambda: pogema_torch.GlobalPlannerPolicy(), lambda: PPOPolicy(npz),
                 lambda: evaluate(dict(BASE), algo="random")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_auto_reset_flag():
    kw = dict(seed=0, size=6, num_agents=2, obs_radius=2, max_episode_steps=4)
    je, te = _pair(**kw, auto_reset=True)
    assert type(te).__name__ == "AutoResetWrapper"
    acts = _actions(2, 10, seed=0)
    first = te.reset()
    assert_host_equal(je.reset(), first)
    done_seen = False
    for a in acts:  # straight through the episode boundaries
        j, t = je.step(a), te.step(a)
        assert_host_equal(j, t, "auto-reset step")
        if all(x or y for x, y in zip(t[2], t[3])):
            done_seen = True
            assert_host_equal(first[0], t[0], "post-reset obs")
    assert done_seen
    sf = pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw, integration="SampleFactory"),
                                device="cpu")
    assert type(sf).__name__ == "AutoResetWrapper"
    sf_off = pogema_torch.pogema_v0(
        pogema_torch.GridConfig(**kw, integration="SampleFactory", auto_reset=False), device="cpu")
    assert type(sf_off).__name__ != "AutoResetWrapper"
    with pytest.raises(ValueError, match="auto_reset"):
        pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw, integration="PyMARL", auto_reset=True),
                               device="cpu")


def test_persistent_flag():
    kw = dict(BASE, seed=21, persistent=True, max_episode_steps=6)
    je, te = _pair(**kw)
    acts = _actions(6, 6, seed=4)
    assert_host_equal(rim_episode(je, acts), rim_episode(te, acts))
    assert (pogema_tpu.wrappers.PersistentWrapper.compact(je.get_history())
            == pogema_torch.wrappers.PersistentWrapper.compact(te.get_history()))
    assert len(te.get_history()) == 7
    assert te.get_agents_xy() == je.get_agents_xy() and te.active == je.active
    assert_host_equal(je.get_obstacles(), te.get_obstacles())


def test_actions_sampler_equal():
    j, t = pogema_tpu.ActionsSampler(seed=3), pogema_torch.ActionsSampler(seed=3)
    for dim in (1, 5, 9):
        assert j.sample_actions(dim) == t.sample_actions(dim)


def test_gym_ids():
    import gymnasium

    cfg = dict(BASE, seed=2)
    entry = gymnasium.spec("PogemaTorch-v0").entry_point
    assert entry == "pogema_torch.envs:_make_pogema_gym_entry"
    assert gymnasium.spec("Pogema-v0").entry_point == "pogema_tpu.envs:_make_pogema_gym_entry"
    env = gymnasium.make("PogemaTorch-v0", grid_config=pogema_torch.GridConfig(**cfg), device="cpu")
    assert isinstance(env.unwrapped, pogema_torch.Pogema)
    ref = gymnasium.make("Pogema-v0", grid_config=pogema_tpu.GridConfig(**cfg))
    assert_host_equal(ref.reset(), env.reset())
    a = [1] * 6
    assert_host_equal(ref.step(a), env.step(a))


_NO_GYM = r"""
import json, sys
sys.modules["gymnasium"] = None
sys.modules["pettingzoo"] = None
import numpy as np
from pogema_torch import GridConfig, PogemaVectorEnv, pogema_v0
from pogema_torch.toolbox import evaluate
from pogema_torch.wrappers import EpLengthMetric, PersistentWrapper

out = {}
kw = dict(seed=3, size=8, density=0.2, num_agents=6, obs_radius=2, max_episode_steps=12)
env = PersistentWrapper(EpLengthMetric(pogema_v0(GridConfig(**kw), device="cpu")))
assert env.observation_space is None and env.action_space is None
obs, _ = env.reset()
rng = np.random.default_rng(1)
for _ in range(12):
    obs, rew, term, trunc, infos = env.step(rng.integers(0, 5, size=6).tolist())
out["single"] = [o.tolist() for o in obs] + [rew, term, trunc, infos[0]["metrics"]]
out["history"] = len(env.get_history())
sf = pogema_v0(GridConfig(**kw, integration="SampleFactory"), device="cpu")
sf.reset()
out["sf"] = [sf.step([0] * 6)[1] for _ in range(13)]
vec = PogemaVectorEnv(GridConfig(**kw), num_vec_envs=3, obs_layout="packed", device="cpu")
assert vec.metadata["autoreset_mode"] == "SameStep" and vec.single_observation_space is None
o, _ = vec.reset()
fin = None
for _ in range(12):
    o, r, te, tr, inf = vec.step(rng.integers(0, 5, size=vec.num_envs))
    fin = inf.get("final_obs", fin)
out["vector"] = [o.sum().item(), r.tolist(), fin.sum().item()]
out["toolbox"] = evaluate(dict(kw, observation_type="MAPF"), algo="Planner", seeds=[0, 1],
                          device="cpu")
print(json.dumps(out))
"""


def test_rim_runs_without_gymnasium():
    """With gymnasium (and pettingzoo) unimportable, as on a machine that
    lacks them, the envs, wrappers, SampleFactory adapter, vector env and
    toolbox still run, without spaces, and give the numbers they give
    with gymnasium."""
    res = subprocess.run([sys.executable, "-c", _NO_GYM], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    # the same run in this process, where gymnasium imports
    from pogema_torch.toolbox import evaluate
    from pogema_torch.wrappers import EpLengthMetric, PersistentWrapper

    kw = dict(seed=3, size=8, density=0.2, num_agents=6, obs_radius=2, max_episode_steps=12)
    env = PersistentWrapper(EpLengthMetric(pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw),
                                                                  device="cpu")))
    obs, _ = env.reset()
    rng = np.random.default_rng(1)
    for _ in range(12):
        obs, rew, term, trunc, infos = env.step(rng.integers(0, 5, size=6).tolist())
    assert got["single"] == [o.tolist() for o in obs] + [rew, term, trunc, infos[0]["metrics"]]
    assert got["history"] == len(env.get_history()) == 13
    assert got["toolbox"] == json.loads(json.dumps(evaluate(
        dict(kw, observation_type="MAPF"), algo="Planner", seeds=[0, 1], device="cpu")))
    assert len(got["sf"]) == 13 and got["vector"][2] > 0
