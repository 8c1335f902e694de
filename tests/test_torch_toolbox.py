"""The port's toolbox and planner policy against ``pogema_tpu``'s on the
CPU: ``evaluate`` with A*, random and the planner gives the JAX toolbox's
metrics on the same seeds; ``GlobalPlannerPolicy`` actions are bit-equal;
``PPOPolicy`` logits are within 1e-5 (f32) and 1e-2 (bf16, as in
``tests/test_torch_models.py``) of the JAX policy for the recurrent, embed
and conv families, with greedy actions equal wherever JAX's top-2 margin
exceeds twice the bf16 bound; the shipped checkpoints load and act; the
checkpoint formats and the YAML path."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pogema_torch
import pogema_tpu
import pogema_tpu.toolbox as jt
import pogema_torch.toolbox as tt
from pogema_torch import models as tm
from pogema_torch.interop import flatten_params, load_policy, params_to_flax
from pogema_tpu import models as jm
from pogema_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint
from torch_parity import assert_host_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-5
BF16_TOL = 1e-2
ENV = dict(size=8, density=0.2, num_agents=4, obs_radius=3, max_episode_steps=24)


@pytest.mark.parametrize("algo,extra", [("A*", {}), ("random", {}),
                                        ("Planner", {"observation_type": "MAPF"})])
def test_evaluate_equals_jax(algo, extra):
    envs = {"small": dict(ENV, **extra)}
    j = jt.evaluate(envs, algo=algo, seeds=[0, 1])
    t = tt.evaluate(envs, algo=algo, seeds=[0, 1], device="cpu")
    assert t == j
    assert t["small"]["episodes"] == 2 and set(t["small"]) >= {"ISR", "CSR", "ep_length"}


@pytest.mark.parametrize("on_target,avoid", [("finish", True), ("nothing", False),
                                             ("restart", True)])
def test_planner_policy_actions_bit_equal(on_target, avoid):
    """Both planners on the same MAPF episode; LifeLong moves targets, so
    the fields are computed again after each respawn."""
    kw = dict(ENV, seed=3, num_agents=6, on_target=on_target, observation_type="MAPF")
    je = pogema_tpu.pogema_v0(pogema_tpu.GridConfig(**kw))
    te = pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw), device="cpu")
    goal_inactive = on_target == "finish"
    jp = pogema_tpu.GlobalPlannerPolicy(avoid_agents=avoid, seed=1,
                                        on_goal_inactive=goal_inactive)
    tp = pogema_torch.GlobalPlannerPolicy(avoid_agents=avoid, seed=1,
                                          on_goal_inactive=goal_inactive, device="cpu")
    jo, _ = je.reset()
    to, _ = te.reset()
    plans = set()
    for _ in range(24):
        a = jp.act(jo)
        assert tp.act(to) == a
        plans.add(tp._cache_key)
        jo, *j_rest = je.step(a)
        to, *t_rest = te.step(a)
        assert_host_equal((jo, j_rest), (to, t_rest))
        if all(x or y for x, y in zip(j_rest[1], j_rest[2])):
            break
    if on_target == "restart":
        assert len(plans) > 1 and j_rest[3][0]["metrics"]["avg_throughput"] > 0
    with pytest.raises(ValueError, match="MAPF"):
        tp.act([np.zeros((3, 7, 7), np.float32)])


def _obs(seed, n=8, radius=3):
    """Default observations of a port env, a few random steps in."""
    env = pogema_torch.pogema_v0(pogema_torch.GridConfig(
        seed=seed, size=12, density=0.3, num_agents=n, obs_radius=radius, max_episode_steps=32),
        device="cpu")
    obs, _ = env.reset()
    out, rng = [obs], np.random.default_rng(seed)
    for _ in range(3):
        obs = env.step(rng.integers(0, 5, size=n).tolist())[0]
        out.append(obs)
    return out


FAMILIES = {
    "recurrent": (tm.init_recurrent_params, jm.RecurrentEmbedActorCritic,
                  dict(embed=32, hidden=16)),
    "embed": (tm.init_embed_params, jm.EmbedActorCritic, dict(embed=32, hidden=16)),
    "conv": (tm.init_params, jm.ActorCritic, dict(hidden=16, channels=8)),
}


@functools.lru_cache(maxsize=None)
def _params(family):
    """A flax-shaped ``{'params': ...}`` nest of numpy arrays, drawn by the
    port's initialiser (the JAX one takes seconds to trace)."""
    init, _, sizes = FAMILIES[family]
    model, _ = init(torch.Generator().manual_seed(7), 7, **sizes)
    return params_to_flax(model)


def _jax_logits_f32(family, obs_seq):
    """The flax module in f32 over the observation sequence (the
    recurrent state carried)."""
    _, cls, sizes = FAMILIES[family]
    kw = dict(sizes, window=7) if family != "conv" else dict(sizes)
    model = cls(dtype=jnp.float32, **kw)
    params = _params(family)
    apply = jax.jit(model.apply)
    out, h = [], None
    for obs in obs_seq:
        x = jnp.asarray(np.asarray(obs, np.float32))
        if family == "recurrent":
            h = model.initial_carry((x.shape[0],)) if h is None else h
            h, logits, _ = apply(params, x, h)
        else:
            logits = apply(params, x)[0]
        out.append(np.asarray(logits, np.float64))
    return out


def _port_logits_f32(family, obs_seq):
    """The port's module of ``family``, loaded in f32 as ``PPOPolicy``
    loads it in bf16, over the observation sequence (the recurrent state
    carried)."""
    model = load_policy(_params(family), "cpu", torch.float32)
    out, h = [], None
    with torch.inference_mode():
        for obs in obs_seq:
            x = torch.as_tensor(np.asarray(obs, np.float32))
            if family == "recurrent":
                h = model.initial_carry((x.shape[0],)) if h is None else h
                h, logits, _ = model(x, h)
            else:
                logits = model(x)[0]
            out.append(logits.double().numpy())
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ppo_policy_logits_match_jax(family, tmp_path):
    obs_seq = _obs(4)
    # f32: the module PPOPolicy runs, against the flax module in f32
    for i, (want, got) in enumerate(zip(_jax_logits_f32(family, obs_seq),
                                        _port_logits_f32(family, obs_seq))):
        assert np.abs(got - want).max() <= F32_TOL * max(1.0, np.abs(want).max()), (family, i)
    # bf16: the port's PPOPolicy against the JAX toolbox's PPOPolicy
    path = str(tmp_path / family)
    save_checkpoint(path, _params(family))
    jpol = jt.PPOPolicy(path)
    tpol = tt.PPOPolicy(_params(family), device="cpu")
    h = None
    decided = 0
    for obs in obs_seq:
        x = np.asarray(obs, np.float32)
        if family == "recurrent":
            h = jpol._model.initial_carry((x.shape[0],)) if h is None else h
            h, want = jpol._apply(jpol._params, x, h)
        else:
            want = jpol._apply(jpol._params, x)
        want = np.asarray(want, np.float64)
        got = tpol.logits(obs)
        assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= BF16_TOL, family
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL
        decided += int(clear.sum())
        np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    assert decided > 0
    # act() is the greedy argmax; the JAX policy acts the same on clear margins
    tpol.reset_states()
    assert len(tpol.act(obs_seq[0])) == 8


def test_ppo_policy_checkpoint_formats_and_memory(tmp_path):
    """An .npz of flax leaves, a params checkpoint of the port, a flax
    nest and the port's flat dict load the same model; an orbax
    directory is refused. The recurrent state persists across act() and
    clears at episode boundaries."""
    from pogema_torch.interop import params_from_flax, state_from_flax
    from pogema_torch.utils.checkpoint import save_checkpoint as save_port

    tree = _params("recurrent")
    npz = str(tmp_path / "p.npz")
    np.savez(npz, **flatten_params(tree))
    port_ckpt = str(tmp_path / "port.pt")
    model, _ = params_from_flax(tree)
    save_port(port_ckpt, dict(model.named_parameters()))
    obs = _obs(5)[0]
    want = tt.PPOPolicy(tree, device="cpu").logits(obs)
    for src in (npz, port_ckpt, state_from_flax(tree)):
        np.testing.assert_array_equal(tt.PPOPolicy(src, device="cpu").logits(obs), want)
    save_checkpoint(str(tmp_path / "orbax"), tree)
    with pytest.raises(ValueError, match="directory"):
        tt.PPOPolicy(str(tmp_path / "orbax"), device="cpu")

    pol = tt.PPOPolicy(npz, device="cpu")
    ones = [np.ones((3, 7, 7), np.float32)] * 2
    assert pol._h is None
    pol.act(ones)
    h1 = pol._h.float().clone()
    pol.act(ones)
    assert not torch.equal(pol._h.float(), h1)
    pol.reset()
    assert pol._h is None
    a_fresh = pol.act(ones, episode_start=True)
    pol.act(ones)
    assert pol.act(ones, episode_start=True) == a_fresh
    sampler = tt.PPOPolicy(npz, temperature=1.0, seed=1, device="cpu")
    acts = sampler.act(obs)
    assert len(acts) == 8 and all(0 <= a < 5 for a in acts)
    assert tt.PPOPolicy(npz, temperature=1.0, seed=1, device="cpu").act(obs) == acts


def test_shipped_checkpoints_load_and_act():
    """The shipped orbax checkpoints, restored on the JAX side and carried
    over as numpy, load into the port's PPOPolicy, as does the committed
    .npz; greedy actions equal the JAX PPOPolicy's wherever its top-2
    margin is clear of the bf16 bound."""
    obs = _obs(6, n=8, radius=5)[-1]
    shipped = [p for p in (".ckpt_maze256", ".ckpt_maze64", ".ckpt_rec256b_ft", ".ckpt_rec128_ft")
               if os.path.isdir(os.path.join(ROOT, p))]
    assert shipped, "no shipped checkpoints found"
    for name in shipped:
        path = os.path.join(ROOT, name)
        tree = jax.tree_util.tree_map(np.asarray, restore_checkpoint(path))
        tpol, jpol = tt.PPOPolicy(tree, device="cpu"), jt.PPOPolicy(path)
        got = tpol.act(obs)
        assert len(got) == 8 and all(0 <= a < 5 for a in got), name
        jpol.reset_states()
        x = np.asarray(obs, np.float32)
        if jpol._model is not None:
            want = jpol._apply(jpol._params, x, jpol._model.initial_carry((8,)))[1]
        else:
            want = jpol._apply(jpol._params, x)
        want = np.asarray(want, np.float64)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL
        np.testing.assert_array_equal(np.asarray(got)[clear], want.argmax(-1)[clear], err_msg=name)
    npz = os.path.join(ROOT, "pogema_torch", "weights", "rec128_ft.npz")
    shipped_tree = jax.tree_util.tree_map(
        np.asarray, restore_checkpoint(os.path.join(ROOT, ".ckpt_rec128_ft")))
    assert tt.PPOPolicy(npz, device="cpu").act(obs) == tt.PPOPolicy(shipped_tree,
                                                                    device="cpu").act(obs)


def test_evaluate_ppo_runs():
    npz = os.path.join(ROOT, "pogema_torch", "weights", "rec128_ft.npz")
    out = tt.evaluate(dict(ENV, obs_radius=5), algo="PPO", seeds=[0],
                      algo_kwargs=dict(checkpoint=npz), device="cpu")
    assert out["env"]["episodes"] == 1 and 0.0 <= out["env"]["ISR"] <= 1.0


def test_custom_algo_and_yaml(tmp_path):
    class Still:
        def act(self, obs):
            return [0] * len(obs)

    class StillOn(Still):
        devices = []

        def __init__(self, device="cuda"):
            self.devices.append(device)

    for mod in (jt, tt):
        mod.register_algo("still", Still)
    tt.register_algo("still_on", StillOn)
    spec = tmp_path / "eval.yaml"
    spec.write_text("""
algo: random
seeds: [1]
algo_kwargs: {seed: 3}
environments:
  a: {size: 6, num_agents: 2, obs_radius: 2, max_episode_steps: 6}
  warehouse: {map_name: warehouse-16x16, num_agents: 3, obs_radius: 2, max_episode_steps: 6}
""")
    got = tt.evaluate_from_yaml(str(spec), device="cpu")
    assert set(got) == {"a", "warehouse"}
    assert got == jt.evaluate_from_yaml(str(spec))
    still = tt.evaluate(dict(size=6, num_agents=2, obs_radius=2, max_episode_steps=4),
                        algo="still", seeds=[0], device="cpu")
    assert still["env"]["ISR"] == 0.0 and still["env"]["ep_length"] == 4.0
    # a factory with a ``device`` parameter gets evaluate's device
    tt.evaluate(dict(size=6, num_agents=2, obs_radius=2, max_episode_steps=2),
                algo="still_on", seeds=[0, 1], device="cpu")
    assert StillOn.devices == ["cpu", "cpu"]
