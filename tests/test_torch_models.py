"""The port's policy models against pogema_tpu's flax models, on the CPU.

JAX params (random inits and the shipped ``.ckpt_rec128_ft`` and
``.ckpt_ppo64`` checkpoints) are carried over by
``interop.params_from_flax``; both sides then run on the same states,
made from a seed by the JAX core and numpy.

Tolerances:
Each bound is absolute, and relative to the magnitude where that exceeds
1 (values of the shipped critic reach ~80).
* ``dtype=float32`` on both sides: 1e-5 on logits and values (f32
  summation order: one [3·W², E] GEMM here, three einsums there).
* bf16: ``BF16_TOL``. The port rounds at flax's points (and computes
  ``jax.nn.sigmoid`` in its own bf16 form), so the two agree to f32
  noise where the f32 sums agree; but a sum taken in another order can
  round one bf16 element one ulp (2^-8 relative) apart, and that carries
  through the later layers. 1e-2 leaves room for a few such flips. Greedy
  actions must be equal wherever JAX's top-2 logit margin exceeds
  2 · ``BF16_TOL``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pogema_tpu
from pogema_torch.interop import flatten_params, load_policy, params_from_flax
from pogema_torch.models import (ActorCritic, EmbedActorCritic, RecurrentEmbedActorCritic,
                                 init_embed_params, init_params, init_recurrent_params)
from pogema_tpu import models as jm
from pogema_tpu.utils.checkpoint import restore_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-5
BF16_TOL = 1e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _core(radius):
    return pogema_tpu.PogemaCore(
        pogema_tpu.GridConfig(size=14, num_agents=8, obs_radius=radius, density=0.3,
                              max_episode_steps=16), num_envs=4, device="cpu")


def _states(radius, seed):
    """Numpy state arrays (grids, agents_xy, targets_xy, active) of a JAX
    reset of 4 envs x 8 agents, with a random third of the agents made
    inactive, and the reset's observations."""
    st, obs = _core(radius).reset(jax.random.key(seed))
    active = np.random.default_rng(seed).random((4, 8)) > 0.33
    arrays = (np.asarray(st.obstacles), np.asarray(st.agents_xy), np.asarray(st.targets_xy), active)
    return arrays, np.asarray(obs)


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(got, want, tol, where):
    """|got - want| <= tol, relative to |want| where that exceeds 1."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    err = float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())
    assert err <= tol, f"{where}: max |diff| {err} > {tol}"


def _greedy_agree(got_logits, want_logits, tol, where):
    want = np.asarray(want_logits, np.float32)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * tol
    got_a = got_logits.detach().float().argmax(-1).numpy()
    assert (got_a[decided] == want.argmax(-1)[decided]).all(), where


def _check(got, want, dtype, where):
    """(logits, value) pairs; bf16 also checks the greedy actions."""
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    _close(got[0], want[0], tol, f"{where} logits")
    _close(got[1], want[1], tol, f"{where} value")
    if dtype == "bf16":
        _greedy_agree(got[0], want[0], tol, where)


DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _feedforward_pair(params, dtype):
    jd, td = DTYPES[dtype]
    model, _ = params_from_flax(_np_tree(params), td)
    p = params["params"]
    w = int(round(p["embed_kernel"].shape[1] ** 0.5))
    jmodel = jm.EmbedActorCritic(window=w, embed=p["embed_kernel"].shape[2],
                                 hidden=p["trunk"]["kernel"].shape[1], dtype=jd)
    return jmodel, model


def _recurrent_pair(params, dtype):
    jd, td = DTYPES[dtype]
    model, _ = params_from_flax(_np_tree(params), td)
    p = params["params"]
    w = int(round(p["embed_kernel"].shape[1] ** 0.5))
    jmodel = jm.RecurrentEmbedActorCritic(window=w, embed=p["embed_kernel"].shape[2],
                                          hidden=p["gru"]["hr"]["kernel"].shape[1], dtype=jd)
    return jmodel, model


def _run_feedforward(params, dtype, radius, seed):
    jmodel, model = _feedforward_pair(params, dtype)
    arrays, obs = _states(radius, seed)
    with torch.no_grad():
        got = model.from_state(*_t(arrays))
        got_obs = model(torch.as_tensor(obs))
    want = jmodel.apply(params, *arrays, method=jm.EmbedActorCritic.from_state)
    want_obs = jmodel.apply(params, jnp.asarray(obs))
    _check(got, want, dtype, "from_state")
    _check(got_obs, want_obs, dtype, "__call__")


def _run_recurrent(params, dtype, radius, seed, steps=3):
    jmodel, model = _recurrent_pair(params, dtype)
    hj = jmodel.initial_carry((4, 8))
    ht = model.initial_carry((4, 8))
    hj_obs, ht_obs = hj, ht
    for t in range(steps):
        arrays, obs = _states(radius, seed + t)
        with torch.no_grad():
            ht, *got = model.step_from_state(*_t(arrays), ht)
            ht_obs, *got_obs = model(torch.as_tensor(obs), ht_obs)
        hj, *want = jmodel.apply(params, *arrays, hj,
                                 method=jm.RecurrentEmbedActorCritic.step_from_state)
        hj_obs, *want_obs = jmodel.apply(params, jnp.asarray(obs), hj_obs)
        tol = F32_TOL if dtype == "f32" else BF16_TOL
        _check(got, want, dtype, f"step_from_state step {t}")
        _check(got_obs, want_obs, dtype, f"__call__ step {t}")
        _close(ht, hj, tol, f"carry step {t}")
        _close(ht_obs, hj_obs, tol, f"carry (obs path) step {t}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embed_actor_critic_random_params(dtype):
    _, params = jm.init_embed_params(jax.random.key(0), 7, embed=32, hidden=48)
    _run_feedforward(params, dtype, radius=3, seed=1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_recurrent_random_params_three_steps(dtype):
    _, params = jm.init_recurrent_params(jax.random.key(2), 7, embed=32, hidden=24)
    _run_recurrent(params, dtype, radius=3, seed=3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv_actor_critic_random_params(dtype):
    jd, td = DTYPES[dtype]
    _, params = jm.init_params(jax.random.key(4), 5, hidden=40, channels=8)
    model, _ = params_from_flax(_np_tree(params), td)
    assert isinstance(model, ActorCritic) and model.window == 5
    jmodel = jm.ActorCritic(hidden=40, channels=8, dtype=jd)
    _, obs = _states(2, seed=5)
    with torch.no_grad():
        got = model(torch.as_tensor(obs))
    _check(got, jmodel.apply(params, jnp.asarray(obs)), dtype, "ActorCritic")


@pytest.fixture(scope="module")
def rec128_ft():
    return restore_checkpoint(os.path.join(ROOT, ".ckpt_rec128_ft"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_shipped_recurrent_checkpoint(rec128_ft, dtype):
    _run_recurrent(rec128_ft, dtype, radius=5, seed=6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_shipped_feedforward_checkpoint(dtype):
    params = restore_checkpoint(os.path.join(ROOT, ".ckpt_ppo64"))
    _run_feedforward(params, dtype, radius=5, seed=7)


@pytest.mark.parametrize("name", ["rec128_ft", "ppo64", "rec128", "rec256", "maze256"])
def test_committed_weights_equal_the_checkpoint(name):
    """``pogema_torch/weights/<name>.npz`` holds the f32 leaves of
    ``.ckpt_<name>`` for the card's machine (which has no orbax).
    Regenerate one from the root of the repository with:

    python -c "import os, numpy as np; from pogema_tpu.utils.checkpoint import restore_checkpoint; from pogema_torch.interop import flatten_params; np.savez('pogema_torch/weights/rec128_ft.npz', **flatten_params(restore_checkpoint(os.path.abspath('.ckpt_rec128_ft'))))"
    """
    tree = _np_tree(restore_checkpoint(os.path.join(ROOT, f".ckpt_{name}")))
    path = os.path.join(ROOT, "pogema_torch", "weights", f"{name}.npz")
    want = flatten_params(tree)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(want)
        for k in want:
            assert z[k].dtype == np.float32 and z[k].shape == want[k].shape, k
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
    model = load_policy(path, device="cpu")
    ref, _ = params_from_flax(tree)
    assert type(model) is type(ref) and model.dtype == torch.bfloat16
    assert isinstance(model, EmbedActorCritic if name == "ppo64" else RecurrentEmbedActorCritic)
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_initialisers_are_seeded_and_shaped():
    """The port's own inits draw from the given generator: the same seed
    gives the same weights, and the shapes are those flax would make."""
    for init, kw in ((init_embed_params, dict(embed=16, hidden=24)),
                     (init_recurrent_params, dict(embed=16, hidden=24)),
                     (init_params, dict(hidden=24, channels=4))):
        m1, sd1 = init(torch.Generator().manual_seed(3), 5, **kw)
        _, sd2 = init(torch.Generator().manual_seed(3), 5, **kw)
        _, sd3 = init(torch.Generator().manual_seed(4), 5, **kw)
        assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)
        assert any(not torch.equal(sd1[k], sd3[k]) for k in sd1 if sd1[k].abs().sum() > 0)
        assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in sd1.values())
    m, sd = init_embed_params(torch.Generator().manual_seed(0), 5, embed=16, hidden=24)
    assert isinstance(m, EmbedActorCritic) and sd["embed_kernel"].shape == (3, 25, 16)
    std = float(sd["embed_kernel"].std())
    assert abs(std - 75 ** -0.5) < 0.2 * 75 ** -0.5 and not sd["embed_bias"].any()
