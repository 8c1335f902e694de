"""The port's rollouts, ``grid_embed`` and ``from_state_pre`` against
pogema_tpu, on the CPU.

* ``grid_embed`` / ``from_state_pre`` against flax with the same
  parameters on hand-made states (agents on the border, inactive agents,
  a pair whose ``dx`` is inside the window while ``dy`` is not), with and
  without a leading time axis: f32 model within ``F32_TOL`` = 1e-5, bf16
  within ``BF16_TOL`` = 1e-2 (absolute, relative where the value exceeds
  1; the bounds of ``test_torch_models.py``: f32 summation order, and in
  bf16 a rounding that lands one ulp apart and carries through the
  head), and against the port's own ``from_state`` at the same bounds.
* the three rollouts from one JAX reset carried across, f32 model,
  T = 8 with episodes ending inside: actions, dones, env_dones, the
  stored positions, the final env state and the key bit-equal;
  log-probs, values and rewards within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pogema_torch.interop import params_from_flax, state_from_numpy
from pogema_torch.parallel import rollout as troll
from pogema_tpu import models as jm
from pogema_tpu.parallel import rollout as jroll
from test_torch_models import _close
from torch_parity import (assert_states_equal, assert_trees_equal, jax_state_to_numpy,
                          make_cores, np_tree)

F32_TOL = 1e-5
BF16_TOL = 1e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
R, S, B, N = 2, 10, 3, 6
W = 2 * R + 1


def _hand_made_states(seed, t=None):
    """Padded u8 grids [B, P, P] and agents/targets/active, optionally
    with a time axis [t, B, ...]: agent 0 in the top-left logical corner,
    agent 1 in the bottom-right one, agent 2 one row below agent 0 at the
    far column (dx in the window, dy far outside), a third of the rest
    inactive."""
    rng = np.random.default_rng(seed)
    p = S + 2 * R
    grids = np.ones((B, p, p), np.uint8)
    grids[:, R:R + S, R:R + S] = rng.random((B, S, S)) < 0.3
    lead = () if t is None else (t,)
    axy = rng.integers(R, R + S, lead + (B, N, 2)).astype(np.int32)
    axy[..., 0, :] = (R, R)
    axy[..., 1, :] = (R + S - 1, R + S - 1)
    axy[..., 2, :] = (R + 1, R + S - 1)
    txy = rng.integers(R, R + S, lead + (B, N, 2)).astype(np.int32)
    active = rng.random(lead + (B, N)) > 0.33
    active[..., :3] = True
    active[..., 1, 3] = False
    return grids, axy, txy, active


def _pair(dtype):
    jd, td = DTYPES[dtype]
    _, params = jm.init_embed_params(jax.random.key(0), W, embed=32, hidden=48)
    jmodel = jm.EmbedActorCritic(window=W, embed=32, hidden=48, dtype=jd)
    model, _ = params_from_flax(np_tree(params), td)
    return jmodel, model, params


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grid_embed_matches_flax(dtype):
    jmodel, model, params = _pair(dtype)
    grids = _hand_made_states(0)[0]
    want = jmodel.apply(params, jnp.asarray(grids), method=jm.EmbedActorCritic.grid_embed)
    with torch.no_grad():
        got = model.grid_embed(torch.as_tensor(grids))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, S, S, 32)
    _close(got, np.asarray(want, np.float32), F32_TOL if dtype == "f32" else BF16_TOL, "grid_embed")


@pytest.mark.parametrize("time_axis", [None, 3], ids=["no_time", "time"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_from_state_pre_matches_flax_and_from_state(dtype, time_axis):
    jmodel, model, params = _pair(dtype)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    grids, axy, txy, active = _hand_made_states(1, time_axis)
    e_grid = jmodel.apply(params, jnp.asarray(grids), method=jm.EmbedActorCritic.grid_embed)
    want = jmodel.apply(params, e_grid, jnp.asarray(axy), jnp.asarray(txy), jnp.asarray(active),
                        method=jm.EmbedActorCritic.from_state_pre)
    tg, ta, tt, tact = (torch.as_tensor(x) for x in (grids, axy, txy, active))
    with torch.no_grad():
        got = model.from_state_pre(model.grid_embed(tg), ta, tt, tact)
        if time_axis is None:
            direct = model.from_state(tg, ta, tt, tact)
        else:
            per_t = [model.from_state(tg, ta[t], tt[t], tact[t]) for t in range(time_axis)]
            direct = tuple(torch.stack(x) for x in zip(*per_t))
    assert got[0].shape == axy.shape[:-1] + (5,) and got[1].shape == axy.shape[:-1]
    for i, name in enumerate(("logits", "value")):
        _close(got[i], want[i], tol, f"from_state_pre {name} vs flax")
        _close(got[i], direct[i].numpy(), tol, f"from_state_pre {name} vs from_state")


def test_from_state_pre_masks_before_the_flat_index_can_alias():
    """Agent 2 sits at dx = +1, dy = S - 1 from agent 0: in range by rows,
    far out by columns. Without the mask its flat index (dx+r)*w + (dy+r)
    would land in another row of the table; with it, agent 0's embedding
    does not depend on whether agent 2 is there."""
    _, model, _ = _pair("f32")
    grids, axy, txy, active = (torch.as_tensor(x) for x in _hand_made_states(2))
    off = active.clone()
    off[:, 2] = False
    with torch.no_grad():
        e = model.grid_embed(grids)
        with_2 = model.from_state_pre(e, axy, txy, active)[0][:, 0]
        without_2 = model.from_state_pre(e, axy, txy, off)[0][:, 0]
    assert torch.equal(with_2, without_2)
    # ... while a neighbour inside the window does change it.
    near = axy.clone()
    near[:, 2] = near[:, 0] + torch.tensor([1, 1], dtype=torch.int32)
    with torch.no_grad():
        seen = model.from_state_pre(e, near, txy, active)[0][:, 0]
    assert not torch.equal(seen, with_2)


def test_from_state_pre_gradients_reach_every_parameter():
    """Under autograd the obstacle kernel's gradient flows through the
    conv, the agent and target blocks' through the table GEMM."""
    _, model, _ = _pair("f32")
    grids, axy, txy, active = (torch.as_tensor(x) for x in _hand_made_states(3, 2))
    logits, value = model.from_state_pre(model.grid_embed(grids), axy, txy, active)
    (logits.square().sum() + value.sum()).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name
    assert all(model.embed_kernel.grad[c].abs().sum() > 0 for c in range(3))


# -- rollouts -----------------------------------------------------------------

T = 8
ROLL_GRID = dict(seed=0, size=8, density=0.2, num_agents=3, obs_radius=2, max_episode_steps=5)


def _compare_traj(jtraj, ttraj, exact, close):
    for f in exact:
        assert_trees_equal(getattr(jtraj, f), getattr(ttraj, f), f)
    for f in close:
        got, want = getattr(ttraj, f).numpy(), np.asarray(getattr(jtraj, f))
        assert got.shape == want.shape, f
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f)
    assert bool(np.asarray(jtraj.env_dones).any()), "want episode ends inside the rollout"
    done = np.asarray(jtraj.env_dones)
    assert set(jtraj.metrics) == set(ttraj.metrics)
    for k, v in jtraj.metrics.items():
        np.testing.assert_array_equal(ttraj.metrics[k].numpy()[done], np.asarray(v)[done], k)


STATE_EXACT = ("agents_xy", "targets_xy", "active", "actions", "dones", "env_dones")
CLOSE = ("log_probs", "values", "rewards")


def _key_words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("on_target", ["finish", "restart"])
def test_obs_rollout_matches_jax(on_target):
    jc, tc = make_cores(dict(ROLL_GRID, on_target=on_target), 6)
    _, params = jm.init_params(jax.random.key(0), W, hidden=32, channels=4)
    jmodel = jm.ActorCritic(hidden=32, channels=4, dtype=jnp.float32)
    model, _ = params_from_flax(np_tree(params), torch.float32)
    js, jobs = jc.reset(jax.random.key(3))
    ts = state_from_numpy(jax_state_to_numpy(js), "cpu")
    jout = jax.jit(jroll.make_rollout_fn(jc, jmodel.apply, T))(params, js, js, jobs,
                                                               jax.random.key(4))
    tout = troll.make_rollout_fn(tc, model, T)(ts, ts, torch.as_tensor(np.asarray(jobs)),
                                               tc.make_key(4))
    assert_states_equal(jout[0], tout[0], "final state")
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))  # next observations
    np.testing.assert_array_equal(tout[2].numpy(), _key_words(jout[2]))
    _compare_traj(jout[3], tout[3], ("obs", "actions", "dones", "env_dones"), CLOSE)
    assert tout[3].obs.shape == (T, 6, 3, 3, W, W) and tout[3].actions.dtype == torch.int32


@pytest.mark.parametrize("with_ctx", [False, True], ids=["from_state", "make_ctx"])
def test_state_rollout_matches_jax(with_ctx):
    jc, tc = make_cores(dict(ROLL_GRID, on_target="restart"), 6)
    _, params = jm.init_embed_params(jax.random.key(0), W, embed=32, hidden=32)
    jmodel = jm.EmbedActorCritic(window=W, embed=32, hidden=32, dtype=jnp.float32)
    model, _ = params_from_flax(np_tree(params), torch.float32)
    mcls = jm.EmbedActorCritic
    js, _ = jc.reset(jax.random.key(5), with_obs=False)
    ts = state_from_numpy(jax_state_to_numpy(js), "cpu")
    if with_ctx:
        japply = lambda p, *a: jmodel.apply(p, *a, method=mcls.from_state_pre)
        jctx = lambda p, g: jmodel.apply(p, g, method=mcls.grid_embed)
        jfn = jroll.make_state_rollout_fn(jc, japply, T, make_ctx=jctx)
        tfn = troll.make_state_rollout_fn(tc, model.from_state_pre, T, make_ctx=model.grid_embed)
    else:
        japply = lambda p, *a: jmodel.apply(p, *a, method=mcls.from_state)
        jfn = jroll.make_state_rollout_fn(jc, japply, T)
        tfn = troll.make_state_rollout_fn(tc, model.from_state, T)
    jout = jax.jit(jfn)(params, js, js, jax.random.key(6))
    tout = tfn(ts, ts, tc.make_key(6))
    assert_states_equal(jout[0], tout[0], "final state")
    np.testing.assert_array_equal(tout[1].numpy(), _key_words(jout[1]))
    _compare_traj(jout[2], tout[2], STATE_EXACT, CLOSE)


@pytest.mark.parametrize("on_target", ["finish", "restart"])
def test_recurrent_rollout_matches_jax(on_target):
    jc, tc = make_cores(dict(ROLL_GRID, on_target=on_target), 6)
    _, params = jm.init_recurrent_params(jax.random.key(0), W, embed=32, hidden=32)
    jmodel = jm.RecurrentEmbedActorCritic(window=W, embed=32, hidden=32, dtype=jnp.float32)
    model, _ = params_from_flax(np_tree(params), torch.float32)
    jcell = lambda p, *a: jmodel.apply(p, *a, method=jm.RecurrentEmbedActorCritic.step_from_state)
    js, _ = jc.reset(jax.random.key(7), with_obs=False)
    ts = state_from_numpy(jax_state_to_numpy(js), "cpu")
    h0 = np.random.default_rng(0).normal(size=(6, 3, 32)).astype(np.float32)
    jout = jax.jit(jroll.make_recurrent_rollout_fn(jc, jcell, T))(
        params, js, js, jnp.asarray(h0), jax.random.key(8))
    tout = troll.make_recurrent_rollout_fn(tc, model.step_from_state, T)(
        ts, ts, torch.as_tensor(h0), tc.make_key(8))
    assert_states_equal(jout[0], tout[0], "final state")
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=1e-5)
    np.testing.assert_array_equal(tout[2].numpy(), _key_words(jout[2]))
    _compare_traj(jout[3], tout[3], STATE_EXACT, CLOSE)
    # The hidden state is zeroed exactly where the stored dones say so.
    last_done = tout[3].dones[-1]
    assert bool((tout[1][last_done] == 0).all())
