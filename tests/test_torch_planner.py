"""The port's planner and priority fixpoint depth against pogema_tpu, on
the CPU: everything here is integer-valued and must be bit-equal.

Distance fields on maze and random grids, greedy actions with and
without the escape key, whole planner episodes, the LifeLong refusal,
and ``priority_fixpoint_depth`` over random actions.
"""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pogema_torch.core import collisions as tcol
from pogema_torch.core import planner as tp
from pogema_torch.core import random as jr
from pogema_tpu.core import collisions as jcol
from pogema_tpu.core import planner as jp
from torch_parity import assert_states_equal, assert_trees_equal, make_cores


@functools.lru_cache(maxsize=None)
def _cores(maze, num_envs, items):
    grid = dict(size=14, num_agents=10, obs_radius=2, max_episode_steps=32, density=0.3)
    grid.update(items)
    return make_cores(grid, num_envs, maze=maze)


def _reset_pair(seed, maze, num_envs=4, **kw):
    jc, tc = _cores(maze, num_envs, tuple(sorted(kw.items())))
    js, _ = jc.reset(seed, with_obs=False)
    ts, _ = tc.reset(seed, with_obs=False)
    assert_states_equal(js, ts, "reset")
    return jc, tc, js, ts


@pytest.mark.parametrize("maze", [False, True])
def test_distance_fields_match_jax(maze):
    _, _, js, ts = _reset_pair(3, maze)
    want = np.asarray(jax.jit(jax.vmap(jp.distance_fields))(js.obstacles, js.targets_xy))
    before = tp.distance_fields.sweeps
    got = tp.distance_fields(ts.obstacles, ts.targets_xy)
    assert tp.distance_fields.sweeps > before
    np.testing.assert_array_equal(got.numpy(), want)


def test_distance_fields_random_grids_and_chunks(monkeypatch):
    """Random numpy grids, targets on free cells and on obstacles, and a
    chunk size that splits the batch unevenly."""
    rng = np.random.default_rng(0)
    grids = np.pad((rng.random((5, 11, 11)) < 0.4).astype(np.uint8), ((0, 0), (2, 2), (2, 2)),
                   constant_values=1)
    targets = rng.integers(0, 15, size=(5, 6, 2)).astype(np.int32)
    want = np.asarray(jax.jit(jax.vmap(jp.distance_fields))(jnp.asarray(grids),
                                                             jnp.asarray(targets)))
    monkeypatch.setattr(tp, "CELLS_PER_CHUNK", 2 * 6 * 15 * 15)
    got = tp.distance_fields(torch.as_tensor(grids), torch.as_tensor(targets))
    np.testing.assert_array_equal(got.numpy(), want)
    one = tp.distance_field(torch.as_tensor(grids[1]), torch.as_tensor(targets[1, 2]))
    np.testing.assert_array_equal(one.numpy(), want[1, 2])


@pytest.mark.parametrize("avoid", [True, False])
@pytest.mark.parametrize("with_key", [False, True])
def test_greedy_actions_match_jax(avoid, with_key):
    """Crowded states (40 agents on 10x10, a random quarter inactive) so
    that many agents are stuck and the escape draw decides."""
    _, _, js, ts = _reset_pair(5, False, num_envs=6, size=10, num_agents=40, density=0.1)
    dist = jax.jit(jax.vmap(jp.distance_fields))(js.obstacles, js.targets_xy)
    active = np.random.default_rng(1).random((6, 40)) > 0.25
    tdist = torch.as_tensor(np.asarray(dist))
    escapes = 0
    jfn = jax.jit(jax.vmap(partial(jp.greedy_actions, avoid_agents=avoid, escape_prob=0.7)))
    for seed in range(4):
        jkeys = jax.random.split(jax.random.key(seed), 6) if with_key else None
        tkeys = jr.split(jr.key(seed), 6) if with_key else None
        want = jfn(dist, js.agents_xy, jnp.asarray(active), key=jkeys)
        got = tp.greedy_actions(tdist, ts.agents_xy, torch.as_tensor(active), avoid, tkeys, 0.7)
        assert_trees_equal(want, got, f"seed {seed}")
        plain = tp.greedy_actions(tdist, ts.agents_xy, torch.as_tensor(active), avoid)
        escapes += int((plain != got).sum())
    # Without the penalty no agent is stuck, so only avoid + key escapes.
    assert (escapes > 0) == (with_key and avoid)


def test_escape_argmin_equals_argmax_of_minus_log():
    """Every value ``uniform(k, shape, 1e-6, 1)`` can give, in order, maps
    to a strictly decreasing ``-log u`` under jax's own log, so the masked
    argmin over u picks what jax's argmax over -log u picks."""
    mant = np.arange(1 << 23, dtype=np.uint32) | np.uint32(0x3F800000)
    f = mant.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(1e-6), np.float32(1.0)
    u = np.maximum(lo, (f.astype(np.float64) * np.float64(hi - lo) + lo).astype(np.float32))
    got = jr.uniform(jr.key(11), (64, 5), minval=1e-6, maxval=1.0).numpy()
    want = np.asarray(jax.random.uniform(jax.random.key(11), (64, 5), minval=1e-6, maxval=1.0))
    np.testing.assert_array_equal(got, want)
    assert np.isin(got, u).all()
    neg_log = np.asarray(-jnp.log(jnp.asarray(u)))
    assert (np.diff(u) > 0).all() and (np.diff(neg_log) < 0).all()


@pytest.mark.parametrize("on_target,maze,seeds", [("finish", False, (0, 1, 2)),
                                                  ("finish", True, (3, 4)),
                                                  ("nothing", False, (5, 6))])
def test_evaluate_planner_matches_jax(on_target, maze, seeds):
    jc, tc, _, _ = _reset_pair(0, maze, num_envs=6, on_target=on_target, num_agents=12)
    for seed in seeds:
        js, jm = jp.evaluate_planner(jc, seed)
        ts, tm = tp.evaluate_planner(tc, seed)
        assert_states_equal(js, ts, f"final state, seed {seed}")
        assert_trees_equal(jm, tm, f"metrics, seed {seed}")
    assert len(tc._planner_evaluators) == 1
    # The run must have done something: agents moved and some arrived.
    assert float(tm["ISR"].mean()) > 0


def test_planner_evaluator_refuses_lifelong():
    _, tc = make_cores(dict(size=10, num_agents=4, obs_radius=2, on_target="restart"), 2)
    with pytest.raises(ValueError, match="static targets"):
        tp.make_planner_evaluator(tc)


@pytest.mark.parametrize("num_agents", [1, 16])
def test_priority_fixpoint_depth_matches_jax(num_agents):
    _, _, js, ts = _reset_pair(9, False, num_envs=8, size=8, num_agents=num_agents, density=0.1)
    rng = np.random.default_rng(num_agents)
    depths = []
    jfn = jax.jit(jax.vmap(jcol.priority_fixpoint_depth))
    for t in range(6):
        actions = rng.integers(0, 5, size=(8, num_agents)).astype(np.int32)
        active = rng.random((8, num_agents)) > 0.1
        want = jfn(js.obstacles, js.agents_xy, jnp.asarray(active), jnp.asarray(actions))
        got = tcol.priority_fixpoint_depth(ts.obstacles, ts.agents_xy, torch.as_tensor(active),
                                           torch.as_tensor(actions))
        assert_trees_equal(want, got, f"draw {t}")
        depths.append(got)
    assert max(int(d.max()) for d in depths) >= (2 if num_agents > 1 else 1)
