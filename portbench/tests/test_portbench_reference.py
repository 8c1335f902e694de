"""The plain reference held against the JAX package (``pogema_tpu``), the
system the measured program was ported from, on the CPU at tiny sizes:
for the entry each cell's window drives, the reset, the ``priority``
collisions, ``step_autoreset`` with its observations, the recurrent
policy and one recurrent PPO step. Then each cell run end to end on
the CPU with ``correct`` true.

These tests import JAX; the benchmark's own runs never do, and the
reference imports nothing of either package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portbench import reference
from portbench.harness import ROOT
from portbench.reference.pogema_ref.core import api as ref_api, collisions as ref_collisions
from portbench.reference.pogema_ref.core import random as ref_jr
from portbench.reference.pogema_ref.grid_config import GridConfig as RefGridConfig
from portbench.reference.pogema_ref.parallel import learner as ref_learner
from portbench.tests import tiny

jax.config.update("jax_platforms", "cpu")

WEIGHTS = str(ROOT / "pogema_torch" / "weights" / "rec128_ft.npz")
C_GRID = dict(size=16, num_agents=24, obs_radius=2, max_episode_steps=12,
              collision_system="priority", on_target="finish")
D_GRID = dict(size=10, num_agents=4, obs_radius=5, density=0.3, on_target="restart",
              max_episode_steps=12)
FIELDS = ("obstacles", "agents_xy", "targets_xy", "target_queue", "active", "terminated",
          "on_goal_ever", "goals_achieved", "step_count", "placement_ok")


def _jax_state(state) -> dict:
    out = {f: np.asarray(getattr(state, f)) for f in FIELDS if getattr(state, f) is not None}
    out["key"] = np.asarray(jax.random.key_data(state.key)).astype(np.int64)
    return out


def _ref_state(state) -> dict:
    return {k: v.numpy() for k, v in state.tensors().items()}


def _equal(jax_tree, ref_tree, where):
    a, b = (jax_tree, ref_tree) if isinstance(jax_tree, dict) else (
        {"": np.asarray(jax_tree)}, {"": ref_tree.numpy()})
    assert set(a) == set(b), (where, sorted(set(a) ^ set(b)))
    for k in a:
        assert a[k].shape == b[k].shape, (where, k, a[k].shape, b[k].shape)
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{where}: {k}")


def _cores(grid, **kw):
    import pogema_tpu

    return (pogema_tpu.PogemaCore(pogema_tpu.GridConfig(**grid), device="cpu", **kw),
            ref_api.PogemaCore(RefGridConfig(**grid), device="cpu", **kw))


def _key_words(key) -> torch.Tensor:
    return torch.tensor(np.asarray(jax.random.key_data(key)).astype(np.int64))


# -- the env: reset, collisions, step_autoreset -------------------------------


@pytest.mark.parametrize("grid,kw", [(C_GRID, dict(maze=True, obs_layout="packed")),
                                     (D_GRID, dict())], ids=["C", "D"])
def test_reset_equals_jax(grid, kw):
    jc, rc = _cores(grid, num_envs=6, **kw)
    js, jo = jc.reset(jax.random.key(7))
    rs, ro = rc.reset(_key_words(jax.random.key(7)))
    _equal(_jax_state(js), _ref_state(rs), "state")
    _equal(jo, ro, "observation")


def test_the_sequential_priority_rule_equals_jax_on_crowded_grids():
    """Crowded 6 x 6 grids, where chains of moves into cells being left
    are long: the rule run agent by agent gives JAX's positions."""
    from pogema_tpu.core import collisions as jax_collisions

    rng = np.random.default_rng(0)
    b, s, n, r = 256, 6, 20, 1
    p = s + 2 * r
    obstacles = np.ones((b, p, p), np.uint8)
    obstacles[:, r:r + s, r:r + s] = rng.random((b, s, s)) < 0.1
    xy = np.zeros((b, n, 2), np.int32)
    for e in range(b):
        free = np.argwhere(obstacles[e] == 0)
        xy[e] = free[rng.choice(len(free), n, replace=False)]
    active = rng.random((b, n)) < 0.9
    actions = rng.integers(0, 5, (b, n)).astype(np.int32)
    want = jax.vmap(jax_collisions.resolve_priority)(
        jnp.asarray(obstacles), jnp.asarray(xy), jnp.asarray(active), jnp.asarray(actions))
    got = ref_collisions.resolve_priority(*(torch.as_tensor(a) for a in
                                            (obstacles, xy, active, actions)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The grids are crowded enough that one parallel pass is not the rule.
    control = reference.one_pass_priority(*(torch.as_tensor(a) for a in
                                            (obstacles, xy, active, actions)))
    assert (control != got).any()


@pytest.mark.parametrize("grid,kw", [
    (C_GRID, dict(maze=True, obs_layout="packed", auto_reset_mode="cached")),
    (C_GRID, dict(maze=True, obs_layout="packed", auto_reset_mode="regen")),
    (D_GRID, dict(auto_reset_mode="cached")),
    (D_GRID, dict(auto_reset_mode="regen"))], ids=["C-cached", "C-regen", "D-cached", "D-regen"])
def test_step_autoreset_equals_jax(grid, kw):
    jc, rc = _cores(grid, num_envs=6, **kw)
    js, _ = jc.reset(jax.random.key(3))
    rs, _ = rc.reset(_key_words(jax.random.key(3)))
    j0, r0 = js, rs
    rng = np.random.default_rng(3)
    step = jax.jit(jc.step_autoreset)
    finished = 0
    for t in range(30):
        a = rng.integers(0, 5, (6, grid["num_agents"])).astype(np.int32)
        js, jo, jres, jd, jm = step(js, j0, jnp.asarray(a))
        rs, ro, rres, rd, rm = rc.step_autoreset(rs, r0, torch.as_tensor(a))
        _equal(_jax_state(js), _ref_state(rs), f"state, step {t}")
        _equal(jo, ro, f"observation after the reset, step {t}")
        _equal(jres.observations, rres.observations, f"observation, step {t}")
        for f in ("rewards", "terminated", "truncated"):
            _equal(getattr(jres, f), getattr(rres, f), f"{f}, step {t}")
        _equal(jd, rd, f"done, step {t}")
        _equal({k: np.asarray(v) for k, v in jm.items()}, {k: v.numpy() for k, v in rm.items()},
               f"metrics, step {t}")
        finished += int(np.asarray(jd).sum())
    assert finished > 0  # the auto-reset ran


# -- the policy and the learner ---------------------------------------------


def _flat(tree, prefix="params") -> dict:
    """A nested flax parameter dict as flattened leaves ('params/gru/hn/kernel')."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _nested(leaves: dict) -> dict:
    out = {}
    for key, v in leaves.items():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


def _shipped():
    with np.load(WEIGHTS) as z:
        return {k: z[k] for k in z.files}


def _models(leaves, dtype):
    """(JAX module, JAX params, the reference's module) with the same weights."""
    from pogema_tpu import models as jm

    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    params = _nested(leaves)
    _, ww, embed = params["params"]["embed_kernel"].shape
    hidden = params["params"]["gru"]["hr"]["kernel"].shape[0]
    jmodel = jm.RecurrentEmbedActorCritic(window=int(round(ww ** 0.5)), embed=embed,
                                          hidden=hidden, dtype=jd)
    return jmodel, params, reference.recurrent_model(reference.flax_leaves(leaves), "cpu", td)


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_the_recurrent_policy_equals_jax_with_the_shipped_weights(dtype, tol):
    jmodel, params, model = _models(_shipped(), dtype)
    jc, rc = _cores(D_GRID, num_envs=4)
    js, _ = jc.reset(jax.random.key(5))
    rs, _ = rc.reset(_key_words(jax.random.key(5)))
    cell = jax.jit(lambda *a: jmodel.apply(params, *a, method=type(jmodel).step_from_state))
    jh = jnp.zeros((4, D_GRID["num_agents"], 128), jmodel.dtype)
    h = model.initial_carry((4, D_GRID["num_agents"]))
    rng = np.random.default_rng(5)
    for t in range(6):
        jh, jlogits, jvalue = cell(js.obstacles, js.agents_xy, js.targets_xy, js.active, jh)
        with torch.no_grad():
            h, logits, value = model.step_from_state(rs.obstacles, rs.agents_xy, rs.targets_xy,
                                                     rs.active, h)
        for got, want in ((logits, jlogits), (value, jvalue)):
            want = np.asarray(want, np.float32)
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got.numpy() - want).max()) <= tol * scale, (t, scale)
        a = rng.integers(0, 5, (4, D_GRID["num_agents"])).astype(np.int32)
        js = jc.step_autoreset(js, js, jnp.asarray(a))[0]
        rs = rc.step_autoreset(rs, rs, torch.as_tensor(a), with_obs=False)[0]


TRAIN_CASES = {
    # A freshly initialised f32 policy (JAX's init) on a small world, and
    # the shipped bf16 policy on config D's kinds at a tiny size.
    "f32": (dict(seed=0, size=8, density=0.2, num_agents=2, obs_radius=2, max_episode_steps=16,
                 on_target="restart"), 8, dict(rollout_steps=8, epochs=2, minibatches=2),
            1e-4, 1e-6),
    "bf16": (D_GRID, 4, dict(rollout_steps=4, epochs=2, minibatches=2, lr=1.5e-4,
                             entropy_coef=0.003), 2e-3, None),
}


@pytest.mark.parametrize("dtype", sorted(TRAIN_CASES))
def test_one_recurrent_train_step_equals_jax(dtype):
    from pogema_tpu import models as jm
    from pogema_tpu.parallel import learner as jl

    grid, envs, ppo, stats_tol, param_tol = TRAIN_CASES[dtype]
    if dtype == "f32":
        _, params = jm.init_recurrent_params(jax.random.key(0), 2 * grid["obs_radius"] + 1,
                                             embed=32, hidden=32)
        leaves = _flat(jax.tree_util.tree_map(np.asarray, params["params"]))
    else:
        leaves = _shipped()
    jmodel, params, model = _models(leaves, dtype)
    jc, rc = _cores(grid, num_envs=envs, auto_reset_mode="regen")
    jcfg = jl.PPOConfig(**ppo)
    jts, tx = jl.init_recurrent_train_state(jc, jmodel, params, jcfg, jax.random.key(1))
    rts, rtx = ref_learner.init_recurrent_train_state(rc, model, None,
                                                      ref_learner.PPOConfig(**ppo),
                                                      _key_words(jax.random.key(1)))
    _equal(_jax_state(jts.env_state), _ref_state(rts.env_state), "initial env state")
    step = ref_learner.make_recurrent_train_step(rc, model, ref_learner.PPOConfig(**ppo), rtx)
    jts, jstats = jax.jit(jl.make_recurrent_train_step(jc, jmodel, jcfg, tx))(jts)
    rts, rstats = step(rts)
    # The rollout drew the same actions: the env state and key agree exactly.
    _equal(_jax_state(jts.env_state), _ref_state(rts.env_state), "env state after the step")
    _equal(np.asarray(jax.random.key_data(jts.key)).astype(np.int64), rts.key, "key")
    assert set(jstats) == set(rstats)
    for k in jstats:
        want, got = float(jstats[k]), float(rstats[k])
        assert abs(got - want) <= stats_tol * max(1.0, abs(want)), (k, got, want)
    # The parameters after E x M Adam steps (each moves a leaf by at most
    # about lr per step).
    want = reference.flax_leaves(_flat(jax.tree_util.tree_map(np.asarray, jts.params["params"])))
    diffs = np.concatenate([np.abs(rts.params[k].numpy() - v).ravel() for k, v in want.items()])
    assert set(want) == set(rts.params)
    assert diffs.max() <= 2 * jcfg.lr * jcfg.epochs * jcfg.minibatches, diffs.max()
    if param_tol is not None:  # f32: most entries agree to round-off
        moved = np.concatenate([np.abs(v - reference.flax_leaves(leaves)[k]).ravel()
                                for k, v in want.items()])
        assert moved.max() > 10 * diffs.max()
        assert (diffs <= param_tol).mean() >= 0.99


def test_reset_of_some_rows_is_those_rows_of_the_whole_reset():
    """The checks reset only the sampled envs: each env's reset depends on
    its own key alone."""
    rc = ref_api.PogemaCore(RefGridConfig(**C_GRID), num_envs=8, maze=True, obs_layout="packed",
                            device="cpu")
    keys = ref_jr.split(torch.tensor([1, 99], dtype=torch.int64), 8)
    rows = torch.tensor([1, 4, 7])
    whole = rc._reset_envs(keys)
    part = rc._reset_envs(keys.index_select(0, rows))
    assert reference.mismatches({k: v.index_select(0, rows) for k, v in whole.tensors().items()},
                                part.tensors()) == 0


def test_the_reference_reads_the_shipped_weights_as_the_program_does():
    from pogema_torch.interop import load_policy

    prog = load_policy(WEIGHTS, device="cpu")
    ref = reference.recurrent_model(WEIGHTS, "cpu")
    assert dict(prog.named_parameters()).keys() == dict(ref.named_parameters()).keys()
    for (k, a), (_, b) in zip(prog.named_parameters(), ref.named_parameters()):
        assert torch.equal(a, b), k


# -- each cell end to end ------------------------------------------------------


@pytest.mark.parametrize("name", ["C.random", "D.serve", "D.train"])
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_runs_correct_on_the_cpu(name, trace):
    run, checks = tiny.run(tiny.cell(name), trace=trace)
    assert tiny.correct(checks), checks
    assert run.units >= 1 and run.setup_s >= 0
    if trace:
        assert run.slice is not None and run.slice_units >= 1


def test_seeds_past_32_bits_draw_distinct_inputs():
    from portbench import harness

    cell = tiny.cell("C.random")
    a = harness.Context(cell, 2**32 + 5, "cpu", False)
    b = harness.Context(cell, 5, "cpu", False)
    assert not torch.equal(a.key(1), b.key(1))
    assert a.torch_seed(2) != b.torch_seed(2)
    assert np.all(a.key(1).numpy() < 2**32)
