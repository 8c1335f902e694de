"""Shared helpers of the tests that hold pogema_torch against pogema_tpu.

Data crosses between the two packages as numpy arrays only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pogema_tpu
import pogema_torch
from pogema_torch.interop import state_to_numpy

# A small world for the step-path tests: a few envs finish each episode
# inside 64 steps.
SMALL = dict(size=12, num_agents=8, obs_radius=2, max_episode_steps=20, density=0.3)

STATE_FIELDS = ("obstacles", "agents_xy", "targets_xy", "target_queue", "active",
                "terminated", "on_goal_ever", "goals_achieved", "step_count",
                "placement_ok")


def jax_state_to_numpy(state) -> dict:
    """A JAX EnvState as the port's numpy dict (key as int64 words)."""
    out = {}
    for f in STATE_FIELDS:
        v = getattr(state, f)
        if v is not None:
            out[f] = np.asarray(v)
    out["key"] = np.asarray(jax.random.key_data(state.key)).astype(np.int64)
    return out


def assert_states_equal(jax_state, torch_state, where=""):
    a, b = jax_state_to_numpy(jax_state), state_to_numpy(torch_state)
    assert set(a) == set(b), (where, sorted(set(a) ^ set(b)))
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, (where, k, a[k].shape, b[k].shape)
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{where}: field {k}")


def assert_trees_equal(jax_tree, torch_tree, where=""):
    """Bit-equal leaves (dicts compared key by key, same key sets)."""
    if isinstance(jax_tree, (tuple, list)):
        assert len(jax_tree) == len(torch_tree), where
        for i, (a, b) in enumerate(zip(jax_tree, torch_tree)):
            assert_trees_equal(a, b, f"{where}[{i}]")
        return
    if isinstance(jax_tree, dict):
        assert set(jax_tree) == set(torch_tree), (where, sorted(jax_tree), sorted(torch_tree))
        for k in jax_tree:
            assert_trees_equal(jax_tree[k], torch_tree[k], f"{where}/{k}")
        return
    a = np.asarray(jax_tree)
    b = torch_tree.detach().cpu().numpy()
    assert a.shape == b.shape, (where, a.shape, b.shape)
    assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
    np.testing.assert_array_equal(b, a, err_msg=where)


def make_cores(grid_kwargs, num_envs, **core_kwargs):
    """The JAX core and the port's core, both on the CPU."""
    jc = pogema_tpu.PogemaCore(pogema_tpu.GridConfig(**grid_kwargs), num_envs=num_envs,
                               device="cpu", **core_kwargs)
    tc = pogema_torch.PogemaCore(pogema_torch.GridConfig(**grid_kwargs), num_envs=num_envs,
                                 device="cpu", **core_kwargs)
    return jc, tc


def run_autoreset_parity(grid_kwargs, num_envs, steps, seed, **core_kwargs):
    """Reset both cores from ``seed`` and drive ``steps`` auto-reset steps
    with the same numpy actions, holding everything bit-equal. Returns
    the number of envs that finished an episode."""
    jc, tc = make_cores(grid_kwargs, num_envs, **core_kwargs)
    js, jo = jc.reset(seed)
    ts, to = tc.reset(seed)
    assert_states_equal(js, ts, "reset")
    assert_trees_equal(jo, to, "reset obs")
    j0, t0 = js, ts
    rng = np.random.default_rng(seed)
    n = jc.cfg.num_agents
    finished = 0
    for t in range(steps):
        a = rng.integers(0, 5, size=(num_envs, n)).astype(np.int32)
        js, jo, jres, jd, jm = jc.step_autoreset(js, j0, jnp.asarray(a))
        ts, to, tres, td, tm = tc.step_autoreset(ts, t0, torch.as_tensor(a))
        assert_states_equal(js, ts, f"step {t}")
        assert_trees_equal(jo, to, f"obs after reset, step {t}")
        assert_trees_equal(jres.observations, tres.observations, f"step obs, step {t}")
        for f in ("rewards", "terminated", "truncated"):
            assert_trees_equal(getattr(jres, f), getattr(tres, f), f"{f}, step {t}")
        assert_trees_equal(jd, td, f"done, step {t}")
        assert_trees_equal(jm, tm, f"metrics, step {t}")
        finished += int(np.asarray(jd).sum())
    return finished


def np_tree(tree):
    """Every leaf of a JAX pytree as a numpy array."""
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_train_state_to_numpy(ts) -> dict:
    """A JAX TrainState / RecurrentTrainState as the numpy nest that
    ``pogema_torch.interop.train_state_from_numpy`` takes. Of the optax
    chain (clip, adam) only adam's ScaleByAdamState holds leaves."""
    adam = ts.opt_state[1][0]
    out = {"params": np_tree(ts.params),
           "opt_state": {"count": np.asarray(adam.count), "mu": np_tree(adam.mu),
                         "nu": np_tree(adam.nu)},
           "env_state": jax_state_to_numpy(ts.env_state),
           "initial_env_state": jax_state_to_numpy(ts.initial_env_state),
           "key": np.asarray(jax.random.key_data(ts.key)).astype(np.int64)}
    if hasattr(ts, "h"):
        out["h"] = np.asarray(ts.h, np.float32)
    else:
        out["obs"] = None if ts.obs is None else np.asarray(ts.obs, np.float32)
    return out


def max_tree_diff(jax_tree, torch_tree_np, where=""):
    """Largest |a - b| over the leaves of two nests of the same structure
    (a JAX pytree and a nest of numpy arrays), with the path of the leaf."""
    a = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
         for k, v in jax.tree_util.tree_leaves_with_path(jax_tree)}
    b = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
         for k, v in jax.tree_util.tree_leaves_with_path(torch_tree_np)}
    assert set(a) == set(b), (where, sorted(set(a) ^ set(b)))
    worst, at = 0.0, None
    for k in a:
        assert a[k].shape == b[k].shape, (where, k, a[k].shape, b[k].shape)
        d = float(np.abs(a[k] - b[k]).max()) if a[k].size else 0.0
        if d > worst:
            worst, at = d, k
    return worst, at


def assert_host_equal(a, b, where=""):
    """Bit-equal host values of the rim (numpy arrays with their dtypes,
    lists, tuples, dicts, Python scalars), as the JAX package's rim and the
    port's hand them to a user."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, type(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_host_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            assert_host_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (where, type(b))
        assert a.shape == b.shape and a.dtype == b.dtype, (where, a.shape, b.shape, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def rim_episode(env, actions, steps=None):
    """(reset output, list of step outputs) of one episode of a lists-rim
    env driven by ``actions`` (a list of per-step action lists), ending at
    the first step where every agent is done or after ``steps`` steps."""
    out = [env.reset()]
    for t, a in enumerate(actions):
        res = env.step(a)
        out.append(res)
        if steps is None and all(x or y for x, y in zip(res[2], res[3])):
            break
        if steps is not None and t + 1 >= steps:
            break
    return out
