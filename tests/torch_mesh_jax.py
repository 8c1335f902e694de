"""The JAX package's side of the ``test_torch_mesh_jax_*.py`` files: two
train steps of one flavour, unsharded and on ``make_mesh(data, model)``
over the first ``data * model`` of the conftest's virtual devices (the
trunk and GRU gates partitioned, the state and h sharded as the JAX
package's own tests shard them), and the check of the port's meshed
steps against them.

There is one test module per flavour, not one for all four: each
module's JAX compiles (one unsharded step and one per mesh) take most of
its time, and the suite's ``--dist loadfile`` spreads modules, not
cases, over its workers. ``runs`` overlaps the port's gloo processes
and JAX's compiles.

Tolerances are those of ``torch_train_parity.py`` (the port's one-process
step against JAX's): integer state and key bit-equal; stats within
``STATS_TOL`` = 1e-4; parameters within 2 * lr * (Adam steps taken), and
99% of the entries within 1e-6; Adam's first moment within ``GRAD_TOL``
= 1e-5 of the largest gradient entry; the carried h within
``PIECE_TOL`` = 1e-5.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np

import torch_mesh_parity as h
from pogema_torch.interop import state_from_flax
from pogema_torch.parallel.learner import params_of
from pogema_tpu.models import partition_params as jax_partition_params
from pogema_tpu.parallel import learner as jl
from pogema_tpu.parallel import make_mesh as jax_make_mesh
from pogema_tpu.parallel import shard_batch as jax_shard_batch
from torch_parity import jax_state_to_numpy, make_cores
from torch_train_parity import FLAVOURS, GRAD_TOL, PIECE_TOL, STATS_TOL, tp_model

CASES = [(2, 1), (4, 1), (2, 2)]
# what a meshed run is held to: JAX unsharded, or JAX on the same mesh
REFERENCES = ["one device", "same mesh"]


def _numpy_state(ts):
    out = {"env_state": jax_state_to_numpy(ts.env_state),
           "key": np.asarray(jax.random.key_data(ts.key)).astype(np.int64),
           "params": state_from_flax(jax.device_get(ts.params)),
           "mu": state_from_flax(jax.device_get(ts.opt_state[1][0].mu)),
           "count": int(ts.opt_state[1][0].count)}
    if hasattr(ts, "h"):
        out["h"] = np.asarray(ts.h, np.float32)
    return out


def jax_steps(flavour, case=None, steps=2):
    """[(stats, state)] of ``steps`` JAX train steps of ``flavour`` from
    ``init_*(key 1)``, unsharded (``case`` None) or on the (data, model)
    mesh ``case``."""
    family, path, init, make, _ = FLAVOURS[flavour]
    jmodel, _, params = tp_model(family, "f32")
    jc, _ = make_cores(h.GRID, h.NUM_ENVS, auto_reset_mode=h.FLAVOURS[flavour][2])
    cfg = jl.PPOConfig(obstacle_path=path, **h.PPO)
    out = []
    if case is None:
        ts, tx = init(jc, jmodel, params, cfg, jax.random.key(1))
        step = jax.jit(make(jc, jmodel, cfg, tx))
        for _ in range(steps):
            ts, stats = step(ts)
            out.append(({k: float(v) for k, v in stats.items()}, _numpy_state(ts)))
        return out
    data, model = case
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    with mesh:
        ts, tx = init(jc, jmodel, jax_partition_params(params, mesh), cfg, jax.random.key(1))
        sharded = {"env_state": jax_shard_batch(ts.env_state, mesh),
                   "initial_env_state": jax_shard_batch(ts.initial_env_state, mesh)}
        for leaf in ("obs", "h"):
            if getattr(ts, leaf, None) is not None:
                sharded[leaf] = jax_shard_batch(getattr(ts, leaf), mesh)
        ts = ts.replace(**sharded)
        step = jax.jit(make(jc, jmodel, cfg, tx))
        for _ in range(steps):
            ts, stats = step(ts)
            out.append(({k: float(v) for k, v in stats.items()}, _numpy_state(ts)))
    return out


def port_params(flavour):
    """The port's weights of ``flavour``'s family, equal to JAX's."""
    family = h.FLAVOURS[flavour][0]
    return {family: params_of(tp_model(family, "f32")[1])}


def assert_close_to_jax(got, want, grad_scale, lr, adam_steps, where):
    """``got``: one step of the port's run (``torch_mesh_parity``);
    ``want``: (stats, state) of one JAX step."""
    stats, state = want
    for k, v in state["env_state"].items():
        np.testing.assert_array_equal(got["state"]["env_state"][k].numpy(), v,
                                      err_msg=f"{where}: {k}")
    np.testing.assert_array_equal(got["state"]["key"].numpy(), state["key"], err_msg=where)
    assert int(got["state"]["count"]) == state["count"], where
    assert set(got["stats"]) == set(stats), where
    for k, v in stats.items():
        assert abs(got["stats"][k] - v) <= STATS_TOL * max(1.0, abs(v)), (where, k)
    diffs = np.concatenate([np.abs(got["state"]["params"][k].numpy() - v).ravel()
                            for k, v in state["params"].items()])
    assert diffs.max() <= 2 * lr * adam_steps, (where, diffs.max())
    assert (diffs <= 1e-6).mean() >= 0.99, (where, (diffs > 1e-6).mean())
    err = max(float(np.abs(got["state"]["mu"][k].numpy() - v).max())
              for k, v in state["mu"].items())
    assert err <= GRAD_TOL * grad_scale, (where, "mu", err, grad_scale)
    if "h" in state:
        np.testing.assert_allclose(got["state"]["h"].numpy(), state["h"], atol=PIECE_TOL,
                                   err_msg=where)


def port_runs(flavour, tmp_path_factory, cases):
    """The port's two train steps of ``flavour`` on the (data, model)
    meshes ``cases`` of gloo ranks, by case."""
    params = port_params(flavour)
    runs = {}
    for world in sorted({d * m for d, m in cases}):
        got = h.run_workers(tmp_path_factory.mktemp(f"w{world}"), world, ["train"], params,
                            flavours=[flavour], cases=[c for c in cases if c[0] * c[1] == world])
        runs.update({key[1:3]: run for key, run in got.items()})
    return runs


def check_against(flavour, run, jax_run, case, ref):
    """The port's run on the mesh ``case`` against a JAX run (``ref``:
    'one device' or the mesh it ran on)."""
    lr = jl.PPOConfig().lr
    per_step = h.PPO["epochs"] * h.PPO["minibatches"]
    for i, step in enumerate(run["steps"]):
        scale = max(float(g.abs().max()) for g in step["grads"].values())
        assert_close_to_jax(step, jax_run[i], scale, lr, per_step * (i + 1),
                            f"{flavour} on {case} vs JAX on {ref}, step {i}")


def runs(flavour, tmp_path_factory):
    """(the port's runs by mesh of ``CASES``, JAX's runs by reference and
    mesh) of ``flavour``: the port's ranks run and JAX's four steps
    compile at once, each in a thread."""
    with ThreadPoolExecutor(1 + len(CASES) * len(REFERENCES)) as pool:
        port = pool.submit(port_runs, flavour, tmp_path_factory, CASES)
        one_device = pool.submit(jax_steps, flavour)
        same_mesh = {case: pool.submit(jax_steps, flavour, case) for case in CASES}
        return port.result(), {(case, ref): (one_device if ref == "one device"
                                             else same_mesh[case]).result()
                               for case in CASES for ref in REFERENCES}
