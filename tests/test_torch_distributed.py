"""The port's learner over a mesh of gloo processes on the CPU against
the same work in one process.

Two and four worker processes (``torch_mesh_worker.py``, started with
torchrun's environment by ``torch_mesh_parity.spawn``; one thread each,
a free port per start, one retry on a rendezvous timeout) run the
meshes data = 2 (two ranks), data = 4 and data = 2 x model = 2 (four
ranks), from the same weights as this process. Held here:

* the sharded rollouts (observation-based, state-based and recurrent;
  the recurrent one tensor-parallel on the 2 x 2 mesh) are bit-equal to
  one process at 16 envs, as the JAX package's
  ``test_sharded_rollout_bit_exact``; at 8 envs (2 per rank on four
  ranks) their integer leaves are bit-equal and their floats within
  1e-6 (``torch_mesh_parity.ROLLOUT_ENVS`` says why);
* two train steps of each flavour (obs, fused 'windows', fused 'pre',
  recurrent; f32, 8 envs x 2 agents, T=8, 2 x 2 minibatches): the
  initial state gathered from the ranks is the one-process state bit
  for bit, the integer state, key and Adam count after each step are
  equal, and the floats are within the JAX package's own tolerances of
  a sharded against an unsharded step (``tests/test_parallel.py``):
  stats rtol 1e-5 (atol 1e-6), parameters rtol 2e-5 (atol 2e-6); the
  first minibatch's gradients and Adam's first moment within 1e-5 of
  the largest gradient entry, the carried h within 1e-5. Measured: 1.2e-7
  at most;
* the gradients of a fixed function of the outputs of each model,
  tensor-parallel over model = 4, 2 x 2 and data = 4, equal the
  one-process gradients within 1e-6 of the largest entry: a sum in the
  backward of the gather (model times too large) fails this;
* a recurrent step with 4 envs on four data ranks, where a minibatch of
  2 envs leaves two ranks without a row (their loss is exactly 0), and
  on 2 x 2;
* ``pogema_torch.parallel.dryrun`` on four ranks.
"""

import math

import numpy as np
import pytest
import torch

import torch_mesh_parity as h
from pogema_torch.models import ActorCritic, EmbedActorCritic, RecurrentEmbedActorCritic
from pogema_torch.parallel.learner import params_of

STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-6
GRAD_TOL = 1e-5
H_TOL = 1e-5
TP_GRAD_TOL = 1e-6
ROLLOUT_FLOAT_TOL = 1e-6


def _params():
    gen = torch.Generator().manual_seed(0)
    w, k = h.WINDOW, h.WIDTH
    return {"conv": params_of(ActorCritic(w, hidden=k, channels=4, dtype=torch.float32,
                                          generator=gen)),
            "fused": params_of(EmbedActorCritic(w, embed=k, hidden=k, dtype=torch.float32,
                                                generator=gen)),
            "recurrent": params_of(RecurrentEmbedActorCritic(w, embed=k, hidden=k,
                                                             dtype=torch.float32, generator=gen))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every worker result, by key, and the weights they started from."""
    params = _params()
    out = {}
    out.update(h.run_workers(tmp_path_factory.mktemp("w2"), 2, ["train", "rollout"], params))
    out.update(h.run_workers(tmp_path_factory.mktemp("w4"), 4,
                             ["train", "rollout", "grads", "empty"], params))
    return out, params


_REF = {}


def _reference(name, fn, *args, **kw):
    if name not in _REF:
        _REF[name] = fn(*args, **kw)
    return _REF[name]


def _integer(t):
    return not (t.is_floating_point() or t.is_complex())


def _assert_state(got, want, where):
    for k in want["env_state"]:
        assert torch.equal(got["env_state"][k], want["env_state"][k]), f"{where}: {k}"
    assert torch.equal(got["key"], want["key"]), f"{where}: key"
    assert int(got["count"]) == int(want["count"]), f"{where}: Adam count"


def _scale(grads):
    return max(float(g.abs().max()) for g in grads.values())


@pytest.mark.parametrize("case", [(2, 1), (4, 1), (2, 2)])
def test_sharded_rollouts_bit_exact(runs, case):
    results, params = runs
    got = results[("rollout",) + case]
    for envs in h.ROLLOUT_ENVS:
        want = _reference(("rollout", envs), h.run_rollouts, params, None, envs)
        for kind, fields in want.items():
            assert set(got[str(envs)][kind]) == set(fields)
            for k, v in fields.items():
                g = got[str(envs)][kind][k]
                if envs == 16 or _integer(v):
                    assert torch.equal(g, v), f"{case} {envs} envs {kind}: {k}"
                else:
                    assert float((g - v).abs().max()) <= ROLLOUT_FLOAT_TOL, (case, envs, kind, k)


@pytest.mark.parametrize("flavour", list(h.FLAVOURS))
@pytest.mark.parametrize("case", [(2, 1), (4, 1), (2, 2)])
def test_two_train_steps_equal_one_process(runs, case, flavour):
    results, params = runs
    got = results[("train",) + case + (flavour,)]
    family = h.FLAVOURS[flavour][0]
    want = _reference(("train", flavour), h.run_train, flavour, params[family])
    for k, v in want["init"]["env_state"].items():
        assert torch.equal(got["init"]["env_state"][k], v), f"initial state: {k}"
    assert torch.equal(got["init"]["key"], want["init"]["key"])
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        where = f"{case} {flavour} step {i}"
        _assert_state(g["state"], w["state"], where)
        assert set(g["stats"]) == set(w["stats"])
        for k, v in w["stats"].items():
            assert math.isfinite(g["stats"][k]), (where, k)
            assert abs(g["stats"][k] - v) <= STATS_ATOL + STATS_RTOL * abs(v), (where, k)
        for k, v in w["state"]["params"].items():
            np.testing.assert_allclose(g["state"]["params"][k].numpy(), v.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=f"{where} {k}")
        scale = _scale(w["grads"])
        for tree in ("grads", "mu"):
            a = g[tree] if tree == "grads" else g["state"]["mu"]
            b = w[tree] if tree == "grads" else w["state"]["mu"]
            err = max(float((a[k] - b[k]).abs().max()) for k in b)
            assert err <= GRAD_TOL * scale, f"{where}: {tree} differ by {err} (scale {scale})"
        if "h" in w["state"]:
            assert float((g["state"]["h"] - w["state"]["h"]).abs().max()) <= H_TOL, where


@pytest.mark.parametrize("case", [(1, 4), (2, 2), (4, 1)])
def test_model_axis_gradients_equal_unsharded(runs, case):
    results, params = runs
    got = results[("grads",) + case]
    want = _reference("grads", h.run_grads, params)
    for family, grads in want.items():
        scale = _scale(grads)
        for k, v in grads.items():
            err = float((got[family][k] - v).abs().max())
            assert err <= TP_GRAD_TOL * scale, f"{case} {family} {k}: {err} (scale {scale})"


@pytest.mark.parametrize("case", [(4, 1), (2, 2)])
def test_empty_minibatch_share(runs, case):
    """4 envs over the data ranks, minibatches of 2 envs: on four data
    ranks a rank holds one env, so half of them hold no row of a
    minibatch and still join every collective."""
    results, params = runs
    got = results[("empty",) + case]
    want = _reference("empty", h.run_train, "recurrent", params["recurrent"], num_envs=4)
    if case == (4, 1):
        assert any(loss == 0.0 for s in got["steps"] for loss in s["local_losses"])
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        _assert_state(g["state"], w["state"], f"{case} step {i}")
        for k, v in w["stats"].items():
            assert abs(g["stats"][k] - v) <= STATS_ATOL + STATS_RTOL * abs(v), (case, i, k)
        for k, v in w["state"]["params"].items():
            np.testing.assert_allclose(g["state"]["params"][k].numpy(), v.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_dryrun_on_four_ranks():
    """``python -m pogema_torch.parallel.dryrun --device cpu`` as four
    gloo ranks (data 2 x model 2): each rank prints its RESULT line with
    finite losses of both families, the same on every rank (the stats
    are global)."""
    outs = h.spawn(["-m", "pogema_torch.parallel.dryrun", "--device", "cpu"], 4)
    lines = [next(line for line in out.splitlines() if line.startswith("RESULT")) for out in outs]
    parsed = [line.split() for line in lines]
    assert [int(p[1]) for p in parsed] == [0, 1, 2, 3]
    assert all(p[2] == "mesh" and p[3] == "2x2" for p in parsed), lines
    losses = {tuple(p[4:]) for p in parsed}
    assert len(losses) == 1, lines
    assert all(math.isfinite(float(x.split("=")[1])) for x in losses.pop()), lines
