"""The check must come out false when the timed path is broken under it,
and when each cell's control takes the program's place.

These tests skip the harness's look for a card and drive the rest of a
run on the CPU at a tiny size, with one fault planted in the program:
a step that returns its state unchanged, half of the batch left out of
the loss, the exchange between ranks left out, an answer altered where
it is produced."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness, reference
from portbench.tests import tiny

HERE = os.path.dirname(os.path.abspath(__file__))


def _false(name, patches=(), **kw):
    with reference.patched(list(patches)):
        _, checks = tiny.run(tiny.cell(name), **kw)
    assert checks and not tiny.correct(checks), checks
    return checks


# -- C.random -----------------------------------------------------------


def _c_unchanged():
    from pogema_torch.core.api import PogemaCore

    whole = PogemaCore.step_autoreset

    def step(self, state, initial_state, actions, with_obs=True):
        return (state, *whole(self, state, initial_state, actions, with_obs)[1:])

    return [(PogemaCore, "step_autoreset", step)]


def _c_altered():
    from pogema_torch.core import obs

    whole = obs.packed_observation_cuda

    def k1b(*args):
        out = whole(*args)
        out[:, :, 0] = 1 - out[:, :, 0]
        return out

    return [(obs, "packed_observation_cuda", k1b)]


@pytest.mark.parametrize("fault", [_c_unchanged, _c_altered])
def test_c_random_faults_fail(fault):
    _false("C.random", fault())


def test_c_random_control_fails():
    """The reference with its collisions resolved in one parallel pass."""
    drv = harness.load_module("drivers", "env_random")
    for seed in (5, 6, 7):
        ctx = harness.Context(tiny.cell("C.random"), seed, "cpu", False)
        checks = drv.planted(ctx, "control", 0.3, harness.measure)
        assert not tiny.correct(checks), checks


# -- D.serve --------------------------------------------------------------


def _s_unchanged():
    from pogema_torch.core import step as step_mod

    whole = step_mod.step

    def step(cfg, state, actions, with_obs=True):
        return state, whole(cfg, state, actions, with_obs)[1]

    return [(step_mod, "step", step)]


def _s_altered():
    from pogema_torch.models.recurrent import RecurrentEmbedActorCritic

    whole = RecurrentEmbedActorCritic.step_from_state

    def step_from_state(self, *args):
        h, logits, value = whole(self, *args)
        return h, logits + torch.tensor([0.0, 0.0, 0.0, 0.0, 5.0]), value

    return [(RecurrentEmbedActorCritic, "step_from_state", step_from_state)]


@pytest.mark.parametrize("fault", [_s_unchanged, _s_altered])
def test_d_serve_faults_fail(fault):
    _false("D.serve", fault())


def test_d_serve_control_fails():
    """The reference's policy with fp8 weights in the program's place."""
    drv = harness.load_module("drivers", "serve")
    for seed in (5, 6, 7):
        ctx = harness.Context(tiny.cell("D.serve"), seed, "cpu", False)
        checks = drv.planted(ctx, "control", 0.3, harness.measure)
        assert not tiny.correct(checks), checks


# -- D.train ----------------------------------------------------------------


def _t_unchanged():
    from pogema_torch.parallel import learner

    whole = learner.make_recurrent_train_step

    def make(*args, **kw):
        step = whole(*args, **kw)

        def unchanged(ts):
            return ts, step(ts)[1]

        return unchanged

    return [(learner, "make_recurrent_train_step", make)]


def _t_altered():
    from pogema_torch.parallel import learner

    whole = learner._ppo_total

    def total(*args):
        loss, aux = whole(*args)
        return loss * 1.05, aux

    return [(learner, "_ppo_total", total)]


def _t_half():
    return harness.load_module("drivers", "train").half_batch_patch()


@pytest.mark.parametrize("fault", [_t_unchanged, _t_half, _t_altered])
def test_d_train_faults_fail(fault):
    checks = dict((n, v) for n, v, _ in _false("D.train", fault()))
    if fault is _t_unchanged:  # a state left unchanged reads 1 on the change
        assert checks["change_gap"] == pytest.approx(1.0)


def test_d_train_control_fails():
    drv = harness.load_module("drivers", "train")
    for seed in (5, 6, 7):
        ctx = harness.Context(tiny.cell("D.train"), seed, "cpu", False)
        checks = drv.planted(ctx, "control", 0.0, harness.measure)
        assert not tiny.correct(checks), checks


# -- the train driver over a data mesh of two gloo ranks -------------------------------------------


def _ranks(fault: str, seed: int) -> list:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "mesh_worker.py"), str(rank),
                               "2", str(port), str(seed), fault],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, OMP_NUM_THREADS="1"))
             for rank in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


def test_data_mesh_of_two_gloo_ranks_is_correct_and_its_faults_fail():
    sound = _ranks("none", 11)
    assert all(v <= lim for v, lim in sound["checks"]), sound
    assert sound["allreduce_bytes"] > 0
    for fault in ("exchange", "half_batch"):
        broken = _ranks(fault, 11)
        assert not all(v <= lim for v, lim in broken["checks"]), (fault, broken)
