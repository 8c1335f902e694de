"""``rim.vector``, config C served to a numpy learner through
``PogemaVectorEnv``, at a tiny size on the CPU: the reference adapter
against ``pogema_tpu``'s ``PogemaVectorEnv``; the cell correct traced
and untraced; its check false under the control, with the collisions
resolved in one pass and with the program's terminal observations taken
after the reset; both readers reading a number, and nothing where the
program lacks the counters. One card test runs the cell's traffic at
config C's full size for a short window."""

import time

import numpy as np
import pytest
import torch

from portbench import harness, reference
from portbench.reference.pogema_ref.core import collisions as ref_collisions
from portbench.reference.pogema_ref.grid_config import GridConfig as RefGridConfig
from portbench.reference.pogema_ref.integrations.vector import VectorEnv as RefVectorEnv
from portbench.tests import tiny

vector = harness.load_module("drivers", "vector")


def _tiny():
    """``rim.vector`` at a size a CPU test holds: 8 envs of 16x16 mazes,
    32 agents, r = 2, 8-step episodes; the warm-up passes the first
    ending step, as at full size, and every env is checked."""
    c = harness.Cell(harness.load_manifest(), "rim.vector")
    c.config["num_envs"] = 8
    c.config["grid"].update(size=16, num_agents=32, obs_radius=2, max_episode_steps=8)
    c.traffic.update(warmup_steps=10, check_within_steps=12, check_envs=8, trace_steps=8)
    return c


@pytest.mark.parametrize("layout", ["packed", "grid"])
def test_the_reference_adapter_equals_the_jax_vector_env(layout):
    import pogema_tpu

    grid = dict(size=16, num_agents=8, obs_radius=2, max_episode_steps=8,
                collision_system="priority", on_target="finish")
    je = pogema_tpu.PogemaVectorEnv(pogema_tpu.GridConfig(**grid), num_vec_envs=6,
                                    obs_layout=layout, maze=True)
    ref = RefVectorEnv(RefGridConfig(**grid), 6, obs_layout=layout, maze=True)
    pairs = [(je.reset(seed=9)[0], ref.reset(seed=9)[0])]
    rng = np.random.default_rng(8)
    ends = 0
    for _ in range(20):
        a = rng.integers(0, 5, size=je.num_envs, dtype=np.int32)
        j, r = je.step(a), ref.step(a)
        pairs += list(zip(j[:4], r[:4]))
        assert set(j[4]) == set(r[4])
        pairs += [(j[4][k], r[4][k]) for k in j[4]]
        ends += "final_obs" in r[4]
    assert ends >= 2
    for want, got in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("trace", [False, True])
def test_rim_vector_runs_correct_on_the_cpu(trace):
    run, checks = tiny.run(_tiny(), trace=trace, seconds=1.0)
    assert tiny.correct(checks), checks
    assert run.units >= 1
    if trace:
        assert run.slice is not None and run.slice_units == 8


def test_the_readers_read_the_window():
    run, _ = tiny.run(_tiny(), trace=True, seconds=1.0)
    mb = harness.load_module("metrics", "host_mb_per_step").read(run)
    end = harness.load_module("metrics", "end_step_ms").read(run)
    # CPU tensors are not copied: fetch counts no bytes on the CPU.
    assert mb == 0.0
    assert end is not None and end > 0
    assert run.counters["final_obs_rows"] == 8 * len(run.phases["end_step"]) > 0


def test_the_readers_read_nothing_from_a_program_without_the_counters():
    class Lacking(vector.Driver):
        """The traffic over a program whose ``fetch`` and ``_final_obs``
        carry no counters (as before they were added)."""

        def setup(self):
            super().setup()
            self.fetch = self.final_obs = lambda *a: None

    run, checks = tiny.run(_tiny(), driver=Lacking, seconds=1.0)
    assert tiny.correct(checks), checks
    assert set(run.counters) == {"k1b_launches"}
    assert harness.load_module("metrics", "host_mb_per_step").read(run) is None
    assert harness.load_module("metrics", "end_step_ms").read(harness.Run(phases={})) is None


def test_rim_vector_control_fails():
    """The reference adapter in the program's place, its terminal
    observations taken after the reset."""
    for seed in (5, 6, 7):
        ctx = harness.Context(_tiny(), seed, "cpu", False)
        checks = vector.planted(ctx, "control", 0.3, harness.measure)
        assert not tiny.correct(checks), checks


def test_rim_vector_reads_collisions_resolved_in_one_pass():
    for seed in (5, 6, 7):
        ctx = harness.Context(_tiny(), seed, "cpu", False)
        checks = vector.in_place(ctx, [(ref_collisions, "resolve_priority",
                                        reference.one_pass_priority)])
        assert not tiny.correct(checks), checks


def test_rim_vector_reads_the_program_handing_back_post_reset_final_obs():
    from pogema_torch.core import api

    whole = api.PogemaCore.step_autoreset

    def step_autoreset(self, state, initial_state, actions, with_obs=True):
        out = whole(self, state, initial_state, actions, with_obs)
        out[2].observations = out[1]
        return out

    with reference.patched([(api.PogemaCore, "step_autoreset", step_autoreset)]):
        _, checks = tiny.run(_tiny(), seconds=1.0)
    assert checks and not tiny.correct(checks), checks


@pytest.mark.cuda
def test_rim_vector_at_config_c_on_card():
    """The cell's traffic at config C's full size (4096 envs x 64 agents)
    for a short window, held to the reference by the cell's check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: config C's rim runs its kernels on the card")
    cell = harness.Cell(harness.load_manifest(), "rim.vector")
    ctx = harness.Context(cell, 2**31 + 29, "cuda", False)
    run, checks = harness.measure(ctx, 4.0, time.time())
    assert tiny.correct(checks), checks
    steps = run.units + cell.traffic["warmup_steps"]
    assert run.counters["k1b_launches"] == 2 * run.units
    ends = len(run.phases["end_step"])
    assert ends == steps // 128 - cell.traffic["warmup_steps"] // 128
    assert run.counters["final_obs_rows"] == 4096 * ends
    assert run.counters["fetch_bytes"] == 382_259_200 * run.units + 380_633_088 * ends
