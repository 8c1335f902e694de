"""``C.regen``, config C with a new world every episode, at a tiny size
on the CPU: the cell correct traced and untraced, its checkpoints
holding the first ending step and the step after it; both readers
reading the window, and nothing where the program lacks the counters;
the check false under both planted faults. One card test runs the
cell's traffic at config C's full size for a short window."""

import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

regen = harness.load_module("drivers", "env_regen")


def _tiny():
    """``C.regen`` at a size a CPU test holds: 8 envs of 16x16 mazes, 8
    agents, r = 2, 8-step episodes; the warm-up passes the first ending
    step, as at full size, and every env is checked."""
    c = harness.Cell(harness.load_manifest(), "C.regen")
    c.config["num_envs"] = 8
    c.config["grid"].update(size=16, num_agents=8, obs_radius=2, max_episode_steps=8)
    c.traffic.update(warmup_steps=10, check_within_steps=12, check_envs=8, trace_steps=8)
    return c


@pytest.mark.parametrize("trace", [False, True])
def test_c_regen_runs_correct_on_the_cpu(trace):
    c = _tiny()
    ctx = harness.Context(c, 2**31 + 17, "cpu", trace)
    drv = regen.Driver(ctx)
    assert {8, 9} <= set(drv.checkpoints) and len(drv.checkpoints) == 6
    run, checks = harness.measure(ctx, 1.0, 0.0, drv)
    assert tiny.correct(checks), checks
    assert {8, 9} <= set(drv.saved)
    if trace:
        assert run.slice is not None and run.slice_units == 8


def test_the_readers_read_the_window():
    run, _ = tiny.run(_tiny(), seconds=1.0)
    steps = run.units
    ends = len(run.phases["regen_step"])
    assert ends == (steps + 10) // 8 - 10 // 8 > 0
    assert run.counters["regen_envs"] == 8 * ends
    assert run.counters["unplaced"] == 0
    per_step = harness.load_module("metrics", "regen_envs_per_step").read(run)
    assert per_step == 8 * ends / steps
    ms = harness.load_module("metrics", "regen_step_ms").read(run)
    assert ms == 1e3 * sum(run.phases["regen_step"]) / ends


def test_the_readers_read_nothing_from_a_program_without_the_counters():
    class Lacking(regen.Driver):
        """The traffic over a program whose regen reset and generator
        carry no counters (as before they were added)."""

        def setup(self):
            super().setup()
            self.regen = self.generate = lambda *a: None

    run, checks = tiny.run(_tiny(), driver=Lacking, seconds=1.0)
    assert tiny.correct(checks), checks
    assert set(run.counters) == {"k1b_launches"}
    assert harness.load_module("metrics", "regen_envs_per_step").read(run) is None
    assert harness.load_module("metrics", "regen_step_ms").read(harness.Run(phases={})) is None


@pytest.mark.parametrize("impl", ["control", "stale_key"])
def test_c_regen_planted_faults_fail(impl):
    for seed in (5, 6, 7):
        ctx = harness.Context(_tiny(), seed, "cpu", False)
        checks = regen.planted(ctx, impl, 0.3, harness.measure)
        assert not tiny.correct(checks), checks


@pytest.mark.cuda
def test_c_regen_at_config_c_on_card():
    """The cell's traffic at config C's full size (4096 envs x 64 agents)
    for a short window, held to the reference by the cell's check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: config C's regen step runs its kernels on the card")
    cell = harness.Cell(harness.load_manifest(), "C.regen")
    ctx = harness.Context(cell, 2**31 + 29, "cuda", False)
    run, checks = harness.measure(ctx, 4.0, time.time())
    assert tiny.correct(checks), checks
    warm = cell.traffic["warmup_steps"]
    assert run.counters["k1b_launches"] == 2 * run.units
    ends = len(run.phases["regen_step"])
    assert ends == (run.units + warm) // 128 - warm // 128
    assert run.counters["regen_envs"] == 4096 * ends
    assert run.counters["unplaced"] == 0
