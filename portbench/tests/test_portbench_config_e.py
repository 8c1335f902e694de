"""``E.serve``, serving on the mixed map pool, at a tiny size on the CPU:
correct traced and untraced, its check false for the control and for
planted faults, and its two generator readers reading something. One
card test holds 8 envs at config E's full widths to the reference."""

import time

import pytest
import torch

from portbench import harness, reference
from portbench.tests import tiny
from portbench.tests.test_portbench_faults import _s_unchanged

serve_pool = harness.load_module("drivers", "serve_pool")


def _tiny():
    """``E.serve`` at a size a CPU test holds: the map bank keeps its
    128x128 worlds (the grid's size must match them); fewer envs, agents
    and steps."""
    c = harness.Cell(harness.load_manifest(), "E.serve")
    c.config["num_envs"] = 8
    c.config["grid"].update(num_agents=16, max_episode_steps=24)
    c.traffic.update(check_envs=8)
    return c


@pytest.mark.parametrize("trace", [False, True])
def test_e_serve_runs_correct_on_the_cpu(trace):
    run, checks = tiny.run(_tiny(), trace=trace)
    assert tiny.correct(checks), checks
    assert run.units >= 1
    if trace:
        assert run.slice is not None and run.slice_units >= 1


def test_the_generator_readers_read_the_window():
    run, _ = tiny.run(_tiny())
    sweeps = harness.load_module("metrics", "component_sweeps_per_episode").read(run)
    tries = harness.load_module("metrics", "placement_tries_per_episode").read(run)
    # A flood fill needs a sweep that changes labels and one that finds no
    # change; every reset makes at least one placement try.
    assert sweeps is not None and sweeps >= 2
    assert tries is not None and tries >= 1
    assert run.counters["sweeps"] == sweeps * run.units


def test_the_readers_read_nothing_from_a_program_without_the_counters():
    run = harness.Run(counters={"fixpoint_passes": 3, "k1b_launches": 2}, units=1)
    for name in ("component_sweeps_per_episode", "placement_tries_per_episode"):
        assert harness.load_module("metrics", name).read(run) is None


def _bank_ignored():
    """The program draws its own Bernoulli worlds where the bank was asked
    for."""
    from pogema_torch.core import generator

    whole = generator._make_map

    def make_map(cfg, keys, fixed_map, map_bank, maze):
        return whole(cfg, keys, fixed_map, None, maze)

    return [(generator, "_make_map", make_map)]


@pytest.mark.parametrize("fault", [_s_unchanged, _bank_ignored])
def test_e_serve_faults_fail(fault):
    with reference.patched(fault()):
        _, checks = tiny.run(_tiny())
    assert checks and not tiny.correct(checks), checks


def test_e_serve_control_fails():
    """The reference's policy with fp8 weights in the program's place."""
    for seed in (5, 6, 7):
        ctx = harness.Context(_tiny(), seed, "cpu", False)
        checks = serve_pool.planted(ctx, "control", 0.3, harness.measure)
        assert not tiny.correct(checks), checks


@pytest.mark.cuda
def test_config_e_at_its_widths_on_card():
    """8 envs of 128x128 pool worlds with 256 agents (K1b's wide layout)
    through the evaluator, held to the reference by the cell's check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1b's wide layout runs only on the card")
    cell = harness.Cell(harness.load_manifest(), "E.serve")
    cell.config["num_envs"] = 8
    ctx = harness.Context(cell, 2**31 + 29, "cuda", False)
    drv = serve_pool.Driver(ctx)
    run, checks = harness.measure(ctx, 0.1, time.time(), drv)
    assert tiny.correct(checks), checks
    steps = cell.config["grid"]["max_episode_steps"]
    assert run.counters["k1b_launches"] == steps * run.units
    assert run.counters["sweeps"] >= 2 * run.units and run.counters["tries"] >= run.units
