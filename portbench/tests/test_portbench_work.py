"""The byte and FLOP arithmetic and the metric readers, against values
worked out by hand at config C's and config D's shapes."""

import pytest

from portbench import harness, peaks, trace, work

# Config C: B = 4096 envs, N = 64 agents, 64x64 padded by r = 5 (P = 74),
# window w = 11 (363 floats of packed observation per agent).
C = dict(b=4096, p=74, n=64, w=11)
# Config D serving: B = 1024, N = 128.
D = dict(b=1024, p=74, n=128, w=11)


def test_k1b_bytes_by_hand():
    grid = 4096 * 74 * 74                 # u8 grid read once
    agents = 4096 * 64 * (8 + 8 + 1)      # position, target, active
    obs = 4096 * 64 * 363 * 4             # packed f32 written once
    assert work.k1b_bytes(**C) == grid + agents + obs == 407_519_232
    assert work.k1b_bytes(**D) == 1024 * 5476 + 1024 * 128 * 17 + 1024 * 128 * 1452


def test_k1b_bytes_match_the_formula_of_chip_smoke():
    """chip_smoke.k1b_bound_ms's count: b*p*p + b*n*17 + b*n*3*w*w*4."""
    b, p, n, w = C["b"], C["p"], C["n"], C["w"]
    assert work.k1b_bytes(b, p, n, w) == b * p * p + b * n * 17 + b * n * 3 * w * w * 4


def test_step_bytes_by_hand():
    state = 4096 * (64 * (8 + 8 + 4 + 1 + 1 + 1) + 4 + 16 + 1)
    want = 4096 * 74 * 74 + 2 * state + 2 * 4096 * 64 * 363 * 4
    assert work.step_bytes(**C) == want == 795_926_528
    # About 0.24 ms at the HBM peak.
    assert work.step_bytes(**C) / peaks.HBM_BYTES_PER_S == pytest.approx(2.376e-4, rel=1e-3)


def test_policy_and_train_flops_by_hand():
    per_agent = 2 * (363 * 128 + 6 * 128 * 128 + 128 * 6)
    assert work.policy_flops(11, 128, 128) == per_agent == 291_072
    # Config D's step: 1024 envs x 128 agents, T = 64, 2 epochs:
    # 64 rollout forwards + 1 bootstrap + 2 x 64 replayed forward+backward (x3).
    step = work.train_step_flops(per_agent, 1024, 128, 64, 2)
    assert step == per_agent * 1024 * 128 * (64 + 1 + 384)
    assert step == pytest.approx(1.713e13, rel=1e-3)
    # A served episode of config D: 131,072 agents x 128 steps.
    assert per_agent * 1024 * 128 * 128 == pytest.approx(4.88e12, rel=1e-2)


def _run(**kw):
    base = dict(work={}, units=0, unit_seconds=[], window_s=1.0, counters={}, slice=None,
                slice_counters={}, slice_units=0, shapes={}, phases={}, chips=1, setup_s=1.0)
    base.update(kw)
    return harness.Run(**base)


def _metric(name):
    return harness.load_module("metrics", name).read


def test_rates_and_tail():
    secs = [0.004] * 95 + [0.010] * 5
    run = _run(work={"env_steps": 4096, "steps": 1}, units=100, unit_seconds=secs, window_s=0.43)
    assert _metric("env_steps_per_s")(run) == pytest.approx(4096 * 100 / 0.43)
    assert 4.0 < _metric("step_ms_p95")(run) < 10.0
    assert _metric("train_env_steps_per_s")(run) is None
    # Served episodes of 1024 envs x 128 steps, their resets included.
    serve = _run(work={"env_steps": 1024 * 128, "steps": 128}, units=12, window_s=30.0)
    assert _metric("serve_env_steps_per_s")(serve) == pytest.approx(12 * 131072 / 30.0)
    # Units of two train steps (a regen cycle), 11 s each.
    train = _run(work={"train_env_steps": 2 * 65536, "train_steps": 2}, units=3,
                 unit_seconds=[11.0] * 3)
    assert _metric("train_env_steps_per_s")(train) == pytest.approx(2 * 65536 / 11.0)
    assert _metric("env_steps_per_s")(train) is None
    assert _metric("serve_env_steps_per_s")(train) is None


def test_roofline_and_shares_from_a_slice():
    sl = trace.Slice(window_s=0.1, busy_s=0.02,
                     kernels={"void packed_observation_kernel<false>(...)": 0.0031, "x": 0.01},
                     idle={"host between ops": 0.08})
    shapes = {"B": 4096, "N": 64, "W": 11, "P": 74}
    run = _run(work={"env_steps": 4096, "steps": 1}, slice=sl, slice_units=20,
               slice_counters={"k1b_launches": 20}, shapes=shapes, units=6000, window_s=30.0)
    least = 407_519_232 / 3.35e12
    assert _metric("k1b_roofline")(run) == pytest.approx(100 * least / (0.0031 / 20))
    assert _metric("k1b_roofline.serve")(run) == _metric("k1b_roofline")(run)
    # The step's share divides by the untraced window's mean step (4 ms),
    # not by the traced slice's (5 ms).
    run.window_s = 24.0
    assert _metric("step_hbm_share")(run) == pytest.approx(
        100 * (795_926_528 / 3.35e12) / (24.0 / 6000))
    assert _metric("device_idle.env")(run) == pytest.approx(80.0)
    assert _metric("device_idle.serve")(run) == pytest.approx(80.0)
    assert _metric("device_idle.train")(run) is None
    run.counters = {"fixpoint_passes": 18000}
    assert _metric("fixpoint_passes_per_step.serve")(run) == pytest.approx(3.0)


def test_a_reader_with_nothing_to_read_returns_nothing():
    run = _run(work={"env_steps": 4096, "steps": 1}, units=0)
    for name in ("k1b_roofline", "k1b_roofline.serve", "step_hbm_share", "device_idle.env",
                 "device_idle.serve", "update_s_per_step", "train_mfu"):
        assert _metric(name)(run) is None


def test_mfu_by_hand():
    shapes = {"B": 1024, "N": 128, "W": 11, "P": 74, "embed": 128, "hidden": 128}
    run = _run(work={"env_steps": 1024 * 128, "steps": 128}, units=10, window_s=25.0,
               shapes=shapes)
    flops = 291_072 * 128 * 1024 * 128 * 10
    assert _metric("serve_mfu")(run) == pytest.approx(100 * flops / 25.0 / 989e12)
    shapes.update(rollout=64, epochs=2)
    train = _run(work={"train_env_steps": 2 * 65536, "train_steps": 2}, units=3,
                 unit_seconds=[10.0] * 3, shapes=shapes)
    step = 291_072 * 1024 * 128 * 449
    assert _metric("train_mfu")(train) == pytest.approx(100 * step * 6 / 30.0 / 989e12)


def test_busy_time_is_a_union_and_gaps_are_named():
    class Ev:
        def __init__(self, name, s, d, dev):
            self._n, self._s, self._d, self._dev = name, s, d, dev

        def name(self):
            return self._n

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._d

        def device_type(self):
            import torch
            return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    events = [Ev("k1", 0, 100_000, True), Ev("k2", 50_000, 100_000, True),
              Ev("k1", 400_000, 100_000, True),
              Ev("aten::equal", 140_000, 300_000, False),
              Ev("cudaStreamSynchronize", 150_000, 280_000, False)]
    sl = trace.reduce(events, 0, 1_000_000, 0.001)
    assert sl.busy_s == pytest.approx(250e-6)
    assert sl.kernels == {"k1": pytest.approx(200e-6), "k2": pytest.approx(100e-6)}
    assert sl.idle["aten::equal > cudaStreamSynchronize"] == pytest.approx(250e-6)
    assert sl.idle["host between ops"] == pytest.approx(500e-6)
    b = sl.breakdown()
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 2
