"""The span readers (``portbench/spans.py`` and the ``metrics/`` that read
it), on the CPU at tiny sizes: finite numbers from a run with a span
slice, nothing without one, and the per-span device and idle reduction
by hand."""

import json
import math

import pytest
import torch

from portbench import harness, spans
from portbench.tests import tiny

PROGRAM_SPAN = {"C.random": ["select_ms_per_step", "collisions_ms_per_step",
                             "observe_ms_per_step"],
                "D.serve": ["reset_ms_per_episode.serve", "policy_ms_per_step.serve"]}


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _measure(name, trace, seed=2**33 + 5):
    ctx = harness.Context(tiny.cell(name), seed, "cpu", trace)
    return spans.measure(ctx, 0.3, 0.0)


@pytest.mark.parametrize("name", sorted(PROGRAM_SPAN))
def test_a_traced_run_with_a_span_slice_reads_every_span_metric(name):
    run, checks = _measure(name, trace=True)
    assert tiny.correct(checks), checks
    assert run.span_units >= 1 and run.span_s > 0
    for metric in PROGRAM_SPAN[name]:
        value = _read(metric, run)
        assert value is not None and math.isfinite(value) and value > 0, (metric, value)
    # The CPU launches no device kernels: no policy roofline to read.
    assert _read("policy_mfu.serve", run) is None
    rows = spans.table(run)
    root = "pogema.step_autoreset" if name == "C.random" else "pogema.episode"
    assert rows[root]["calls"] == 1
    assert rows[root]["host_ms"] >= rows[root]["self_ms"] >= 0
    # The profiled slice ran with the spans on, and its slice reads as before.
    assert run.slice is not None and set(run.span_device) >= {root}
    assert not any(k.startswith("pogema.") for label in run.slice.idle for k in label.split(" > "))
    line = json.loads(json.dumps(spans.report(run, checks, "cpu")))
    assert line["correct"] and line["spans"][root]["calls"] == 1
    assert set(PROGRAM_SPAN[name]) <= set(line["metrics"])
    trace = harness.ROOT / "build" / "portbench" / f"spans.{name}.json"
    assert json.loads(trace.read_text())["traceEvents"][0]["name"] == root


@pytest.mark.parametrize("name", sorted(PROGRAM_SPAN))
def test_without_a_span_slice_every_span_metric_reads_nothing(name):
    untraced, _ = _measure(name, trace=False)
    traced, _ = tiny.run(tiny.cell(name), trace=True)  # the harness's own traced run
    for run in (untraced, traced):
        for metric in spans.METRICS:
            assert _read(metric, run) is None, metric


def test_device_and_idle_seconds_by_innermost_span():
    # Host: an episode [0, 100) holding a policy [10, 40) and a step
    # [50, 90) holding collisions [60, 80) (us).
    host = [(0, 100, "pogema.episode"), (10, 40, "pogema.policy"), (50, 90, "pogema.step"),
            (60, 80, "pogema.collisions")]
    us = [(s * 1000, e * 1000, n) for s, e, n in host]
    # Kernels (start, end, launch): two launched in the policy, one in the
    # collisions, one whose launch was not found; the last starts before
    # the slice ends and is clipped at 110.
    kernels = [(15, 30, 12), (25, 45, 20), (65, 70, 62), (92, 95, None), (105, 120, 85)]
    ks = [(s * 1000, e * 1000, None if l is None else l * 1000) for s, e, l in kernels]
    out = spans.by_span(us, ks, 0, 110_000)
    dev = {k: round(v["device_s"] * 1e6, 6) for k, v in out.items()}
    idle = {k: round(v["idle_s"] * 1e6, 6) for k, v in out.items()}
    assert dev == {"pogema.policy": 35.0, "pogema.collisions": 5.0, spans.OUTSIDE: 3.0,
                   "pogema.step": 5.0, "pogema.episode": 0.0}
    # Busy [15, 45) [65, 70) [92, 95) [105, 110); the episode's own time
    # is [0, 10) [40, 50) [90, 100), the step's [50, 60) [80, 90).
    assert idle == {"pogema.episode": 10 + 5 + 7, "pogema.policy": 5,
                    "pogema.step": 10 + 10, "pogema.collisions": 15, spans.OUTSIDE: 5}
    assert sum(idle.values()) == 110 - 30 - 5 - 3 - 5
    # Named by what the host was doing at each idle piece's midpoint.
    named = spans.by_span(us, ks, 0, 110_000, lambda t: "early" if t < 50_000 else "late")
    sites = {k: round(v * 1e6, 6) for k, v in named["pogema.episode"]["sites"].items()}
    assert sites == {"early": 10 + 5, "late": 2 + 5}


class _Ev:
    def __init__(self, name, s, d, dev=False, corr=0, linked=0):
        self._n, self._s, self._d, self._dev, self._c, self._l = name, s, d, dev, corr, linked

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def test_kernels_find_their_launch_by_correlation_id():
    events = [_Ev("pogema.policy", 0, 50), _Ev("aten::mm", 5, 10, corr=7),
              _Ev("cudaLaunchKernel", 8, 2, corr=900),
              _Ev("gemm", 20, 10, dev=True, corr=900, linked=7),
              _Ev("aten::add", 60, 5, corr=8),
              _Ev("add_kernel", 70, 5, dev=True, corr=901, linked=8),
              _Ev("lost", 80, 5, dev=True, corr=902, linked=99)]
    others, found, kernels = spans.split_events(events)
    assert found == [(0, 50, "pogema.policy")]
    assert [e.name() for e in others] == ["aten::mm", "cudaLaunchKernel", "gemm", "aten::add",
                                          "add_kernel", "lost"]
    # The runtime call's time where it is there, else the linked CPU op's.
    assert kernels == [(20, 30, 8), (70, 75, 60), (80, 85, None)]
