"""The port's spans (``utils.profiling``), on the CPU.

* Off (no ``tracing()``, no profiler): ``trace_region`` hands out one
  shared no-op, enters no ``record_function`` and records nothing, at a
  small fraction of ``record_function``'s cost.
* ``tracing()``: one ``step_autoreset`` gives exactly the documented span
  tree (cached and regen auto-reset), an evaluator episode gives
  ``pogema.episode`` > ``pogema.reset`` > the generator's four stages and
  one ``pogema.policy`` a step; the recorder's self times, totals and
  Chrome trace add up.
* States and observations are bit-equal with spans recorded, under a
  profiler, and off.
"""

import contextlib
import json
import timeit

import pytest
import torch

import pogema_torch
from pogema_torch.models import init_recurrent_params
from pogema_torch.parallel import make_policy_evaluator
from pogema_torch.utils import profiling
from pogema_torch.utils.profiling import trace_region, tracing

GRID = dict(seed=0, size=10, density=0.2, num_agents=6, obs_radius=2, max_episode_steps=8)


def _core(**kw):
    grid = dict(GRID, on_target=kw.pop("on_target", "finish"),
                max_episode_steps=kw.pop("max_episode_steps", GRID["max_episode_steps"]))
    return pogema_torch.PogemaCore(pogema_torch.GridConfig(**grid), num_envs=3,
                                   obs_layout="packed", device="cpu", **kw)


def _actions(core, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 5, (core.num_envs, core.cfg.num_agents), generator=g,
                         dtype=torch.int32)


def _tree(rec):
    """[(name, parent name)] in opening order."""
    return [(n, rec.names[p] if p >= 0 else None) for n, p in zip(rec.names, rec.parents)]


def _assert_nested(rec):
    for i, p in enumerate(rec.parents):
        assert rec.starts[i] <= rec.ends[i]
        if p >= 0:
            assert rec.starts[p] <= rec.starts[i] and rec.ends[i] <= rec.ends[p]


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with tracing off")


def test_off_enters_no_record_function_and_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    assert trace_region("pogema.a") is trace_region("pogema.b")  # one shared no-op
    core = _core()
    state, _ = core.reset(1)
    core.step_autoreset(state, state, _actions(core, 0))
    assert profiling._recorder is None
    with tracing() as rec:
        pass
    assert rec.names == []


def test_under_a_profiler_a_span_is_a_host_op_not_a_user_annotation():
    # A user annotation is also drawn on the device's timeline (a CUDA
    # trace's busy time would take it for device work); a host op is not.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_region("pogema.span"):
            torch.ones(8).sum()
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "pogema.span"]
    assert len(events) == 1 and not events[0].is_user_annotation()
    assert events[0].device_type() == torch.autograd.DeviceType.CPU


def test_off_costs_a_small_share_of_record_function():
    def off():
        with trace_region("pogema.off"):
            pass

    def rf():
        with torch.profiler.record_function("pogema.rf"):
            pass

    t_off = min(timeit.repeat(off, number=20000, repeat=5)) / 20000
    t_rf = min(timeit.repeat(rf, number=2000, repeat=5)) / 2000
    assert t_off < t_rf / 4, (t_off, t_rf)


STEP_TREE = [("pogema.step_autoreset", None), ("pogema.step", "pogema.step_autoreset"),
             ("pogema.collisions", "pogema.step"), ("pogema.autoreset", "pogema.step_autoreset")]
OBSERVE = [("pogema.observe", "pogema.step_autoreset")] * 2
GENERATOR = [("pogema.generator.map", "pogema.autoreset"),
             ("pogema.generator.components", "pogema.autoreset"),
             ("pogema.generator.place", "pogema.autoreset")]


@pytest.mark.parametrize("mode,on_target,tree", [
    ("cached", "finish", STEP_TREE + OBSERVE),
    ("regen", "restart", STEP_TREE + GENERATOR + [("pogema.generator.queue", "pogema.autoreset"),
                                                  ("pogema.autoreset.merge", "pogema.autoreset")]
     + OBSERVE),
], ids=["cached", "regen"])
def test_step_autoreset_span_tree(mode, on_target, tree):
    # One-step episodes: with regen every env draws a new world this step.
    core = _core(auto_reset_mode=mode, on_target=on_target, max_episode_steps=1)
    state, _ = core.reset(2)
    with tracing() as rec:
        core.step_autoreset(state, state, _actions(core, 1))
    assert _tree(rec) == tree
    _assert_nested(rec)


def test_evaluator_episode_span_tree():
    core = _core(on_target="restart")
    model, _ = init_recurrent_params(torch.Generator().manual_seed(0), 5, embed=8, hidden=8,
                                     dtype=torch.float32)
    run = make_policy_evaluator(core, model)
    with tracing() as rec:
        run(core.make_key(3))
    _assert_nested(rec)
    tree = _tree(rec)
    t = core.cfg.max_episode_steps
    assert tree[0] == ("pogema.episode", None)
    assert tree[1:6] == [("pogema.reset", "pogema.episode")] + [
        (f"pogema.generator.{s}", "pogema.reset") for s in ("map", "components", "place", "queue")]
    loop = [("pogema.policy", "pogema.episode"), ("pogema.step", "pogema.episode"),
            ("pogema.collisions", "pogema.step")]
    assert tree[6:] == loop * t
    totals = rec.totals()
    assert totals["pogema.policy"]["calls"] == t and totals["pogema.episode"]["calls"] == 1


def test_recorder_self_times_totals_and_chrome_trace(tmp_path):
    with tracing() as rec:
        with trace_region("pogema.outer"):
            for _ in range(2):
                with trace_region("pogema.inner"):
                    torch.ones(8).sum()
        with tracing() as inner_rec:  # a nested recorder records alone
            with trace_region("pogema.apart"):
                pass
    assert rec.names == ["pogema.outer", "pogema.inner", "pogema.inner"]
    assert inner_rec.names == ["pogema.apart"]
    own = rec.self_ns()
    assert own[0] == (rec.ends[0] - rec.starts[0]) - sum(rec.ends[i] - rec.starts[i]
                                                          for i in (1, 2))
    totals = rec.totals()
    assert totals["pogema.inner"]["calls"] == 2
    assert totals["pogema.inner"]["ns"] == totals["pogema.inner"]["self_ns"] == own[1] + own[2]
    assert totals["pogema.outer"]["self_ns"] == own[0] >= 0
    path = tmp_path / "spans" / "trace.json"
    rec.to_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in events] == rec.names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert profiling._recorder is None


def _drive(core, model, listen):
    """Four auto-reset steps and one evaluated episode, every tensor kept."""
    out = []
    with listen():
        state, obs = core.reset(4)
        init = state
        out += [*state.tensors().values(), obs]
        for t in range(4):
            state, obs, res, done, metrics = core.step_autoreset(state, init, _actions(core, t))
            out += [*state.tensors().values(), obs, res.observations, res.rewards, done,
                    *metrics.values()]
        final, metrics = make_policy_evaluator(core, model)(core.make_key(5))
        out += [*final.tensors().values(), *metrics.values()]
    return out


@pytest.mark.parametrize("listen", ["tracing", "profiler"])
def test_spans_leave_states_and_observations_bit_equal(listen):
    core = _core(on_target="restart", max_episode_steps=3)
    model, _ = init_recurrent_params(torch.Generator().manual_seed(1), 5, embed=8, hidden=8,
                                     dtype=torch.float32)
    on = {"tracing": tracing,
          "profiler": lambda: torch.profiler.profile(
              activities=[torch.profiler.ProfilerActivity.CPU])}[listen]
    want = _drive(core, model, contextlib.nullcontext)
    got = _drive(core, model, on)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
