"""The port's wrappers against ``pogema_tpu``'s on the CPU: the metric
wrappers give the JAX wrappers' numbers and the core's
``episode_metrics``; ``MultiTimeLimit``; the persistence history and its
replay."""

import warnings

import numpy as np
import pytest

import pogema_torch
import pogema_torch.wrappers as tw
import pogema_tpu
import pogema_tpu.wrappers as jw
from torch_parity import assert_host_equal, rim_episode

BASE = dict(size=8, density=0.2, num_agents=6, obs_radius=2, max_episode_steps=24)


def _actions(n, steps, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 5, size=n).tolist() for _ in range(steps)]


def _wrap(mod, env, names):
    for name in names:
        env = getattr(mod, name)(env)
    return env


# name of each wrapper -> the core metric it must reproduce (None: no core
# counterpart)
DISAPPEAR = {"ISRMetric": "ISR", "CSRMetric": "CSR", "EpLengthMetric": "ep_length"}
NON_DISAPPEAR = {"NonDisappearISRMetric": "ISR", "NonDisappearCSRMetric": "CSR",
                 "NonDisappearEpLengthMetric": "ep_length"}
LIFELONG = {"LifeLongAverageThroughputMetric": "avg_throughput", "LifeLongAttritionMetric": None,
            "EpLengthMetric": "ep_length"}


@pytest.mark.parametrize("on_target,wrappers,seed", [
    ("finish", DISAPPEAR, 18), ("nothing", NON_DISAPPEAR, 4), ("restart", LIFELONG, 3)])
def test_metric_wrappers_match_jax_and_core(on_target, wrappers, seed):
    kw = dict(BASE, seed=seed, on_target=on_target, size=6)
    acts = _actions(6, 24, seed=seed)
    # The core's own metrics, from the port's bare env.
    bare = rim_episode(pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw), device="cpu"), acts)
    core = bare[-1][4][0]["metrics"]
    names = list(wrappers) + ["RuntimeMetricWrapper"]
    je = _wrap(jw, pogema_tpu.pogema_v0(pogema_tpu.GridConfig(**kw)), names)
    te = _wrap(tw, pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw), device="cpu"), names)
    j, t = rim_episode(je, acts), rim_episode(te, acts)
    # Every agent's info carries the metrics; the wall-clock runtime
    # differs between the packages and is compared to nothing.
    for ji, ti in zip(j[-1][4], t[-1][4]):
        jm, tm = ji.pop("metrics"), ti.pop("metrics")
        assert tm.pop("runtime") >= 0 and jm.pop("runtime") >= 0
        assert jm == tm, (jm, tm)
    assert_host_equal(j, t, on_target)
    # The wrappers count in Python floats, the core in float32: equal once
    # rounded to float32.
    for name, key in wrappers.items():
        if key is not None:
            assert np.float32(tm[key]) == np.float32(core[key]), (name, tm[key], core[key])
    if on_target == "restart":
        assert tm["attrition"] == pytest.approx(tm["avg_throughput"] * tm["ep_length"] / 6)
    else:
        assert 0 < core["ep_length"] <= 24


def test_isr_csr_decline_under_lifelong():
    env = tw.CSRMetric(tw.ISRMetric(tw.LifeLongAverageThroughputMetric(
        pogema_torch.PogemaLifeLong(pogema_torch.GridConfig(**dict(BASE, seed=5,
                                                                   max_episode_steps=6)),
                                    device="cpu"))))
    env.reset()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for a in _actions(6, 6, seed=0):
            *_, infos = env.step(a)
        assert any("undefined under" in str(x.message) for x in w)
    assert set(infos[0]["metrics"]) == {"avg_throughput", "ep_length"}


def test_multi_time_limit():
    kw = dict(BASE, seed=2, max_episode_steps=64)
    je = jw.MultiTimeLimit(pogema_tpu.pogema_v0(pogema_tpu.GridConfig(**kw)), 5)
    te = tw.MultiTimeLimit(pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw), device="cpu"), 5)
    acts = _actions(6, 8, seed=1)
    j, t = rim_episode(je, acts), rim_episode(te, acts)
    assert_host_equal(j, t)
    assert len(t) == 6 and all(t[-1][3]) and not any(t[-2][3])


def test_persistence_history_replay():
    kw = dict(BASE, seed=21)
    je = jw.PersistentWrapper(pogema_tpu.pogema_v0(pogema_tpu.GridConfig(**kw)))
    te = tw.PersistentWrapper(pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw), device="cpu"),
                              xy_offset=0)
    te.reset(), je.reset()
    positions = [te.unwrapped.get_agents_xy()]
    for a in _actions(6, 5, seed=1):
        assert_host_equal(je.step(a), te.step(a))
        positions.append(te.unwrapped.get_agents_xy())
    history = te.get_history()
    assert len(history) == 6
    for step, snap in enumerate(history):
        assert [s.get_xy() for s in snap] == positions[step]
        assert all(s.step == step for s in snap)
    data = tw.PersistentWrapper.compact(history)
    assert data == jw.PersistentWrapper.compact(je.get_history())
    assert tw.PersistentWrapper.decompact(data) == history
    full = te.get_full_history()
    assert len(full) == 6 and len(full[0]) == 6
    assert te.get_targets_xy() == je.get_targets_xy() and te.active == je.active
    assert_host_equal(te.get_obstacles(), je.get_obstacles())
