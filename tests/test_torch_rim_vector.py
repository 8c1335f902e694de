"""The port's ``PogemaVectorEnv`` against the benchmark's plain SAME_STEP
adapter (``portbench/reference/pogema_ref/integrations/vector.py``, which
imports neither package) on the CPU: every array of the reset and of
each step bit-equal in values, dtypes and shapes, through several
ending steps, in the packed and the grid layout; the reference's
sampled rows step as they do in the whole batch; the rim's spans under
``profiling.tracing()``; and ``fetch.bytes``, which CPU tensors leave
unchanged."""

import numpy as np
import pytest
import torch

from pogema_torch import GridConfig, PogemaVectorEnv
from pogema_torch.utils import host, profiling
from portbench.reference.pogema_ref.grid_config import GridConfig as RefGridConfig
from portbench.reference.pogema_ref.integrations.vector import VectorEnv as RefVectorEnv

# Config C's kinds (mazes, 'priority', 'finish') at a small size: every
# episode is cut at 8 steps, so 20 steps hold two ending steps.
GRID = dict(size=16, num_agents=8, obs_radius=2, max_episode_steps=8,
            collision_system="priority", on_target="finish")
B = 8
STEPS = 20


def _assert_equal(got, want, where):
    """Bit-equal trees of numpy arrays (tuples, dicts with the same keys)."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_equal(a, b, f"{where}[{i}]")
        return
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_equal(got[k], want[k], f"{where}/{k}")
        return
    assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray), where
    assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=where)


def _envs(layout, mode):
    port = PogemaVectorEnv(GridConfig(**GRID), num_vec_envs=B, obs_layout=layout,
                           auto_reset_mode=mode, maze=True, device="cpu")
    ref = RefVectorEnv(RefGridConfig(**GRID), B, obs_layout=layout, auto_reset_mode=mode,
                       maze=True, device="cpu")
    return port, ref


@pytest.mark.parametrize("layout,mode", [("packed", "cached"), ("grid", "cached"),
                                         ("packed", "regen")])
def test_bit_equal_to_the_plain_reference(layout, mode):
    port, ref = _envs(layout, mode)
    _assert_equal(port.reset(seed=11), ref.reset(seed=11), "reset")
    rng = np.random.default_rng(3)
    ends = 0
    for t in range(STEPS):
        a = rng.integers(0, 5, size=port.num_envs, dtype=np.int32)
        got = port.step(a)
        _assert_equal(got, ref.step(a), f"step {t}")
        if "final_obs" in got[4]:
            ends += 1
            mask = got[4]["_final_obs"]
            assert not got[4]["final_obs"][~mask].any()
    assert ends >= 2


def test_the_reference_rows_step_as_in_the_whole_batch():
    """The benchmark's check steps only the sampled envs, from their own
    reset keys with their own slots' actions."""
    rows = [1, 4, 6]
    slots = (np.asarray(rows)[:, None] * GRID["num_agents"]
             + np.arange(GRID["num_agents"])).reshape(-1)
    whole = RefVectorEnv(RefGridConfig(**GRID), B, obs_layout="packed", maze=True)
    part = RefVectorEnv(RefGridConfig(**GRID), B, obs_layout="packed", maze=True, rows=rows)
    _assert_equal(part.reset(seed=5)[0], whole.reset(seed=5)[0][slots], "reset")
    rng = np.random.default_rng(4)
    for t in range(STEPS):
        a = rng.integers(0, 5, size=B * GRID["num_agents"], dtype=np.int32)
        w = whole.step(a)
        p = part.step(a[slots])
        _assert_equal(p[:4], tuple(x[slots] for x in w[:4]), f"step {t}")
        _assert_equal(p[4], {k: v[slots] for k, v in w[4].items()}, f"step {t} infos")


def test_the_rim_spans_and_the_terminal_rows_counter():
    env = PogemaVectorEnv(GridConfig(**GRID), num_vec_envs=B, obs_layout="packed", maze=True,
                          device="cpu")
    env.reset(seed=2)
    rng = np.random.default_rng(5)
    rows = PogemaVectorEnv._final_obs.rows
    ended = ending_steps = 0
    steps = GRID["max_episode_steps"]
    with profiling.tracing() as rec:
        for _ in range(steps):
            infos = env.step(rng.integers(0, 5, size=env.num_envs))[4]
            if "final_obs" in infos:
                ending_steps += 1
                ended += int(infos["_final_obs"].sum()) // GRID["num_agents"]
    assert ending_steps >= 1 and ended >= 1
    totals = rec.totals()
    assert totals["pogema.vector.step"]["calls"] == steps
    assert totals["pogema.vector.final_obs"]["calls"] == ending_steps
    # One copy a step, and one more on a step where episodes end.
    assert totals["pogema.host.fetch"]["calls"] == steps + ending_steps
    parents = {(rec.names[i], rec.names[p] if p >= 0 else None)
               for i, p in enumerate(rec.parents)}
    assert ("pogema.vector.final_obs", "pogema.vector.step") in parents
    assert ("pogema.host.fetch", "pogema.vector.final_obs") in parents
    assert ("pogema.step_autoreset", "pogema.vector.step") in parents
    assert PogemaVectorEnv._final_obs.rows - rows == ended


def test_fetch_adds_no_bytes_for_cpu_tensors():
    before = host.fetch.bytes
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    out = host.fetch({"a": t, "b": [torch.zeros(2, dtype=torch.bool)], "c": 7})
    assert host.fetch.bytes == before
    np.testing.assert_array_equal(out["a"], t.numpy())
    assert out["c"] == 7
    env = PogemaVectorEnv(GridConfig(**GRID), num_vec_envs=2, obs_layout="packed", maze=True,
                          device="cpu")
    env.reset(seed=1)
    for _ in range(GRID["max_episode_steps"]):
        env.step(np.zeros(env.num_envs, np.int32))
    assert host.fetch.bytes == before
    assert host.nbytes({"a": t}) == 48
