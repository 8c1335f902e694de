"""The port's utilities against pogema_tpu's, on the CPU.

* ``utils.oracle.OracleEnv``: the port's copy and the JAX one, driven by
  the same seeded states and actions for every collision system x
  on_target, give equal positions, rewards, flags, activity and
  observations (exact: integers, 0/1 floats).
* ``utils.validation.validate_state``: the same messages as the JAX
  function on the same clean and dirtied states (exact).
* ``utils.profiling``: ``ThroughputMeter`` (CPU, and refusing "cuda"
  without a card), ``trace_region`` and ``capture_trace`` writing a
  trace that holds the region.
"""

import json

import numpy as np
import pytest
import torch

import pogema_torch
import pogema_tpu
from pogema_torch.interop import state_from_numpy
from pogema_torch.utils import OracleEnv
from pogema_torch.utils.profiling import ThroughputMeter, capture_trace, trace_region
from pogema_torch.utils.validation import validate_state
from pogema_tpu.utils.oracle import OracleEnv as JaxOracleEnv
from pogema_tpu.utils.validation import validate_state as jax_validate_state

from torch_parity import jax_state_to_numpy


def _random_world(rng, size, n, r):
    """A bordered grid with n distinct free agent cells and targets."""
    p = size + 2 * r
    grid = np.ones((p, p), np.uint8)
    grid[r:r + size, r:r + size] = rng.random((size, size)) < 0.2
    free = np.argwhere(grid == 0)
    pick = rng.choice(len(free), size=2 * n, replace=False)
    return grid, free[pick[:n]].astype(np.int32), free[pick[n:]].astype(np.int32)


@pytest.mark.parametrize("on_target", ["finish", "nothing", "restart"])
@pytest.mark.parametrize("system", ["priority", "block_both", "soft"])
def test_oracle_equals_the_jax_oracle(system, on_target):
    kw = dict(size=8, num_agents=6, obs_radius=2, max_episode_steps=10,
              collision_system=system, on_target=on_target)
    rng = np.random.default_rng(len(system) * 10 + len(on_target))
    for episode in range(3):
        grid, agents, targets = _random_world(rng, 8, 6, 2)
        active = list(rng.random(6) > 0.2)
        ours = OracleEnv(pogema_torch.GridConfig(**kw).to_static(), grid, agents, targets,
                         active=active)
        ref = JaxOracleEnv(pogema_tpu.GridConfig(**kw).to_static(), grid, agents, targets,
                           active=active)
        np.testing.assert_array_equal(ours.observe(), ref.observe())
        for t in range(10):
            actions = rng.integers(0, 5, size=6)
            assert ours.step(actions) == ref.step(actions), (episode, t)
            assert ours.agents_xy == ref.agents_xy and ours.active == ref.active
            assert ours.goals_achieved == ref.goals_achieved
            assert ours.on_goal_ever == ref.on_goal_ever and ours.step_count == ref.step_count
            np.testing.assert_array_equal(ours.observe(), ref.observe())


def _jax_state(seed):
    core = pogema_tpu.PogemaCore(pogema_tpu.GridConfig(seed=0, size=8, density=0.2, num_agents=3,
                                                       obs_radius=2, max_episode_steps=8),
                                 num_envs=2, device="cpu")
    state, _ = core.reset(seed)
    return core, state


@pytest.mark.parametrize("dirt", ["clean", "on_obstacle", "shared_cell", "out_of_bounds",
                                  "target_on_obstacle", "step_count"])
def test_validate_state_messages_equal_the_jax_ones(dirt):
    import jax.numpy as jnp

    core, state = _jax_state(0)
    if dirt == "on_obstacle":  # onto the border ring: an obstacle and the border
        state = state.replace(agents_xy=state.agents_xy.at[0, 0].set(jnp.asarray([0, 0])))
    elif dirt == "shared_cell":
        state = state.replace(agents_xy=state.agents_xy.at[1, 1].set(state.agents_xy[1, 0]))
    elif dirt == "out_of_bounds":
        state = state.replace(agents_xy=state.agents_xy.at[0, 2].set(jnp.asarray([-1, 3])))
    elif dirt == "target_on_obstacle":
        state = state.replace(targets_xy=state.targets_xy.at[1, 0].set(jnp.asarray([0, 1])))
    elif dirt == "step_count":
        state = state.replace(step_count=state.step_count.at[1].set(99))
    want = jax_validate_state(core.cfg, state)
    assert (want == []) == (dirt == "clean")
    port_cfg = pogema_torch.GridConfig(seed=0, size=8, density=0.2, num_agents=3, obs_radius=2,
                                       max_episode_steps=8).to_static()
    assert validate_state(port_cfg, state_from_numpy(jax_state_to_numpy(state), "cpu")) == want


def test_validate_state_of_the_port_core():
    core = pogema_torch.PogemaCore(pogema_torch.GridConfig(seed=0, size=8, density=0.2,
                                                           num_agents=3, obs_radius=2),
                                   num_envs=2, device="cpu")
    state, _ = core.reset(0)
    assert validate_state(core.cfg, state) == []
    bad = state.replace(agents_xy=state.agents_xy.clone().index_fill_(1, torch.tensor([0]), 0))
    assert any("obstacle" in e for e in validate_state(core.cfg, bad))


def test_throughput_meter(monkeypatch):
    m = ThroughputMeter(device="cpu")
    m.add(1000)
    m.add(24)
    assert m.lap() > 0 and m._steps == 0  # a lap starts a new window
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ThroughputMeter()


def test_trace_region_and_capture_trace(tmp_path):
    with capture_trace(str(tmp_path / "trace")):
        with trace_region("pogema_region"):
            torch.ones(64).cumsum(0)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "pogema_region" for e in events)
    with trace_region("outside_a_trace"):  # no profiler: a no-op
        pass
