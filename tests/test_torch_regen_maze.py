"""The port's ``regen`` auto-reset on config C's kinds (sidewinder mazes,
``priority``, ``finish``) against the plain reference
``portbench/reference/pogema_ref`` (which imports neither package) on the
CPU, from seeded keys at small sizes: every ``EnvState`` leaf, both
observations, rewards, flags, ``done`` and the episode metrics bit-equal
at every step through several ending steps; a batch in which only some
envs end on a step; a draw that cannot be placed, which falls back to
the reset-time state; and the regen counters and the merge span."""

import pytest
import torch

from pogema_torch import GridConfig, PogemaCore
from pogema_torch.core import generator
from pogema_torch.utils import profiling
from portbench.reference.pogema_ref.core import api as ref_api
from portbench.reference.pogema_ref.core import generator as ref_generator
from portbench.reference.pogema_ref.grid_config import GridConfig as RefGridConfig

# Every episode is cut at 8 steps, so 20 steps hold two ending steps.
MAZE = dict(size=16, num_agents=8, obs_radius=2, max_episode_steps=8,
            collision_system="priority", on_target="finish")
# One agent on small mazes: some envs finish before the cut, others not.
SPARSE = dict(size=8, num_agents=1, obs_radius=2, max_episode_steps=24,
              collision_system="priority", on_target="finish")
B = 8


def _cores(grid, layout="packed"):
    kw = dict(num_envs=B, maze=True, auto_reset_mode="regen", obs_layout=layout, device="cpu")
    return (PogemaCore(GridConfig(**grid), **kw),
            ref_api.PogemaCore(RefGridConfig(**grid), **kw))


def _outputs(out) -> dict:
    """Everything one ``step_autoreset`` returned, by name."""
    state, obs, res, done, metrics = out
    got = {f"state.{k}": v for k, v in state.tensors().items()}
    got.update(obs=obs, pre_reset_obs=res.observations, rewards=res.rewards,
               terminated=res.terminated, truncated=res.truncated, done=done)
    got.update({f"metrics.{k}": v for k, v in metrics.items()})
    return got


def _assert_equal(got: dict, want: dict, where):
    assert set(got) == set(want), (where, sorted(set(got) ^ set(want)))
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k)
        assert torch.equal(got[k], want[k]), (where, k)


def _steps(grid, steps, seed, layout="packed"):
    """Step the port and the reference side by side on the same actions,
    asserting every output equal; per step, the number of envs that
    ended and the port's regen counter's growth."""
    port, ref = _cores(grid, layout)
    state, obs = port.reset(seed)
    rstate, robs = ref.reset(seed)
    assert torch.equal(obs, robs)
    _assert_equal(state.tensors(), rstate.tensors(), "reset")
    init, rinit = state, rstate
    gen = torch.Generator().manual_seed(seed)
    ended, counted = [], []
    for t in range(steps):
        actions = torch.randint(0, 5, (B, grid["num_agents"]), generator=gen, dtype=torch.int32)
        before = PogemaCore._regen_reset.envs
        out = port.step_autoreset(state, init, actions)
        counted.append(PogemaCore._regen_reset.envs - before)
        rout = ref.step_autoreset(rstate, rinit, actions)
        _assert_equal(_outputs(out), _outputs(rout), f"step {t + 1}")
        state, rstate = out[0], rout[0]
        ended.append(int(out[3].sum()))
    return ended, counted


@pytest.mark.parametrize("layout", ["packed", "grid"])
def test_regen_steps_bit_equal_to_the_reference(layout):
    ended, counted = _steps(MAZE, 20, seed=2**31 + 5, layout=layout)
    assert ended == [B if (t + 1) % 8 == 0 else 0 for t in range(20)]
    assert counted == ended


def test_a_subset_of_envs_regenerates():
    ended, counted = _steps(SPARSE, 40, seed=13)
    assert any(0 < e < B for e in ended), ended
    assert counted == ended


def _unplaceable(place):
    """``place`` with every env's placement reported failed."""

    def failing(cfg, keys, components):
        agents, targets, ok = place(cfg, keys, components)
        return agents, targets, torch.zeros_like(ok)

    return failing


def test_an_unplaceable_draw_falls_back_to_the_reset_state(monkeypatch):
    port, ref = _cores(MAZE)
    state, _ = port.reset(7)
    rstate, _ = ref.reset(7)
    init, rinit = state, rstate
    gen = torch.Generator().manual_seed(7)
    for _ in range(MAZE["max_episode_steps"] - 1):
        actions = torch.randint(0, 5, (B, MAZE["num_agents"]), generator=gen, dtype=torch.int32)
        state = port.step_autoreset(state, init, actions)[0]
        rstate = ref.step_autoreset(rstate, rinit, actions)[0]
    monkeypatch.setattr(generator, "place_agents_and_targets",
                        _unplaceable(generator.place_agents_and_targets))
    monkeypatch.setattr(ref_generator, "place_agents_and_targets",
                        _unplaceable(ref_generator.place_agents_and_targets))
    actions = torch.randint(0, 5, (B, MAZE["num_agents"]), generator=gen, dtype=torch.int32)
    unplaced, tries = generator.generate_env.unplaced, generator.generate_env.tries
    out = port.step_autoreset(state, init, actions)
    assert bool(out[3].all())
    assert generator.generate_env.unplaced - unplaced == B
    assert generator.generate_env.tries - tries == generator._MAX_TRIES
    _assert_equal(_outputs(out), _outputs(ref.step_autoreset(rstate, rinit, actions)), "fallback")
    # Every leaf is the reset-time state's but the key, which advanced.
    for k, v in out[0].tensors().items():
        if k != "key":
            assert torch.equal(v, getattr(init, k)), k
    assert torch.equal(out[0].key, ref_api._advance_key(state.key))
    assert not torch.equal(out[0].key, init.key)


def test_the_counters_and_the_merge_span_follow_the_ending_steps():
    port, _ = _cores(MAZE)
    state, _ = port.reset(3)
    init = state
    gen = torch.Generator().manual_seed(3)
    for t in range(1, MAZE["max_episode_steps"] + 1):
        actions = torch.randint(0, 5, (B, MAZE["num_agents"]), generator=gen, dtype=torch.int32)
        envs, unplaced = PogemaCore._regen_reset.envs, generator.generate_env.unplaced
        with profiling.tracing() as rec:
            state = port.step_autoreset(state, init, actions)[0]
        spans = rec.totals()
        ending = t == MAZE["max_episode_steps"]
        assert PogemaCore._regen_reset.envs - envs == (B if ending else 0)
        assert generator.generate_env.unplaced == unplaced
        assert spans["pogema.autoreset"]["calls"] == 1
        assert ("pogema.autoreset.merge" in spans) == ending
        assert ("pogema.generator.place" in spans) == ending
    merge = rec.names.index("pogema.autoreset.merge")
    assert rec.names[rec.parents[merge]] == "pogema.autoreset"
