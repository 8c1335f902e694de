"""The ``regen`` auto-reset at config C's widths on the card (4096 envs x
64 agents on 64x64 mazes, r = 5, packed observations, 128-step
episodes): through the first ending step, at which every env ends and
gets a new maze, sampled envs are bit-equal to the plain reference
``portbench/reference/pogema_ref`` run on the card from their own reset
keys with their own actions; the regen counters grow by exactly the
ended envs, and the merge and the generator's spans show under
``profiling.tracing()`` on that step alone.

Every test needs a CUDA device (marker ``cuda``) and skips without one.
This file imports no JAX, so the card's machine runs it as it is:
``python -m pytest --noconftest tests/test_torch_regen_card.py``.
"""

import pytest
import torch

from pogema_torch import GridConfig, PogemaCore
from pogema_torch.core import generator
from pogema_torch.utils import profiling
from portbench.reference.pogema_ref.core import api as ref_api
from portbench.reference.pogema_ref.core import random as ref_jr
from portbench.reference.pogema_ref.grid_config import GridConfig as RefGridConfig

GRID = dict(size=64, num_agents=64, obs_radius=5, max_episode_steps=128,
            collision_system="priority", on_target="finish")
B = 4096
N = GRID["num_agents"]
END = GRID["max_episode_steps"]
ROWS = [0, 1, 255, 256, 1023, 1500, 2047, 2048, 2049, 3000, 3333, 3583, 4000, 4093, 4094, 4095]
CHECKED = (END - 1, END, END + 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: config C's regen step runs its kernels on the card")
    return "cuda"


def _rows(out, rows) -> dict:
    """Everything one ``step_autoreset`` returned, for ``rows`` only."""
    state, obs, res, done, metrics = out
    got = {f"state.{k}": v.index_select(0, rows) for k, v in state.tensors().items()}
    got.update(obs=obs.index_select(0, rows), pre_reset_obs=res.observations.index_select(0, rows))
    for k in ("rewards", "terminated", "truncated"):
        got[k] = getattr(res, k).index_select(0, rows)
    got["done"] = done.index_select(0, rows)
    got.update({f"metrics.{k}": v.index_select(0, rows) for k, v in metrics.items()})
    return got


def _actions(gen, device):
    return torch.randint(0, 5, (B, N), generator=gen, device=device, dtype=torch.int32)


@pytest.mark.cuda
def test_the_first_ending_step_at_config_c(card):
    core = PogemaCore(GridConfig(**GRID), num_envs=B, maze=True, auto_reset_mode="regen",
                      obs_layout="packed", device=card)
    key = core.make_key(2**31 + 11)
    state, _ = core.reset(key)
    init = state
    rows = torch.tensor(ROWS, device=card)
    gen = torch.Generator(device=card).manual_seed(11)
    saved, grown = {}, []
    envs, unplaced = PogemaCore._regen_reset.envs, generator.generate_env.unplaced
    for t in range(1, END + 2):
        before = PogemaCore._regen_reset.envs
        with profiling.tracing() as rec:
            out = core.step_autoreset(state, init, _actions(gen, card))
        grown.append(PogemaCore._regen_reset.envs - before)
        spans = rec.totals()
        assert ("pogema.autoreset.merge" in spans) == (t == END), t
        assert ("pogema.generator.place" in spans) == (t == END), t
        if t in CHECKED:
            saved[t] = _rows(out, rows)
        if t == END:
            assert bool(out[3].all())
            assert bool((out[0].obstacles != state.obstacles).flatten(1).any(1).all())
        state = out[0]
    assert grown == [B if t == END else 0 for t in range(1, END + 2)]
    assert PogemaCore._regen_reset.envs - envs == B
    assert generator.generate_env.unplaced == unplaced

    ref = ref_api.PogemaCore(RefGridConfig(**GRID), num_envs=len(ROWS), maze=True,
                             auto_reset_mode="regen", obs_layout="packed", device=card)
    rstate = ref._reset_envs(ref_jr.split(key, B).index_select(0, rows))
    rinit = rstate
    gen = torch.Generator(device=card).manual_seed(11)
    local = torch.arange(len(ROWS), device=card)
    for t in range(1, END + 2):
        out = ref.step_autoreset(rstate, rinit, _actions(gen, card).index_select(0, rows))
        rstate = out[0]
        if t in CHECKED:
            want = _rows(out, local)
            assert set(saved[t]) == set(want)
            for k, v in want.items():
                assert saved[t][k].dtype == v.dtype, (t, k)
                assert torch.equal(saved[t][k], v), (t, k)
