"""Config E (worlds from the mixed random + maze pool, 256 agents, the
shipped ``.ckpt_maze256`` weights) at small sizes on the CPU:

* the benchmark's plain reference (``portbench/reference/pogema_ref``)
  resets from a map bank as ``pogema_tpu`` does, both halves of the pool
  drawn;
* a served greedy episode of ``pogema_torch`` with ``maze256.npz`` equals
  the reference's own episode, in float32 and in bfloat16, at 256 agents
  on small pool worlds: logits within the stated tolerances, final
  states and metrics exactly;
* the generator's counters: ``connected_components.sweeps`` against
  sweeps counted by hand, ``generate_env.tries`` for worlds that place at
  once, after retries and never.
"""

import os

import jax
import numpy as np
import pytest
import torch

import pogema_tpu
from pogema_torch import GridConfig, PogemaCore
from pogema_torch.core import generator
from pogema_torch.core import random as jr
from pogema_torch.interop import load_policy
from pogema_torch.maps import mixed_pool
from pogema_torch.parallel import make_policy_evaluator
from portbench import reference
from portbench.harness import load_module
from portbench.reference.pogema_ref.core import api as ref_api
from portbench.reference.pogema_ref.core import metrics as ref_metrics
from portbench.reference.pogema_ref.core import step as ref_step
from portbench.reference.pogema_ref.grid_config import GridConfig as RefGridConfig
from torch_parity import jax_state_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "pogema_torch", "weights", "maze256.npz")
# Config E's kinds at a small size: r = 5 (the shipped embedding reads
# 11 x 11 windows), 'restart', 256 agents on 32 x 32 pool worlds.
SERVE_GRID = dict(size=32, num_agents=256, obs_radius=5, density=0.3, on_target="restart",
                  max_episode_steps=32)
# float32: the same products summed in another order (the program's
# packed observation times the embedding against the reference's windows
# cut by slicing) part in the last bits. bfloat16: such a last-bit
# change can move a rounding of h by one bf16 ulp (2**-8 relative),
# which the GRU and the head carry into the logits; both scaled by the
# largest logit, at least 1.
LOGIT_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _pool_index(obstacles, bank, r):
    """The bank map each env's world is, by its inner (unpadded) cells."""
    inner = obstacles[:, r:-r, r:-r]
    return [int(np.argmax([(inner[b] == m).all() for m in bank])) for b in range(len(inner))]


def test_the_reference_map_bank_reset_equals_jax():
    bank = mixed_pool(24, k=8)
    grid = dict(size=24, num_agents=16, obs_radius=5, density=0.3, on_target="restart",
                max_episode_steps=16)
    jc = pogema_tpu.PogemaCore(pogema_tpu.GridConfig(**grid), num_envs=4, map_bank=bank,
                               device="cpu")
    rc = ref_api.PogemaCore(RefGridConfig(**grid), num_envs=4, map_bank=bank, device="cpu")
    js, jo = jc.reset(jax.random.key(3))
    rs, ro = rc.reset(torch.tensor(np.asarray(jax.random.key_data(jax.random.key(3))),
                                   dtype=torch.int64))
    want, got = jax_state_to_numpy(js), {k: v.numpy() for k, v in rs.tensors().items()}
    assert set(want) == set(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(ro.numpy(), np.asarray(jo))
    picked = _pool_index(got["obstacles"], bank, grid["obs_radius"])
    # Both halves of the pool: Bernoulli maps 0-3 and braided mazes 4-7.
    assert min(picked) < 4 <= max(picked), picked


def _reference_episode(bank, dtype, key, num_envs):
    """The reference's own greedy episode: its reset from ``key``, its
    policy from the shipped weights, its greedy actions."""
    rc = ref_api.PogemaCore(RefGridConfig(**SERVE_GRID), num_envs=num_envs, map_bank=bank,
                            device="cpu")
    cfg = rc.cfg
    model = reference.recurrent_model(WEIGHTS, "cpu", dtype)
    logits_seen = []
    with reference.plain_precision(), torch.no_grad():
        state, _ = rc.reset(key, with_obs=False)
        h = model.initial_carry((num_envs, cfg.num_agents))
        for _ in range(cfg.max_episode_steps):
            done = ref_step.episode_done(cfg, state)
            h, logits, _ = model.step_from_state(state.obstacles, state.agents_xy,
                                                 state.targets_xy, state.active, h)
            logits_seen.append(logits)
            new_state, _ = ref_step.step(cfg, state, logits.argmax(dim=-1).to(torch.int32),
                                         with_obs=False)
            state = ref_api.select_state(done, state, new_state)
    return state, ref_metrics.episode_metrics(cfg, state), logits_seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_a_served_episode_equals_the_reference(dtype):
    bank = mixed_pool(32, k=4)
    core = PogemaCore(GridConfig(**SERVE_GRID), num_envs=2, map_bank=bank, device="cpu",
                      obs_layout="packed")
    # The benchmark's recorder, keeping every env's logits at every step.
    recorder = load_module("drivers", "serve")._Recorder(
        load_policy(WEIGHTS, device="cpu", dtype=dtype), torch.arange(2))
    key = core.make_key(11)
    state, metrics = make_policy_evaluator(core, recorder, greedy=True)(key)
    ref_state, ref_metrics_, ref_logits = _reference_episode(bank, dtype, key, 2)

    assert len(recorder.logits) == len(ref_logits) == SERVE_GRID["max_episode_steps"]
    for t, (got, want) in enumerate(zip(recorder.logits, ref_logits)):
        scale = max(1.0, float(want.abs().max()))
        err = float((got.float() - want.float()).abs().max())
        assert err <= LOGIT_TOL[dtype] * scale, (t, err, scale)
    assert reference.mismatches(state.tensors(), ref_state.tensors()) == 0
    assert reference.mismatches(metrics, ref_metrics_) == 0
    # Both halves of the pool, and a team that moved.
    picked = _pool_index(state.obstacles.numpy(), bank, SERVE_GRID["obs_radius"])
    assert min(picked) < 2 <= max(picked), picked
    assert float(metrics["avg_throughput"].sum()) > 0


def _snake(corridors: int, side: int = 13) -> torch.Tensor:
    """u8[1, side, side]: obstacles but for ``corridors`` free rows (1, 3,
    5, ...), each joined to the next by one free cell at its right end,
    then its left, and so on."""
    g = torch.ones(1, side, side, dtype=torch.uint8)
    for i in range(corridors):
        g[0, 2 * i + 1, 1:-1] = 0
        if i:
            g[0, 2 * i, side - 2 if i % 2 else 1] = 0
    return g


@pytest.mark.parametrize("corridors", [1, 4, 6])
def test_component_sweeps_are_counted_by_hand(corridors):
    """The minimum label sits at the top left. Sweep s (rows both ways,
    then columns both ways) floods corridor s - 1 along its row and
    carries the label down through the next connector; one more sweep
    finds no change: corridors + 1 sweeps in all."""
    grid = _snake(corridors)
    before = generator.connected_components.sweeps
    comps = generator.connected_components(grid)
    assert generator.connected_components.sweeps - before == corridors + 1
    free = grid.reshape(1, -1) == 0
    assert (comps[free] == int(free[0].nonzero()[0])).all()  # one component


def test_an_open_world_takes_two_sweeps():
    grid = torch.nn.functional.pad(torch.zeros(3, 6, 6, dtype=torch.uint8), (1, 1, 1, 1), value=1)
    before = generator.connected_components.sweeps
    generator.connected_components(grid)
    assert generator.connected_components.sweeps - before == 2


@pytest.mark.parametrize("maps,tries", [("open", 1), ("walled", generator._MAX_TRIES),
                                        ("both", None)])
def test_placement_tries_are_counted(maps, tries):
    """An open world places at once; a world with two free cells cannot
    hold four agents and is drawn again until the loop gives up; with
    both in the bank, the envs that drew the walled one draw again."""
    open_map = np.zeros((8, 8), np.uint8)
    walled = np.ones((8, 8), np.uint8)
    walled[3, 3:5] = 0
    bank = {"open": [open_map], "walled": [walled], "both": [open_map, walled]}[maps]
    cfg = GridConfig(size=8, num_agents=4, obs_radius=1, max_episode_steps=8).to_static()
    before = generator.generate_env.tries
    *_, ok = generator.generate_env(cfg, jr.split(jr.key(0), 8),
                                    map_bank=torch.as_tensor(np.stack(bank)))
    counted = generator.generate_env.tries - before
    if tries is None:
        assert 1 < counted < generator._MAX_TRIES and bool(ok.all()), counted
    else:
        assert counted == tries
        assert bool(ok.all()) == (maps == "open")
