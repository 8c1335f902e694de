"""K9's plain version and its wrapper on the CPU.

* The plain version, ``ops/placement.py``, equals the JAX package's
  ``place_agents_and_targets`` on every grid family of
  ``component_grids.py``, including worlds with fewer eligible cells than
  agents, components too small for the agents placed in them (an agent
  whose component holds only itself and earlier targets) and agents
  placed on obstacles.
* The wrapper, ``ops/cuda_placement.py``, returns the plain version for
  tensors on the CPU, and refuses what the kernel does not take.
* ``core.generator.place_agents_and_targets`` goes through the wrapper
  under its span.

The kernel itself runs only on a card: ``test_torch_placement_card.py``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from component_grids import EXTREMES, WORLDS, grids
from pogema_torch import GridConfig
from pogema_torch.core import generator
from pogema_torch.ops import cuda_placement, placement
from pogema_torch.utils import profiling
from pogema_tpu.core import generator as jgen


def _inputs(grid, seed):
    """Keys (int64 and JAX's typed keys) and labels (torch, JAX) of a grid."""
    b = grid.shape[0]
    words = np.random.default_rng(seed).integers(0, 2**32, (b, 2), dtype=np.uint64)
    keys = torch.as_tensor(words.astype(np.int64))
    jkeys = jax.random.wrap_key_data(jnp.asarray(words.astype(np.uint32)))
    labels = generator.connected_components(torch.as_tensor(grid))
    jlabels = jax.vmap(jgen.connected_components)(jnp.asarray(grid))
    return keys, jkeys, labels, jlabels


def _jax_place(jkeys, jlabels, p, n):
    cfg = SimpleNamespace(padded_size=p, num_agents=n)
    out = jax.vmap(lambda k, c: jgen.place_agents_and_targets(cfg, k, c))(jkeys, jlabels)
    return [np.asarray(x) for x in out]


def _assert_equals_jax(grid, n, seed=0):
    p = grid.shape[-1]
    keys, jkeys, labels, jlabels = _inputs(grid, seed)
    got = placement.place_agents_and_targets(keys, labels, p, n)
    want = _jax_place(jkeys, jlabels, p, n)
    assert got[0].dtype == got[1].dtype == torch.int64 and got[2].dtype == torch.bool
    for name, g, w in zip(("agent_cells", "target_cells", "ok"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    return got, labels


# (family, P, N): the worlds at a side of 26 (16 x 16 inside the border),
# the extremes at 12, each with one agent, a few and more than most
# components hold.
CASES = ([(family, 26, n) for family in WORLDS for n in (1, 9, 40)]
         + [(family, 12, n) for family in EXTREMES for n in (1, 9, 40)])


@pytest.mark.parametrize("family,p,n", CASES)
def test_plain_version_equals_jax(family, p, n):
    _assert_equals_jax(grids(family, 3, p, seed=p + n), n, seed=n)


def test_fewer_eligible_cells_than_agents():
    # Isolated cells on the even lattice have no free neighbour in the
    # grid, but at an odd side the wrap joins the last column to the first
    # (the eligibility mask wraps, the components do not): few cells are
    # eligible, and the lowest ineligible cells take the rest.
    grid = grids("isolated", 4, 13)
    (agents, _, ok), labels = _assert_equals_jax(grid, 30, seed=3)
    eligible = placement.multi_cell_component(labels, 13)
    assert 0 < int(eligible.sum(1).max()) < 30
    assert not bool(ok.any())
    assert bool((labels.gather(1, agents) == 13 * 13).any())  # obstacles among them


def test_agents_whose_components_hold_only_themselves_and_earlier_targets():
    # Three-cell runs with an agent on every free cell: the third agent of
    # a run finds every other cell of it taken as a target.
    grid = grids("trominoes", 3, 12)
    free = int((grid[0] == 0).sum())
    (agents, targets, ok), labels = _assert_equals_jax(grid, free, seed=4)
    assert not bool(ok.any())
    comp = labels.gather(1, agents)
    assert bool((comp < 144).all())  # every agent on a free cell of a run


def test_an_agent_on_an_obstacle():
    grid = grids("walls", 2, 7)
    (agents, targets, ok), _ = _assert_equals_jax(grid, 3, seed=5)
    assert agents.tolist() == [[0, 1, 2]] * 2 and targets.tolist() == [[0, 0, 0]] * 2
    assert not bool(ok.any())


def test_the_wrapper_on_the_cpu_returns_the_plain_version(monkeypatch):
    calls = []
    plain = placement.place_agents_and_targets

    def spy(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(placement, "place_agents_and_targets", spy)
    grid = grids("pool", 2, 26, seed=1)
    keys, _, labels, _ = _inputs(grid, 1)
    got = cuda_placement.place_agents_and_targets(keys, labels, 26, 12)
    assert len(calls) == 1
    for g, w in zip(got, plain(keys, labels, 26, 12)):
        assert torch.equal(g, w)


def test_core_goes_through_the_wrapper_under_its_span(monkeypatch):
    calls = []
    wrapper = cuda_placement.place_agents_and_targets

    def spy(keys, labels, p, n):
        calls.append((keys.is_contiguous(), p, n))
        return wrapper(keys, labels, p, n)

    monkeypatch.setattr(cuda_placement, "place_agents_and_targets", spy)
    cfg = GridConfig(size=10, num_agents=6, obs_radius=2).to_static()
    keys = torch.as_tensor(np.random.default_rng(2).integers(0, 2**32, (3, 2)), dtype=torch.int64)
    tries = generator.generate_env.tries
    with profiling.tracing() as rec:
        out = generator.generate_env(cfg, keys)
    tries = generator.generate_env.tries - tries
    assert calls == [(True, 14, 6)] * tries
    assert "pogema.generator.place" in rec.totals()
    assert bool(out[-1].all())


def test_an_empty_batch():
    keys = torch.zeros(0, 2, dtype=torch.int64)
    agents, targets, ok = cuda_placement.place_agents_and_targets(
        keys, torch.zeros(0, 25, dtype=torch.int64), 5, 3)
    assert agents.shape == targets.shape == (0, 3) and ok.shape == (0,)


KEYS = torch.arange(4, dtype=torch.int64).reshape(2, 2)
LABELS = generator.connected_components(torch.as_tensor(grids("random", 2, 12)))
REFUSALS = {
    "keys int32": (TypeError, KEYS.to(torch.int32), LABELS, 12, 4),
    "labels int32": (TypeError, KEYS, LABELS.to(torch.int32), 12, 4),
    "labels float": (TypeError, KEYS, LABELS.to(torch.float32), 12, 4),
    "device meta": (ValueError, KEYS, LABELS.to("meta"), 12, 4),
    "keys not contiguous": (ValueError, torch.stack([KEYS, KEYS], -1)[..., 0], LABELS, 12, 4),
    "labels not contiguous": (ValueError, KEYS, LABELS.repeat(1, 2)[:, ::2], 12, 4),
    "keys [B, 3]": (ValueError, torch.zeros(2, 3, dtype=torch.int64), LABELS, 12, 4),
    "keys 1-D": (ValueError, KEYS[0], LABELS, 12, 4),
    "labels of another side": (ValueError, KEYS, LABELS, 11, 4),
    "labels of another batch": (ValueError, KEYS[:1], LABELS, 12, 4),
    "side beyond the range": (ValueError, KEYS, LABELS, cuda_placement.MAX_SIDE + 1, 4),
    "side 0": (ValueError, KEYS, LABELS[:, :0], 0, 1),
    "no agents": (ValueError, KEYS, LABELS, 12, 0),
    "more agents than cells": (ValueError, KEYS, LABELS, 12, 145),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_wrapper_refuses(name):
    error, keys, labels, p, n = REFUSALS[name]
    with pytest.raises(error):
        cuda_placement.place_agents_and_targets(keys, labels, p, n)
