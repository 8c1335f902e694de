"""K9, the placement kernel (``ops/cuda_placement.py``,
``csrc/placement.cu``), against its plain version on the card, bit for bit
in agent cells, target cells and ``ok``: at the benchmark cells' shapes
(C.regen's 4096 mazes x 64 agents, D's 1024 Bernoulli(0.3) maps x 128,
E's 1024 pool worlds x 256), on every grid family of
``component_grids.py``, at sides around the shared-memory variant's limits
and in device memory past them; then a whole ``generate_env`` on the card
with K9 against the same with the plain placement, one launch per try.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one; the plain version, ``ops/placement.py``, is held to the JAX package
on the CPU by ``test_torch_placement.py``. This file imports no JAX, so
the card's machine runs it as it is.
"""

import numpy as np
import pytest
import torch

from component_grids import FAMILIES, grids
from pogema_torch import GridConfig
from pogema_torch.core import generator
from pogema_torch.maps import mixed_pool
from pogema_torch.ops import cuda_placement, placement


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the placement kernel has no CPU mode")
    return torch.device("cuda")


def _keys(b, seed, device):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 2**32, (b, 2)), dtype=torch.int64).to(device)


def _launched(keys, labels, p, n):
    """K9 on the card, synchronised, and the launches it made."""
    before = cuda_placement.placement_cuda.launches
    out = cuda_placement.place_agents_and_targets(keys, labels, p, n)
    torch.cuda.synchronize()
    return out, cuda_placement.placement_cuda.launches - before


def _assert_equals_plain(keys, labels, p, n):
    got, launches = _launched(keys, labels, p, n)
    assert launches == 1
    want = placement.place_agents_and_targets(keys, labels, p, n)
    for name, g, w in zip(("agent_cells", "target_cells", "ok"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))
    return got


# The cells' worlds, made on the card as their resets make them: C.regen's
# sidewinder mazes, D's Bernoulli(0.3) maps, E's worlds of the mixed pool.
CELLS = {"C.regen": (dict(size=64, num_agents=64, obs_radius=5), 4096, "maze"),
         "D.serve": (dict(size=64, density=0.3, num_agents=128, obs_radius=5), 1024, "random"),
         "E.serve": (dict(size=128, density=0.3, num_agents=256, obs_radius=5), 1024, "pool")}


def _cell_labels(cell, card):
    kw, b, kind = CELLS[cell]
    cfg = GridConfig(**kw).to_static()
    keys = _keys(b, 1, card)
    if kind == "maze":
        grid = generator.sidewinder_maze(cfg, keys)
    elif kind == "random":
        grid = generator.bernoulli_obstacles(cfg, keys)
    else:
        pool = torch.as_tensor(mixed_pool(cfg.size, k=8, braid=0.15)).to(card)
        grid = pool[torch.as_tensor(np.random.default_rng(2).integers(0, 8, b)).to(card)]
    return cfg, generator.connected_components(generator.pad_grid(cfg, grid))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_kernel_equals_plain_at_the_cells(card, cell):
    cfg, labels = _cell_labels(cell, card)
    agents, _, ok = _assert_equals_plain(_keys(labels.shape[0], 3, card), labels,
                                         cfg.padded_size, cfg.num_agents)
    assert bool(ok.all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64, 256])
@pytest.mark.parametrize("p", [74, 138])
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_equals_plain_on_every_family(card, family, p, n):
    labels = generator.connected_components(torch.as_tensor(grids(family, 16, p, seed=p)).to(card))
    _assert_equals_plain(_keys(16, p + n, card), labels, p, n)


# Sides around a warp and a block, around the largest side the shared-memory
# variant takes at N = 64 (162), past 16-bit cells (256), and agent counts
# that push the block's arrays past shared memory at P = 138 (2500 fit,
# 3000 do not): the variant in device memory; and an agent on every cell.
OTHER = ([(family, p, n) for family in ("free", "walls", "trominoes", "spiral")
          for p, n in ((1, 1), (2, 3), (31, 31), (32, 64), (33, 200))]
         + [(family, p, 64) for family in ("random", "spiral", "trominoes")
            for p in (162, 163, 200, 255, 256, 300)]
         + [("pool", 138, 2500), ("pool", 138, 3000), ("free", 40, 1600)])


@pytest.mark.cuda
@pytest.mark.parametrize("family,p,n", OTHER)
def test_kernel_equals_plain_at_other_sizes(card, family, p, n):
    labels = generator.connected_components(torch.as_tensor(grids(family, 3, p, seed=p)).to(card))
    _assert_equals_plain(_keys(3, p * n, card), labels, p, n)


@pytest.mark.cuda
def test_two_calls_give_equal_placements(card):
    # The atomics' order must not show.
    cfg, labels = _cell_labels("E.serve", card)
    keys = _keys(labels.shape[0], 5, card)
    first, second = (_launched(keys, labels, cfg.padded_size, cfg.num_agents)[0] for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_generate_env_with_k9_equals_it_with_the_plain_placement(card, cell, monkeypatch):
    kw, _, kind = CELLS[cell]
    cfg = GridConfig(**kw).to_static()
    keys = _keys(64, 11, card)
    args = dict(maze=kind == "maze")
    if kind == "pool":
        args["map_bank"] = torch.as_tensor(mixed_pool(cfg.size, k=8, braid=0.15)).to(card)
    k9 = cuda_placement.placement_cuda
    tries, launches = generator.generate_env.tries, k9.launches
    got = generator.generate_env(cfg, keys, **args)
    tries = generator.generate_env.tries - tries
    assert k9.launches - launches == tries >= 1
    monkeypatch.setattr(cuda_placement, "placement_cuda", placement.place_agents_and_targets)
    launches = k9.launches
    want = generator.generate_env(cfg, keys, **args)
    assert k9.launches == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[-1].all())


@pytest.mark.cuda
def test_refusals_and_an_empty_batch_on_card(card):
    labels = generator.connected_components(torch.as_tensor(grids("random", 2, 12)).to(card))
    keys = _keys(2, 0, card)
    with pytest.raises(TypeError):
        cuda_placement.place_agents_and_targets(keys, labels.to(torch.int32), 12, 4)
    with pytest.raises(ValueError):
        cuda_placement.place_agents_and_targets(keys, labels.cpu(), 12, 4)
    with pytest.raises(ValueError):
        cuda_placement.place_agents_and_targets(keys, labels, 12, 145)
    (agents, targets, ok), launches = _launched(keys[:0], labels[:0], 12, 4)
    assert agents.shape == targets.shape == (0, 4) and ok.shape == (0,) and launches == 0
