"""K4, the component labels' kernel (``ops/cuda_components.py``,
``csrc/components.cu``), against its plain version on the card, bit for
bit; its launch count and the sweeps it leaves uncounted; and a whole
``generate_env`` on the card against the same reset on the CPU.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one; the plain version, the flood fill of ``ops/components.py``, is held
to the JAX package on the CPU by ``test_torch_components.py``. This file
imports no JAX, so the card's machine runs it as it is.
"""

import numpy as np
import pytest
import torch

from component_grids import FAMILIES, grids
from pogema_torch import GridConfig
from pogema_torch.core import generator
from pogema_torch.maps import mixed_pool
from pogema_torch.ops import components, cuda_components

# D.serve's and E.serve's padded sides (64 and 128 plus a border of 5).
SIDES = (74, 138)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the component kernel has no CPU mode")
    return torch.device("cuda")


def _launched(grid):
    """K4 on the card, synchronised, and the launches it made."""
    before = cuda_components.components_cuda.launches
    out = cuda_components.connected_components(grid)
    torch.cuda.synchronize()
    return out, cuda_components.components_cuda.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("p", SIDES)
@pytest.mark.parametrize("b", [1, 1024])
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_equals_plain(card, family, b, p):
    grid = torch.as_tensor(grids(family, b, p, seed=b + p)).to(card)
    got, launches = _launched(grid)
    assert launches == 1
    assert torch.equal(got, components.connected_components(grid))


# Sides around a chunk of 32 cells and around the largest side whose
# labels fit in shared memory (SMEM_SIDE, 236); past it they live in the
# output rows.
OTHER_SIDES = ([(family, p) for family in ("free", "checkerboard", "spiral")
                for p in (1, 2, 31, 32, 33, 236, 237, 250)]
               + [("random", p) for p in (31, 32, 33, 236, 237, 250)])


@pytest.mark.cuda
@pytest.mark.parametrize("family,p", OTHER_SIDES)
def test_kernel_equals_plain_at_other_sides(card, family, p):
    grid = torch.as_tensor(grids(family, 3, p, seed=p)).to(card)
    got, launches = _launched(grid)
    assert launches == 1
    assert torch.equal(got, components.connected_components(grid))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [138, 250])
def test_two_calls_give_equal_labels(card, p):
    # The atomics' order must not show: a root is its component's least index.
    grid = torch.as_tensor(grids("pool" if p == 138 else "random", 1024 if p == 138 else 64,
                                 p, seed=7)).to(card)
    first, second = (_launched(grid)[0] for _ in range(2))
    assert torch.equal(first, second)
    assert torch.equal(first, components.connected_components(grid))


@pytest.mark.cuda
def test_core_launches_once_and_makes_no_sweep(card):
    grid = torch.as_tensor(grids("pool", 64, 138, seed=3)).to(card)
    launches = cuda_components.components_cuda.launches
    sweeps = generator.connected_components.sweeps
    generator.connected_components(grid)
    generator.connected_components(grid.bool())
    assert cuda_components.components_cuda.launches - launches == 2
    assert generator.connected_components.sweeps == sweeps


@pytest.mark.cuda
def test_refusals_and_an_empty_batch_on_card(card):
    grid = torch.as_tensor(grids("random", 2, 12)).to(card)
    with pytest.raises(TypeError):
        cuda_components.connected_components(grid.to(torch.int32))
    with pytest.raises(ValueError):
        cuda_components.connected_components(grid.transpose(1, 2))
    empty, launches = _launched(grid[:0])
    assert empty.shape == (0, 144) and launches == 0


# Configs D and E of the benchmark (LifeLong 64x64 Bernoulli maps with 128
# agents; 128x128 worlds of the mixed pool with 256 agents), at few envs.
CONFIGS = {
    "D": dict(size=64, density=0.3, num_agents=128, obs_radius=5, on_target="restart",
              max_episode_steps=128),
    "E": dict(size=128, density=0.3, num_agents=256, obs_radius=5, on_target="restart",
              max_episode_steps=128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_generate_env_on_card_equals_cpu(card, config):
    cfg = GridConfig(**CONFIGS[config]).to_static()
    keys = torch.as_tensor(np.random.default_rng(11).integers(0, 2**32, (8, 2)),
                           dtype=torch.int64)
    bank = torch.as_tensor(mixed_pool(128, k=8)) if config == "E" else None
    tries = generator.generate_env.tries
    want = generator.generate_env(cfg, keys, map_bank=bank)
    cpu_tries = generator.generate_env.tries - tries
    launches = cuda_components.components_cuda.launches
    got = generator.generate_env(cfg, keys.to(card),
                                 map_bank=None if bank is None else bank.to(card))
    assert generator.generate_env.tries - tries == 2 * cpu_tries
    assert cuda_components.components_cuda.launches - launches == cpu_tries
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)
    assert bool(want[-1].all())
