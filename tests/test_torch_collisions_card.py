"""K2, the 'priority' collision kernel (``ops/cuda_collisions.py``,
``csrc/collisions.cu``), against the sequential rule
(``collision_cases.sequential_priority``) on the card, bit for bit; its
launch count on the step path; and the step on the card against the step
on the CPU under every collision system.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one; the plain version, the fixpoint, is held to the sequential rule and
to the JAX package on the CPU by ``test_torch_collisions_cuda.py``. This
file imports no JAX, so the card's machine runs it as it is.
"""

import numpy as np
import pytest
import torch

from collision_cases import AGENTS, SCENARIOS, random_inputs, scenario, sequential_priority
from pogema_torch import GridConfig, PogemaCore
from pogema_torch.core import collisions
from pogema_torch.interop import state_to_numpy
from pogema_torch.ops import cuda_collisions
from pogema_torch.ops.cuda_collisions import resolve_priority

# (B, N, P) of the benchmark's cells: C.random, D.serve, E.serve.
CELL_SHAPES = {"C": (4096, 64, 74), "D": (1024, 128, 74), "E": (1024, 256, 138)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the collision kernel has no CPU mode")
    return torch.device("cuda")


def _launched(*args):
    """K2 on the card, synchronised, and the launches it made."""
    before = cuda_collisions.collisions_cuda.launches
    out = resolve_priority(*args)
    torch.cuda.synchronize()
    return out, cuda_collisions.collisions_cuda.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
@pytest.mark.parametrize("actions_dtype", [torch.int32, torch.int64])
def test_kernel_equals_plain_at_cell_shapes(card, cell, actions_dtype):
    b, n, p = CELL_SHAPES[cell]
    grid, xy, active, actions = random_inputs(b, n, p, seed=b + n)
    args = tuple(t.to(card) for t in (grid, xy, active, actions.to(actions_dtype)))
    got, launches = _launched(*args)
    assert launches == 1
    want = sequential_priority(*args)
    assert torch.equal(got, want)
    assert bool((want != args[1]).any()) and bool((want == args[1]).all(-1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", AGENTS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_kernel_equals_plain_on_scenarios(card, name, n):
    args = tuple(map(torch.as_tensor, scenario(name, n)))
    got, launches = _launched(*(t.to(card) for t in args))
    assert launches == 1
    assert torch.equal(got.cpu(), sequential_priority(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,p", [(3, 1537, 60), (2, 6144, 100), (2, 6145, 100), (1, 9000, 120)])
def test_kernel_equals_plain_past_shared_memory(card, b, n, p):
    # One warp a block above 1536 agents, a global scratch buffer above 6144.
    grid, xy, active, actions = random_inputs(b, n, p, seed=n, density=0.1)
    args = tuple(t.to(card) for t in (grid, xy, active, actions))
    got, launches = _launched(*args)
    assert launches == 1
    assert torch.equal(got, sequential_priority(*args))


@pytest.mark.cuda
def test_refusals_and_empty_batches_on_card(card):
    grid, xy, active, actions = (t.to(card) for t in random_inputs(2, 8, 12, seed=1))
    with pytest.raises(ValueError):
        resolve_priority(grid, xy.cpu(), active, actions)
    with pytest.raises(TypeError):
        resolve_priority(grid, xy, active, actions.to(torch.int16))
    with pytest.raises(ValueError):
        resolve_priority(grid, xy.transpose(0, 1).contiguous().transpose(0, 1), active, actions)
    for b, n in ((0, 8), (2, 0)):
        out, launches = _launched(grid[:b], xy[:b, :n].contiguous(), active[:b, :n].contiguous(),
                                  actions[:b, :n].contiguous())
        assert launches == 0 and out.shape == (b, n, 2) and out.device.type == "cuda"


@pytest.mark.cuda
def test_one_launch_per_resolve_moves_and_no_passes(card):
    grid, xy, active, actions = (t.to(card) for t in random_inputs(64, 32, 40, seed=2))
    cfg = GridConfig(size=30, num_agents=32, collision_system="priority").to_static()
    launches, passes = cuda_collisions.collisions_cuda.launches, collisions.fixpoint.passes
    for dtype in (torch.int32, torch.int64, torch.uint8):
        got = collisions.resolve_moves(cfg, grid, xy, active, actions.clamp(min=0).to(dtype))
        assert torch.equal(got, sequential_priority(grid, xy, active, actions.clamp(min=0)))
    # A non-contiguous view of the positions is taken too.
    wide = torch.cat([xy, xy], -1)[..., :2]
    collisions.resolve_moves(cfg, grid, wide, active, actions)
    torch.cuda.synchronize()
    assert cuda_collisions.collisions_cuda.launches - launches == 4
    assert collisions.fixpoint.passes == passes


@pytest.mark.cuda
@pytest.mark.parametrize("system", ["priority", "block_both", "soft"])
@pytest.mark.parametrize("on_target", ["finish", "restart"])
def test_step_on_card_equals_cpu(card, system, on_target):
    gc = GridConfig(size=16, num_agents=40, obs_radius=3, max_episode_steps=64, density=0.2,
                    collision_system=system, on_target=on_target)
    cores = [PogemaCore(gc, num_envs=16, device=d, obs_layout="packed") for d in ("cpu", card)]
    (s_cpu, o_cpu), (s_dev, o_dev) = (c.reset(7) for c in cores)
    rng = np.random.default_rng(7)
    launches = cuda_collisions.collisions_cuda.launches
    steps = 48
    for t in range(steps):
        a = torch.as_tensor(rng.integers(0, 5, (16, 40)), dtype=torch.int64 if t % 2 else torch.int32)
        s_cpu, r_cpu = cores[0].step(s_cpu, a)[:2]
        s_dev, r_dev = cores[1].step(s_dev, a.to(card))[:2]
        x, y = state_to_numpy(s_cpu), state_to_numpy(s_dev)
        assert set(x) == set(y) and all(np.array_equal(x[k], y[k]) for k in x), (system, t)
        assert torch.equal(r_cpu.observations, r_dev.observations.cpu()), (system, t)
    expected = steps if system == "priority" else 0
    assert cuda_collisions.collisions_cuda.launches - launches == expected
