"""K2's plain version (``ops/cuda_collisions.py``), the sequential
'priority' rule, against the fixpoint of ``core/collisions.py`` and
against ``pogema_tpu``'s ``resolve_priority``, bit for bit on the CPU; and
the wrapper's refusals, which the CPU shows as the card does.

The kernel itself is held to the plain version on the card by
``test_torch_collisions_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pogema_torch
from pogema_torch.core import collisions as tcol
from collision_cases import AGENTS, ENVS, SCENARIOS, scenario
from pogema_torch.ops import cuda_collisions
from pogema_tpu.core import collisions as jcol

_jax_priority = jax.jit(jax.vmap(jcol.resolve_priority))


@pytest.mark.parametrize("n", AGENTS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plain_equals_fixpoint_and_jax(name, n):
    grid, xy, active, actions = scenario(name, n)
    args = tuple(map(torch.as_tensor, (grid, xy, active, actions)))
    got = cuda_collisions.resolve_priority(*args)
    assert got.dtype == torch.int32 and got.shape == (ENVS, n, 2)
    assert torch.equal(got, tcol.resolve_priority(*args))
    want = np.asarray(_jax_priority(*map(jnp.asarray, (grid, xy, active, actions))))
    np.testing.assert_array_equal(got.numpy(), want)
    # The scenario moves some agents and stops others, where it can.
    moved = (got != args[1]).any(-1)
    if name == "chain_front_first" or (name == "onto_inactive" and n > 1):
        assert bool(moved.any())
    if name in ("head_on", "chain_back_first") and n > 1:
        assert not bool(moved.all())


def test_plain_takes_int64_actions_and_bool_grids():
    grid, xy, active, actions = scenario("unknown_actions", 33, seed=4)
    args = tuple(map(torch.as_tensor, (grid, xy, active, actions)))
    want = tcol.resolve_priority(*args)
    assert torch.equal(cuda_collisions.resolve_priority(
        args[0].bool(), args[1], args[2], args[3].long()), want)
    # resolve_moves keeps the fixpoint on the CPU and takes other action types.
    cfg = pogema_torch.GridConfig(num_agents=33, collision_system="priority").to_static()
    assert torch.equal(tcol.resolve_moves(cfg, args[0], args[1], args[2], args[3].to(torch.int16)),
                       want)


def _good(b=2, n=5):
    grid, xy, active, actions = scenario("crowded", n)
    return tuple(map(torch.as_tensor, (grid[:b], xy[:b], active[:b], actions[:b])))


@pytest.mark.parametrize("fault,error", [
    ("obstacles_int32", TypeError), ("xy_int64", TypeError), ("active_uint8", TypeError),
    ("actions_float", TypeError), ("actions_int16", TypeError),
    ("obstacles_2d", ValueError), ("obstacles_not_square", ValueError),
    ("xy_short", ValueError), ("active_other_n", ValueError), ("actions_other_b", ValueError),
    ("xy_not_contiguous", ValueError), ("actions_not_contiguous", ValueError),
    ("devices_differ", ValueError), ("side_too_large", ValueError),
])
def test_wrapper_refuses(fault, error):
    grid, xy, active, actions = _good()
    if fault == "obstacles_int32":
        grid = grid.to(torch.int32)
    elif fault == "xy_int64":
        xy = xy.long()
    elif fault == "active_uint8":
        active = active.to(torch.uint8)
    elif fault == "actions_float":
        actions = actions.float()
    elif fault == "actions_int16":
        actions = actions.to(torch.int16)
    elif fault == "obstacles_2d":
        grid = grid[0]
    elif fault == "obstacles_not_square":
        grid = grid[:, :, :-1]
    elif fault == "xy_short":
        xy = xy[..., :1]
    elif fault == "active_other_n":
        active = active[:, :-1]
    elif fault == "actions_other_b":
        actions = actions[:1]
    elif fault == "xy_not_contiguous":
        xy = xy.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "actions_not_contiguous":
        actions = actions.t().contiguous().t()
    elif fault == "devices_differ":
        actions = actions.to("meta")
    elif fault == "side_too_large":
        grid = torch.zeros(1, cuda_collisions.MAX_SIDE + 1, 1, dtype=torch.uint8).expand(
            1, cuda_collisions.MAX_SIDE + 1, cuda_collisions.MAX_SIDE + 1)
        xy, active, actions = xy[:1], active[:1], actions[:1]
    with pytest.raises(error):
        cuda_collisions.resolve_priority(grid, xy, active, actions)


def test_empty_batches_and_no_launch_on_cpu():
    before = cuda_collisions.collisions_cuda.launches
    for b, n in ((0, 4), (2, 0)):
        grid = torch.zeros(b, 6, 6, dtype=torch.uint8)
        out = cuda_collisions.resolve_priority(
            grid, torch.zeros(b, n, 2, dtype=torch.int32), torch.ones(b, n, dtype=torch.bool),
            torch.zeros(b, n, dtype=torch.int32))
        assert out.shape == (b, n, 2) and out.dtype == torch.int32
    grid, xy, active, actions = _good()
    cuda_collisions.resolve_priority(grid, xy, active, actions)
    assert cuda_collisions.collisions_cuda.launches == before
