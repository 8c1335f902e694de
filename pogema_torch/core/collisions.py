"""Collision resolution for the three ``collision_system`` modes, batched.

Counterpart of ``pogema_tpu/core/collisions.py``, written on bool
``[B, N, N]`` conflict matrices (``[b, i, j]``: agent i against agent j).

Semantics (see the JAX module for the derivations):

* ``priority``: agents move in index order; agent i is checked against
  obstacles and against the cells at its turn (agents j > i on their old
  cells, agents j < i on their new ones). ``resolve_moves`` hands it to
  K2's wrapper (``ops/cuda_collisions.py``), which chooses the device:
  the kernel, one launch with no sync, for CUDA tensors, and the plain
  version, the Jacobi fixpoint of ``ops/collisions.py``, for CPU ones.
* ``block_both``: one parallel pass; a move fails on an obstacle, on any
  active agent's current cell, or on a cell another mover also targets.
* ``soft``: vertex conflicts and swaps cancel both movers; moving into a
  cell being vacated is allowed; blocked movers become stayers and may
  block others (chains), iterated to the fixpoint, which checks
  convergence on the host once per pass (one device sync per pass).

``block_both`` and ``soft`` build on ``propose`` and ``fixpoint`` of
``ops/collisions.py``.
"""

from __future__ import annotations

import torch

from ..grid_config import StaticConfig
from ..ops import cuda_collisions
# The names of pogema_tpu's module, kept here: the benchmark (``portbench``)
# reads ``collisions.fixpoint.passes``, the tests call the rest.
from ..ops.collisions import (  # noqa: F401
    _eq, fixpoint, priority_fixpoint_depth, propose, resolve_priority)
from ..utils.profiling import traced


def resolve_block_both(obstacles, agents_xy, active, actions):
    desired, des_cells, cur_cells, moving = propose(obstacles, agents_xy, active, actions)
    n = agents_xy.shape[1]
    not_self = ~torch.eye(n, dtype=torch.bool, device=agents_xy.device)
    act = active[:, None, :]
    tgt_on_cur = _eq(des_cells, cur_cells) & act
    tgt_clash = _eq(des_cells, des_cells) & act & not_self
    blocked = tgt_on_cur.any(dim=2) | (tgt_clash & moving[:, None, :]).any(dim=2)
    m = moving & ~blocked
    return torch.where(m[..., None], desired, agents_xy)


def resolve_soft(obstacles, agents_xy, active, actions):
    desired, des_cells, cur_cells, moving = propose(obstacles, agents_xy, active, actions)
    n = agents_xy.shape[1]
    not_self = ~torch.eye(n, dtype=torch.bool, device=agents_xy.device)
    act = active[:, None, :]
    tgt_clash = _eq(des_cells, des_cells) & act & not_self
    vertex = (tgt_clash & moving[:, None, :]).any(dim=2)
    tgt_on_cur = _eq(des_cells, cur_cells) & act  # t_i == c_j
    their_tgt_on_my_cur = _eq(cur_cells, des_cells)  # t_j == c_i
    swap = (tgt_on_cur & their_tgt_on_my_cur & not_self).any(dim=2)
    m0 = moving & ~vertex & ~swap

    def one_pass(m):
        return m0 & ~(tgt_on_cur & ~m[:, None, :]).any(dim=2)

    m = fixpoint(m0, one_pass)
    return torch.where(m[..., None], desired, agents_xy)


_RESOLVERS = {
    "block_both": resolve_block_both,
    "soft": resolve_soft,
}


@traced("pogema.collisions")
def resolve_moves(cfg: StaticConfig, obstacles, agents_xy, active, actions):
    """New positions i32[B, N, 2] under ``cfg.collision_system``."""
    if cfg.collision_system == "priority":
        if actions.dtype != torch.int64:
            actions = actions.to(torch.int32)
        return cuda_collisions.resolve_priority(obstacles.contiguous(), agents_xy.contiguous(),
                                                active.contiguous(), actions.contiguous())
    if cfg.num_agents == 1:
        # One agent cannot conflict with another under any system.
        return propose(obstacles, agents_xy, active, actions)[0]
    return _RESOLVERS[cfg.collision_system](obstacles, agents_xy, active, actions)
