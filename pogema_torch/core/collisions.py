"""Collision resolution for the three ``collision_system`` modes, batched.

Counterpart of ``pogema_tpu/core/collisions.py``, written on bool
``[B, N, N]`` conflict matrices (``[b, i, j]``: agent i against agent j).
The JAX package bit-packs those matrices and looks obstacles up through
nibble-packed one-hot matmuls because gathers serialize on the TPU; here
``propose`` reads ``obstacles[b, x, y]`` directly.

Semantics (see the JAX module for the derivations):

* ``priority``: agents move in index order; agent i is checked against
  obstacles and against the cells at its turn (agents j > i on their old
  cells, agents j < i on their new ones). Solved as the monotone Jacobi
  fixpoint ``m <- m0 & ~blocked(m)``, whose unique fixpoint is the
  sequential result.
* ``block_both``: one parallel pass; a move fails on an obstacle, on any
  active agent's current cell, or on a cell another mover also targets.
* ``soft``: vertex conflicts and swaps cancel both movers; moving into a
  cell being vacated is allowed; blocked movers become stayers and may
  block others (chains), iterated to the fixpoint.

The fixpoints check convergence on the host once per pass (one device
sync per pass). On a CUDA device ``resolve_moves`` hands ``priority`` to
K2 (``ops/cuda_collisions.py``), which computes the sequential rule in one
launch with no sync; the fixpoint stays the CPU's path, where it is
faster than a loop over the agents, and the depth diagnostic's.
"""

from __future__ import annotations

import torch

from ..grid_config import MOVES, StaticConfig
from ..ops import cuda_collisions
from ..utils.profiling import traced


def _moves(device):
    return torch.tensor(MOVES, dtype=torch.int32, device=device)


def propose(obstacles, agents_xy, active, actions):
    """Moves checked against obstacles (the border of width obs_radius
    >= 1 keeps every proposal inside the grid). Actions outside [0, 5)
    stay, as the JAX one-hot gives.

    Returns (desired i32[B, N, 2], des_cells, cur_cells i64[B, N] flat
    cell ids, moving bool[B, N]); desired == current for blocked,
    inactive and staying agents.
    """
    b, p, _ = obstacles.shape
    actions = actions.long()
    known = (actions >= 0) & (actions < len(MOVES))
    deltas = _moves(agents_xy.device)[actions.clamp(0, len(MOVES) - 1)]
    deltas = deltas * known[..., None].to(torch.int32)
    proposed = agents_xy + deltas
    px = proposed[..., 0].long()
    py = proposed[..., 1].long()
    inside = (px >= 0) & (px < p) & (py >= 0) & (py < p)
    flat = px.clamp(0, p - 1) * p + py.clamp(0, p - 1)
    hits = inside & (obstacles.reshape(b, p * p).gather(1, flat) > 0)
    valid = active & ~hits
    desired = torch.where(valid[..., None], proposed, agents_xy)
    cur_cells = agents_xy[..., 0].long() * p + agents_xy[..., 1].long()
    des_cells = torch.where(valid, cur_cells + deltas[..., 0].long() * p + deltas[..., 1].long(),
                            cur_cells)
    moving = valid & (des_cells != cur_cells)
    return desired, des_cells, cur_cells, moving


def _eq(a_cells, b_cells):
    """bool[B, N, M]: flat cell a[b, n] == flat cell b[b, m]."""
    return a_cells[:, :, None] == b_cells[:, None, :]


def fixpoint(m0, one_pass):
    """Iterate ``one_pass`` from ``m0`` until no env changes. Each pass
    syncs the host once; ``fixpoint.passes`` counts the passes."""
    m = m0
    while True:
        nxt = one_pass(m)
        fixpoint.passes += 1
        if torch.equal(nxt, m):
            return m
        m = nxt


def _priority_setup(des_cells, cur_cells, active, moving):
    """(m0, one_pass) of the priority fixpoint, shared by the resolver
    and its depth instrument."""
    n = des_cells.shape[1]
    idx = torch.arange(n, device=des_cells.device)
    later = idx[None, :] > idx[:, None]  # [i, j]: j > i
    act = active[:, None, :]
    tgt_on_cur = _eq(des_cells, cur_cells) & act  # t_i == c_j, j active
    # A later agent still sits on my target at my turn.
    m0 = moving & ~(tgt_on_cur & later).any(dim=2)
    earlier_active = (idx[None, :] < idx[:, None]) & act
    e1 = _eq(des_cells, des_cells) & earlier_active  # an earlier agent moves onto my target
    e2 = tgt_on_cur & earlier_active                 # an earlier agent stays on my target

    def one_pass(m):
        mj = m[:, None, :]
        return m0 & ~((e1 & mj) | (e2 & ~mj)).any(dim=2)

    return m0, one_pass


def resolve_priority(obstacles, agents_xy, active, actions):
    desired, des_cells, cur_cells, moving = propose(obstacles, agents_xy, active, actions)
    m = fixpoint(*_priority_setup(des_cells, cur_cells, active, moving))
    return torch.where(m[..., None], desired, agents_xy)


def priority_fixpoint_depth(obstacles, agents_xy, active, actions) -> torch.Tensor:
    """i32[B]: per env, the Jacobi passes of :func:`resolve_priority`
    until its fixpoint (the longest follow chain this step), counted as
    ``pogema_tpu``'s ``while_loop`` counts them: the least k >= 1 with
    ``m_k == m_{k-1}``. A diagnostic, off the step path; one host sync
    per pass."""
    _, des_cells, cur_cells, moving = propose(obstacles, agents_xy, active, actions)
    m, one_pass = _priority_setup(des_cells, cur_cells, active, moving)
    depth = torch.zeros(m.shape[0], dtype=torch.int32, device=m.device)
    running = torch.ones(m.shape[0], dtype=torch.bool, device=m.device)
    k = 0
    while bool(running.any()):
        nxt = one_pass(m)
        k += 1
        same = (nxt == m).all(dim=1)
        depth = torch.where(running & same, k, depth)
        running = running & ~same
        m = nxt
    return depth


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


fixpoint.passes = 0

_RESOLVERS = {
    "priority": resolve_priority,
    "block_both": resolve_block_both,
    "soft": resolve_soft,
}


@traced("pogema.collisions")
def resolve_moves(cfg: StaticConfig, obstacles, agents_xy, active, actions):
    """New positions i32[B, N, 2] under ``cfg.collision_system``."""
    if cfg.collision_system == "priority" and agents_xy.is_cuda:
        if actions.dtype != torch.int64:
            actions = actions.to(torch.int32)
        return cuda_collisions.resolve_priority(obstacles.contiguous(), agents_xy.contiguous(),
                                                active.contiguous(), actions.contiguous())
    if cfg.num_agents == 1:
        # One agent cannot conflict with another under any system.
        return propose(obstacles, agents_xy, active, actions)[0]
    return _RESOLVERS[cfg.collision_system](obstacles, agents_xy, active, actions)
