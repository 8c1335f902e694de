"""Collision resolution of the ``priority`` system, in its plain form.

The semantics (POGEMA's ``priority`` collision system): agents move one
after another in index order. Agent i moves to the cell its action
names if that cell is no obstacle and no active agent stands on it at
i's turn: agents j < i on the cells they have just moved to, agents
j > i still on their old ones. Otherwise it stays. Inactive agents
neither move nor block.

This module runs that rule as it is stated, one agent after another
over an occupancy count per env (vectorised over envs only), and not as
the fixpoint that the measured program solves. The configurations the
benchmark runs use ``priority`` alone.
"""

from __future__ import annotations

import torch

from ..grid_config import MOVES, StaticConfig


def propose(obstacles, agents_xy, active, actions):
    """(desired i32[B, N, 2], moving bool[B, N]): the cell each agent's
    action names, and whether an active agent asks to leave its cell for
    one inside the grid that is no obstacle. Actions outside [0, 5)
    stay."""
    b, p, _ = obstacles.shape
    actions = actions.long()
    known = (actions >= 0) & (actions < len(MOVES))
    moves = torch.tensor(MOVES, dtype=torch.int32, device=agents_xy.device)
    deltas = moves[actions.clamp(0, len(MOVES) - 1)] * known[..., None].to(torch.int32)
    desired = agents_xy + deltas
    x, y = desired[..., 0].long(), desired[..., 1].long()
    inside = (x >= 0) & (x < p) & (y >= 0) & (y < p)
    envs = torch.arange(b, device=obstacles.device)[:, None]
    free = inside & (obstacles[envs, x.clamp(0, p - 1), y.clamp(0, p - 1)] == 0)
    moving = active & free & (deltas != 0).any(dim=-1)
    return desired, moving


def resolve_priority(obstacles, agents_xy, active, actions):
    """New positions i32[B, N, 2]: agents 0, 1, ..., N-1 in turn, each
    against the count of active agents on its target at that turn."""
    b, p, _ = obstacles.shape
    desired, moving = propose(obstacles, agents_xy, active, actions)
    # Cells as flat indices into one count of every env's grid; agent i's
    # row of each is contiguous.
    base = torch.arange(b, device=obstacles.device)[:, None] * (p * p)
    cur = (agents_xy[..., 0].long() * p + agents_xy[..., 1].long() + base).t().contiguous()
    tgt = (desired[..., 0].long() * p + desired[..., 1].long() + base).t().contiguous()
    wants = moving.t().contiguous().to(torch.int32)
    occupied = torch.zeros(b * p * p, dtype=torch.int32, device=obstacles.device)
    occupied.index_add_(0, cur.flatten(), active.t().contiguous().flatten().to(torch.int32))
    moved = torch.empty_like(wants)
    for i in range(wants.shape[0]):
        go = wants[i] * (occupied[tgt[i]] == 0)
        occupied.index_add_(0, cur[i], -go)
        occupied.index_add_(0, tgt[i], go)
        moved[i] = go
    return torch.where(moved.t().bool()[..., None], desired, agents_xy)


def resolve_moves(cfg: StaticConfig, obstacles, agents_xy, active, actions):
    """New positions i32[B, N, 2] under ``cfg.collision_system``."""
    if cfg.collision_system != "priority":
        raise NotImplementedError(f"the reference resolves 'priority' collisions only, not "
                                  f"{cfg.collision_system!r}")
    return resolve_priority(obstacles, agents_xy, active, actions)
