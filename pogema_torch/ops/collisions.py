"""The 'priority' collision rule in plain PyTorch: the plain version of K2.

Counterpart of ``pogema_tpu/core/collisions.py``'s ``propose`` and
``resolve_priority``, written on bool ``[B, N, N]`` conflict matrices
(``[b, i, j]``: agent i against agent j). The JAX package bit-packs those
matrices and looks obstacles up through nibble-packed one-hot matmuls
because gathers serialize on the TPU; here :func:`propose` reads
``obstacles[b, x, y]`` directly.

``priority``: agents move in index order; agent i is checked against
obstacles and against the cells at its turn (agents j > i on their old
cells, agents j < i on their new ones). :func:`resolve_priority` solves it
as the monotone Jacobi fixpoint ``m <- m0 & ~blocked(m)``, whose unique
fixpoint is the sequential result. It is what ``ops/cuda_collisions.py``
returns for tensors on the CPU, and what the card's kernel is held
against; ``core/collisions.py`` builds the other two collision systems on
:func:`propose` and :func:`fixpoint`. :func:`fixpoint` checks convergence
on the host once per pass (one device sync per pass).
"""

from __future__ import annotations

import torch

from ..grid_config import MOVES


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


fixpoint.passes = 0
