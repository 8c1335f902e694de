"""Batched shortest-path planner: BFS distance fields and greedy descent.

Counterpart of ``pogema_tpu/core/planner.py``. Each agent's plan is the
exact BFS (L1 geodesic, 4-connectivity) distance field to its target over
the padded grid, computed once per episode; every step descends it
greedily, penalising cells held by other active agents, with a random
escape move for agents stuck off their goal.

The fields use the JAX package's integer encoding, so they are equal to
its fields bit for bit: i32 values, ``big = P*P`` for obstacles and
unreachable cells, and a segmented relaxation per axis and direction
written as one running max of a sheared key (``_dist_relax_scan``). The
JAX package runs one ``while_loop`` per field; here all B·N fields of a
chunk of envs sweep together until one whole sweep changes none of them
(a converged field is a fixed point of the sweep, so the result is the
same). On the card ``greedy_actions`` reads the four neighbours with a
direct gather instead of the one-hot contraction the TPU needs.

Only the static-target modes ('finish', 'nothing') are supported: LifeLong
respawns change the goals mid-episode.
"""

from __future__ import annotations

import torch

from ..grid_config import MOVES, StaticConfig
from . import metrics as metrics_mod
from . import random as jr
from . import step as step_mod
from .api import select_state

# Fields of one chunk of envs hold at most this many cells (1 GiB of i32
# per live tensor); a sweep keeps about ten such tensors alive.
CELLS_PER_CHUNK = 1 << 28

ESCAPE_STREAM = 0x9E3779B9


def _flip(x, axis, reverse):
    return x.flip(axis) if reverse else x


def _dist_relax_scan(d, seg, axis: int, reverse: bool, big: int):
    """Segmented relaxation of ``d`` along ``axis``:
    forward  d'[i] = min_{j <= i, same free segment} d[j] + (i - j);
    reverse  d'[i] = min_{j >= i, same free segment} d[j] + (j - i).
    ``seg`` is the running obstacle count along that axis and direction
    (broadcast over the fields of an env). The affine cost folds into a
    running max by shearing with the index, as in the JAX package."""
    p = d.shape[axis]
    shape = [1] * d.dim()
    shape[axis] = p
    idx = torch.arange(p, dtype=torch.int32, device=d.device).reshape(shape)
    shear = idx if reverse else -idx
    e = d + shear + p  # >= 0
    k = big + 2 * p + 4  # > max(e)
    w = seg * k + (k - 1 - torch.clamp(e, max=k - 1))
    w = _flip(torch.cummax(_flip(w, axis, reverse), dim=axis).values, axis, reverse)
    out = (k - 1) - (w - seg * k) - p - shear
    return torch.clamp(out, max=big)


def _segments(obstacle, axis: int, reverse: bool):
    o = _flip(obstacle.to(torch.int32), axis, reverse)
    return _flip(torch.cumsum(o, dim=axis, dtype=torch.int32), axis, reverse)


def _fields_chunk(grids, targets_xy):
    """i32[b, N, P, P] fields of one chunk and the sweeps it took."""
    b, n, _ = targets_xy.shape
    p = grids.shape[-1]
    big = p * p
    obstacle = grids.bool()[:, None]  # [b, 1, P, P], shared by the N fields
    rows = torch.arange(p, device=grids.device)
    at_target = ((rows[:, None] == targets_xy[..., 0, None, None])
                 & (rows[None, :] == targets_xy[..., 1, None, None]))  # [b, N, P, P]
    d = torch.where(at_target & ~obstacle, 0, big).to(torch.int32)
    # Axis 3 runs along a row, axis 2 along a column, as the JAX sweep.
    plan = [(axis, rev, _segments(obstacle, axis, rev)) for axis in (3, 2) for rev in (False, True)]

    def sweep(x):
        for axis, rev, seg in plan:
            x = _dist_relax_scan(x, seg, axis, rev, big)
        return x

    d = sweep(d)
    sweeps = 1
    while True:
        nxt = sweep(d)
        sweeps += 1
        if torch.equal(nxt, d):
            break
        d = nxt
    return torch.where(obstacle, big, d), sweeps


def distance_fields(grids, targets_xy) -> torch.Tensor:
    """Exact BFS distances of every agent's target: grids u8[B, P, P]
    (padded), targets_xy i32[B, N, 2] -> i32[B, N, P, P]; obstacles and
    unreachable cells get ``P*P``. Envs go in chunks of at most
    ``CELLS_PER_CHUNK`` cells; ``distance_fields.sweeps`` counts the
    sweeps run (summed over chunks), one host sync each."""
    b, n, _ = targets_xy.shape
    p = grids.shape[-1]
    per_chunk = max(1, CELLS_PER_CHUNK // (n * p * p))
    out = torch.empty(b, n, p, p, dtype=torch.int32, device=grids.device)
    for lo in range(0, b, per_chunk):
        hi = min(b, lo + per_chunk)
        out[lo:hi], sweeps = _fields_chunk(grids[lo:hi], targets_xy[lo:hi])
        distance_fields.sweeps += sweeps
    return out


distance_fields.sweeps = 0


def distance_field(padded_grid, target_xy) -> torch.Tensor:
    """i32[P, P]: the field of one target over one padded grid."""
    return distance_fields(padded_grid[None], target_xy.reshape(1, 1, 2))[0, 0]


def greedy_actions(dist, agents_xy, active, avoid_agents: bool = True, keys=None,
                   escape_prob: float = 0.5) -> torch.Tensor:
    """Greedy descent of the fields, batched over envs.

    dist i32[B, N, P, P]; agents_xy i32[B, N, 2]; active bool[B, N];
    keys: None or one key per env (int64[B, 2]). The action is the argmin
    over {stay, 4 moves} of the distance at the resulting cell, ties to
    the lower action index; with ``avoid_agents`` cells held by other
    active agents cost ``8·P²`` more. With keys, an agent that stays
    while off its goal takes, with probability ``escape_prob``, a uniform
    random free and unheld move: jax draws ``argmax(-log u)`` over
    ``u = uniform(k_move, (N, 5), 1e-6, 1)``; this takes the masked
    ``argmin(u)``, the same choice (``-log`` is strictly decreasing on
    every value that draw can give, which the tests check) with no
    transcendental function. Returns i32[B, N]."""
    b, n = agents_xy.shape[:2]
    p = dist.shape[-1]
    big = p * p
    dev = agents_xy.device
    moves = torch.tensor(MOVES, dtype=torch.int32, device=dev)
    cand = (agents_xy[:, :, None, :] + moves).clamp(0, p - 1)  # [B, N, 5, 2]
    cand_cells = cand[..., 0].long() * p + cand[..., 1].long()
    d_cand = dist.reshape(b, n, p * p).gather(2, cand_cells)  # [B, N, 5]
    score = d_cand.long() * 8 + torch.arange(5, device=dev)
    occupied = torch.zeros(b, n, 5, dtype=torch.bool, device=dev)
    if avoid_agents and n > 1:
        cur_cells = agents_xy[..., 0].long() * p + agents_xy[..., 1].long()
        other = active[:, None, :] & ~torch.eye(n, dtype=torch.bool, device=dev)  # [B, n, j]
        occupied = ((cand_cells[..., None] == cur_cells[:, None, None, :])
                    & other[:, :, None, :]).any(dim=-1)
        score = score + occupied.long() * (8 * big)
    act = score.argmin(dim=-1)

    if keys is not None:
        stuck = active & (act == 0) & (d_cand[..., 0] > 0)
        movable = (d_cand < big) & ~occupied & (torch.arange(5, device=dev) > 0)
        k = jr.split(keys, 2)
        u = jr.uniform(k[:, 0], (n, 5), minval=1e-6, maxval=1.0)
        inf = torch.tensor(float("inf"), device=dev)
        rand_act = torch.where(movable, u, inf).argmin(dim=-1)
        flip = jr.uniform(k[:, 1], (n,)) < escape_prob
        act = torch.where(stuck & movable.any(dim=-1) & flip, rand_act, act)
    return torch.where(active, act, 0).to(torch.int32)


def make_planner_policy(cfg: StaticConfig, avoid_agents: bool = True, escape_prob: float = 0.5):
    """(plan, act) for batched states: ``plan(state)`` -> dist
    i32[B, N, P, P] (once per episode); ``act(dist, state, key=None)`` ->
    i32[B, N] (every step; a key, split into one per env, turns on the
    deadlock escape)."""
    del cfg  # shapes come from the tensors; kept for symmetry with the JAX API

    def plan(state):
        return distance_fields(state.obstacles, state.targets_xy)

    def act(dist, state, key=None):
        keys = None if key is None else jr.split(key, state.agents_xy.shape[0])
        return greedy_actions(dist, state.agents_xy, state.active, avoid_agents, keys, escape_prob)

    return plan, act


def make_planner_evaluator(core, avoid_agents: bool = True):
    """``run(key) -> (final_state, {metric: f32[B]})``: one episode of B
    envs on the core's device: the reset (consuming ``key`` verbatim, so
    the world matches ``core.reset(key)``), the fields once, then greedy
    descent with the escape stream ``fold_in(key, ESCAPE_STREAM)`` split
    once per step, freezing finished envs. Raises ValueError for
    LifeLong, and (from the reset) when placement failed."""
    if core.cfg.on_target == "restart":
        raise ValueError("the planner evaluator needs static targets; LifeLong respawns "
                         "change goals mid-episode")
    cfg = core.cfg
    plan, act = make_planner_policy(cfg, avoid_agents=avoid_agents)

    @torch.no_grad()
    def run(key):
        key = torch.as_tensor(key, device=core.device).to(torch.int64)
        state, _ = core.reset(key, with_obs=False)
        k = jr.fold_in(key, ESCAPE_STREAM)
        dist = plan(state)
        for _ in range(cfg.max_episode_steps):
            k, k_act = jr.split(k)
            done = step_mod.episode_done(cfg, state)
            new_state, _ = step_mod.step(cfg, state, act(dist, state, k_act), with_obs=False)
            state = select_state(done, state, new_state)
        return state, metrics_mod.episode_metrics(cfg, state)

    return run


def evaluate_planner(core, seed: int = 0, avoid_agents: bool = True):
    """One call of :func:`make_planner_evaluator`, cached on the core."""
    cache = core.__dict__.setdefault("_planner_evaluators", {})
    run = cache.get(avoid_agents)
    if run is None:
        run = cache[avoid_agents] = make_planner_evaluator(core, avoid_agents=avoid_agents)
    return run(core.make_key(seed))
