"""Procedural generation, batched over envs: maps, components, placement.

Counterpart of ``pogema_tpu/core/generator.py``. Every draw comes from
the threefry stream of ``core.random`` so that a reset is bit-equal to
the JAX package's for the same key:

* random maps: iid Bernoulli(density) per cell;
* sidewinder mazes: row runs of eastward carves, each run carving one
  northward passage at its member with the largest uniform;
* connected components: min-label flood fill by segmented running
  minima along rows and columns, iterated to the fixpoint; labels are
  the minimum flat index of each component;
* placement: agents at the top-N uniforms over eligible cells (ties to
  the lower index, as ``lax.top_k``), each target the first argmax of
  masked random bits over the free cells of the agent's component;
* the LifeLong goal queue drawn from a component-sorted cell table;
* the bounded retry loop of ``generate_env``.

Keys are int64 ``[B, 2]``; every function returns tensors with a leading
``B``. The host syncs once per flood-fill sweep and once per retry.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..grid_config import OBSTACLE, StaticConfig
from . import random as jr

_MAX_TRIES = 16


# ---------------------------------------------------------------------------
# obstacle maps
# ---------------------------------------------------------------------------


def bernoulli_obstacles(cfg: StaticConfig, keys) -> torch.Tensor:
    """u8[B, S, S] iid Bernoulli(density) obstacles."""
    return jr.bernoulli(keys, cfg.density, (cfg.size, cfg.size)).to(torch.uint8)


def sidewinder_maze(cfg: StaticConfig, keys) -> torch.Tensor:
    """u8[B, S, S] perfect mazes on the odd lattice (sidewinder)."""
    s = cfg.size
    m = (s + 1) // 2
    b = keys.shape[0]
    dev = keys.device
    k = jr.split(keys, 2)
    carve_east = jr.bernoulli(k[:, 0], 0.5, (m, m))
    carve_east[:, 0, :] = True          # row 0 always carves east
    carve_east[:, :, m - 1] = False     # the last column never can

    # A run starts at col 0 or after a cell that did not carve east.
    prev_east = F.pad(carve_east[:, :, :-1], (1, 0), value=False)
    run_id = torch.cumsum((~prev_east).long(), dim=2) - 1
    seg = torch.arange(m, device=dev)[None, :, None] * m + run_id  # [B, m, m]

    # One member per run carves north: the one holding the run's max.
    g = jr.uniform(k[:, 1], (m, m)).reshape(b, m * m)
    seg_flat = seg.reshape(b, m * m)
    seg_max = torch.full((b, m * m), float("-inf"), device=dev)
    seg_max.scatter_reduce_(1, seg_flat, g, reduce="amax", include_self=False)
    north = (g == seg_max.gather(1, seg_flat)).reshape(b, m, m)
    north[:, 0, :] = False

    ll = 2 * m - 1
    grid = torch.ones(b, ll, ll, dtype=torch.uint8, device=dev)
    grid[:, 0::2, 0::2] = 0
    grid[:, 0::2, 1::2] = (~carve_east[:, :, : m - 1]).to(torch.uint8)
    grid[:, 1::2, 0::2] = (~north[:, 1:, :]).to(torch.uint8)
    if ll >= s:
        return grid[:, :s, :s].contiguous()
    return F.pad(grid, (0, s - ll, 0, s - ll), value=OBSTACLE)


def pad_grid(cfg: StaticConfig, grid) -> torch.Tensor:
    """Border-pad [B, S, S] with obstacles of width obs_radius."""
    r = cfg.obs_radius
    return F.pad(grid.to(torch.uint8), (r, r, r, r), value=OBSTACLE)


# ---------------------------------------------------------------------------
# connected components (4-connectivity)
# ---------------------------------------------------------------------------


def _segmented_min_scan(vals, boundary, dim: int, reverse: bool):
    """Running minimum along ``dim`` of [B, P, P], reset at boundary
    cells, by the encoding w = seg * K + (K-1 - v) under a running max
    (seg only grows along the direction, so the max comes from the
    current segment, and maximising K-1-v minimises v)."""
    p = vals.shape[-1]
    big = p * p
    k = big + 2
    if reverse:
        vals, boundary = vals.flip(dim), boundary.flip(dim)
    seg = torch.cumsum(boundary.long(), dim=dim)
    w = seg * k + (k - 1 - vals.clamp(max=k - 1))
    w = torch.cummax(w, dim=dim).values
    out = ((k - 1) - (w - seg * k)).clamp(max=big)
    return out.flip(dim) if reverse else out


def connected_components(padded_grid) -> torch.Tensor:
    """i64[B, P*P]: for free cells the minimum flat index of their
    4-connected component; P*P for obstacles."""
    b, p, _ = padded_grid.shape
    big = p * p
    obstacle = padded_grid.bool()
    ids = torch.arange(big, device=padded_grid.device).reshape(1, p, p)
    labels = torch.where(obstacle, torch.full_like(ids, big), ids)

    def sweep(lab):
        lab = _segmented_min_scan(lab, obstacle, 2, False)
        lab = _segmented_min_scan(lab, obstacle, 2, True)
        lab = _segmented_min_scan(lab, obstacle, 1, False)
        return _segmented_min_scan(lab, obstacle, 1, True)

    for _ in range(big):
        nxt = sweep(labels)
        if torch.equal(nxt, labels):
            break
        labels = nxt
    return torch.where(obstacle, big, labels).reshape(b, big)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def multi_cell_component(components, p: int) -> torch.Tensor:
    """bool[B, P*P]: free cells with a free 4-neighbour (component of
    size >= 2). The border is obstacles, so wrapped reads are not free."""
    b = components.shape[0]
    free = (components < p * p).reshape(b, p, p)
    nbr = (free.roll(1, 1) | free.roll(-1, 1) | free.roll(1, 2) | free.roll(-1, 2))
    return (free & nbr).reshape(b, p * p)


def place_agents_and_targets(cfg: StaticConfig, keys, components):
    """N distinct agent cells among eligible cells, then per agent a
    target: a free cell of its component, distinct from earlier targets
    and from its own start. Returns (agent_cells i64[B, N], target_cells
    i64[B, N], ok bool[B])."""
    p = cfg.padded_size
    n = cfg.num_agents
    big = p * p
    b = keys.shape[0]
    dev = keys.device
    k = jr.split(keys, 2)
    k_agents, k_targets = k[:, 0], k[:, 1]

    eligible = multi_cell_component(components, p)
    u = jr.uniform(k_agents, (big,))
    scores = torch.where(eligible, u, torch.full_like(u, -1.0))
    # lax.top_k order: descending, ties to the lower index (stable sort).
    top_scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    agents_ok = (top_scores[:, :n] >= 0.0).all(dim=1)
    agent_cells = order[:, :n]

    free = components < big
    cell_ids = torch.arange(big, device=dev)
    used = torch.zeros(b, big, dtype=torch.bool, device=dev)
    targets = torch.zeros(b, n, dtype=torch.int64, device=dev)
    ok = agents_ok
    for i in range(n):
        a = agent_cells[:, i : i + 1]
        comp = components.gather(1, a)
        mask = free & (components == comp) & ~used & (cell_ids[None, :] != a)
        g = jr.bits(jr.fold_in(k_targets, i), (big,))
        sc = torch.where(mask, g, torch.zeros_like(g))
        c = torch.argmax(sc, dim=1, keepdim=True)  # first index of the max
        ok = ok & mask.gather(1, c)[:, 0]
        used = used | (cell_ids[None, :] == c)
        targets[:, i] = c[:, 0]
    return agent_cells, targets, ok


def cells_to_xy(cells, p: int) -> torch.Tensor:
    return torch.stack([cells // p, cells % p], dim=-1).to(torch.int32)


def xy_to_cells(xy, p: int) -> torch.Tensor:
    return xy[..., 0].long() * p + xy[..., 1].long()


# ---------------------------------------------------------------------------
# LifeLong goal queue
# ---------------------------------------------------------------------------


def build_respawn_table(components, p: int) -> dict:
    """Free cells sorted by component: ``cells[B, P*P]`` (stable order,
    obstacles last), ``offset``/``count`` ``[B, P*P+1]`` by component
    label, ``rank[B, P*P]`` the position of each cell in that order."""
    b = components.shape[0]
    big = p * p
    dev = components.device
    order = torch.argsort(components, dim=1, stable=True)
    pos = torch.arange(big, device=dev).expand(b, big)
    rank = torch.empty_like(order).scatter_(1, order, pos)
    sorted_labels = components.gather(1, order)
    offset = torch.full((b, big + 1), 2**31 - 1, dtype=torch.int64, device=dev)
    offset.scatter_reduce_(1, sorted_labels, pos, reduce="amin", include_self=False)
    count = torch.zeros(b, big + 1, dtype=torch.int64, device=dev)
    count.scatter_add_(1, sorted_labels, torch.ones_like(pos))
    return {"cells": order, "offset": offset, "count": count, "rank": rank}


def build_target_queue(keys, table, components, target_cells, queue_len: int, p: int):
    """int[B, N, Q] queue of future LifeLong goals: uniform free cells of
    the agent's component with q_k != q_{k-1} (q_{-1} the first target)
    and q_{Q-1} != q_0, by the double-draw trick; i16 when cell ids fit."""
    comp = components.gather(1, target_cells)  # [B, N]
    off = table["offset"].gather(1, comp)
    cnt = table["count"].gather(1, comp)
    b, n = target_cells.shape
    k = jr.split(keys, 2)
    hi = cnt.clamp(min=1)[..., None]
    j1 = jr.randint(k[:, 0], (n, queue_len), 0, hi)
    j2 = jr.randint(k[:, 1], (n, queue_len), 0, hi)
    cells = table["cells"]
    cells1 = cells.gather(1, (off[..., None] + j1).reshape(b, -1)).reshape(b, n, queue_len)
    cells2 = cells.gather(1, (off[..., None] + j2).reshape(b, -1)).reshape(b, n, queue_len)

    cols = []
    prev = target_cells
    for q in range(queue_len):
        c1, c2 = cells1[..., q], cells2[..., q]
        prev = torch.where(c1 != prev, c1, c2)
        cols.append(prev)
    queue = torch.stack(cols, dim=-1)
    if queue_len >= 2:
        q0, prev, last = queue[..., 0], queue[..., -2], queue[..., -1]
        alt1, alt2 = cells1[..., -1], cells2[..., -1]
        fix = torch.where((alt2 != prev) & (alt2 != q0), alt2,
                          torch.where((alt1 != prev) & (alt1 != q0), alt1, last))
        queue[..., -1] = torch.where(last == q0, fix, last)
    queue = torch.where(cnt[..., None] <= 1, target_cells[..., None], queue)
    dtype = torch.int16 if p * p < 2**15 else torch.int32
    return queue.to(dtype)


# ---------------------------------------------------------------------------
# full env generation with bounded retry
# ---------------------------------------------------------------------------


def _make_map(cfg: StaticConfig, keys, fixed_map, map_bank, maze: bool):
    b = keys.shape[0]
    if fixed_map is not None:
        return pad_grid(cfg, fixed_map.expand(b, -1, -1))
    if map_bank is not None:
        idx = jr.randint(keys, (), 0, map_bank.shape[0]).long()
        return pad_grid(cfg, map_bank[idx])
    grid = sidewinder_maze(cfg, keys) if maze else bernoulli_obstacles(cfg, keys)
    return pad_grid(cfg, grid)


def _attempt(cfg, keys, fixed_map, fixed_agents, fixed_targets, maze, map_bank):
    p = cfg.padded_size
    r = cfg.obs_radius
    k = jr.split(keys, 2)
    grid = _make_map(cfg, k[:, 0], fixed_map, map_bank, maze)
    b = keys.shape[0]
    if fixed_agents is not None:
        agents = (fixed_agents + r).expand(b, -1, -1).contiguous()
        targets = (fixed_targets + r).expand(b, -1, -1).contiguous()
        if fixed_map is None:
            # Carve the given cells free so a random map cannot bury them.
            for xy in (agents, targets):
                grid[:, xy[0, :, 0].long(), xy[0, :, 1].long()] = 0
        comps = connected_components(grid)
        ok = torch.ones(b, dtype=torch.bool, device=keys.device)
        return grid, agents, targets, comps, ok
    comps = connected_components(grid)
    a_cells, t_cells, ok = place_agents_and_targets(cfg, k[:, 1], comps)
    return grid, cells_to_xy(a_cells, p), cells_to_xy(t_cells, p), comps, ok


def generate_env(cfg: StaticConfig, keys, fixed_map=None, fixed_agents_xy=None,
                 fixed_targets_xy=None, maze: bool = False, map_bank=None):
    """B env instances: (padded obstacles u8[B, P, P], agents_xy and
    targets_xy i32[B, N, 2], components i64[B, P*P], ok bool[B]). An env
    whose draw cannot be placed is drawn again, up to ``_MAX_TRIES``
    times, each from the next split of its key; ``ok`` stays False for
    an env whose every try failed, and the caller must raise.

    ``fixed_map`` u8[S, S], ``fixed_*_xy`` i32[N, 2] (logical coords)
    and ``map_bank`` u8[K, S, S] are tensors on the keys' device.
    """
    args = (fixed_map, fixed_agents_xy, fixed_targets_xy, maze, map_bank)
    if fixed_agents_xy is not None and fixed_map is not None:
        return _attempt(cfg, keys, *args)

    b = keys.shape[0]
    out = None
    ok = torch.zeros(b, dtype=torch.bool, device=keys.device)
    k = keys
    todo = torch.arange(b, device=keys.device)
    for _ in range(_MAX_TRIES):
        pair = jr.split(k, 2)
        k, sub = pair[:, 0], pair[:, 1]
        res = _attempt(cfg, sub, *args)
        if out is None:
            out = list(res[:4])
            ok = res[4]
        else:
            for dst, src in zip(out, res[:4]):
                dst[todo] = src
            ok[todo] = res[4]
        todo = torch.nonzero(~ok).flatten()
        if todo.numel() == 0:
            break
        k = k[(~res[4]).nonzero().flatten()]
    return (*out, ok)
