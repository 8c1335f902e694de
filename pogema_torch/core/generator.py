"""Procedural generation, batched over envs: maps, components, placement.

Counterpart of ``pogema_tpu/core/generator.py``. Every draw comes from
the threefry stream of ``core.random`` so that a reset is bit-equal to
the JAX package's for the same key:

* random maps: iid Bernoulli(density) per cell;
* sidewinder mazes: row runs of eastward carves, each run carving one
  northward passage at its member with the largest uniform;
* connected components: labels are the minimum flat index of each
  component, by K4's union-find on a card and by the plain min-label
  flood fill of segmented scans on the CPU;
* placement: agents at the top-N uniforms over eligible cells (ties to
  the lower index, as ``lax.top_k``), each target the first argmax of
  masked random bits over the free cells of the agent's component, by
  K9 on a card and by the plain loop over the agents on the CPU;
* the LifeLong goal queue drawn from a component-sorted cell table;
* the bounded retry loop of ``generate_env``.

Keys are int64 ``[B, 2]``; every function returns tensors with a leading
``B``. The host syncs once per retry, and on the CPU once per
flood-fill sweep; ``generate_env.tries`` and
``connected_components.sweeps`` count them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..grid_config import OBSTACLE, StaticConfig
from ..ops import components, cuda_components, cuda_placement
from ..ops.placement import multi_cell_component  # noqa: F401  (the eligibility mask, for callers)
from ..utils.profiling import traced
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


@traced("pogema.generator.components")
def connected_components(padded_grid) -> torch.Tensor:
    """i64[B, P*P]: for free cells the minimum flat index of their
    4-connected component; P*P for obstacles. On a card one K4 launch
    (``ops/cuda_components.py``) with no host sync; on the CPU the plain
    flood fill (``ops/components.py``), whose host-synced sweeps
    ``connected_components.sweeps`` counts (the attribute sits on the
    traced wrapper, which is what this module exports; K4 adds none)."""
    before = components.connected_components.sweeps
    labels = cuda_components.connected_components(padded_grid)
    connected_components.sweeps += components.connected_components.sweeps - before
    return labels


connected_components.sweeps = 0


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@traced("pogema.generator.place")
def place_agents_and_targets(cfg: StaticConfig, keys, components):
    """N distinct agent cells among eligible cells, then per agent a
    target: a free cell of its component, distinct from earlier targets
    and from its own start. Returns (agent_cells i64[B, N], target_cells
    i64[B, N], ok bool[B]). On a card one K9 launch
    (``ops/cuda_placement.py``) with no host sync; on the CPU the plain
    version (``ops/placement.py``)."""
    return cuda_placement.place_agents_and_targets(keys.contiguous(), components.contiguous(),
                                                   cfg.padded_size, cfg.num_agents)


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


@traced("pogema.generator.queue")
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


@traced("pogema.generator.map")
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
    an env whose every try failed, and the caller must raise or fall
    back. ``generate_env.tries`` counts the tries of that loop and
    ``generate_env.unplaced`` the envs still unplaced after its last try.

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
        generate_env.tries += 1
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
    generate_env.unplaced += todo.numel()
    return (*out, ok)


generate_env.tries = 0
generate_env.unplaced = 0
