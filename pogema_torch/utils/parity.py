"""Host-side parity generator.

Counterpart of ``pogema_tpu/utils/parity.py``, a numpy copy that imports
the port's own ``GridConfig``.

The on-device generator uses a threefry RNG (the port's
``core/random.py``, bit-equal to JAX's); the reference uses NumPy
``np.random.default_rng(seed)`` (PCG64). Bit-exact seed parity with the
reference is therefore only achievable by reproducing the reference's
host RNG path and feeding the result into the engine as a fixed
map/placement — which is exactly what this module does.

IMPORTANT CONFIDENCE NOTE: the reference's exact draw ORDER (obstacles →
agent cells → target cells, with BFS-reachability retry loops) is
reconstructed from SURVEY.md §3.1 at [MED] confidence; the mounted
reference stub carries no source. When real pogema is importable, pin
this function with differential tests before trusting cross-engine
seed parity. Within THIS engine it is deterministic and stable either way.

Usage:
    grid, agents_xy, targets_xy = host_generate(GridConfig(seed=42, ...))
    cfg = cfg.model_copy(update=dict(map=grid, agents_xy=agents_xy,
                                     targets_xy=targets_xy))
    env = pogema_v0(cfg)   # engine now replays the host-generated episode
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..grid_config import FREE, OBSTACLE, GridConfig


def _components(grid: np.ndarray) -> np.ndarray:
    """BFS 4-connectivity labels; -1 for obstacles."""
    s = grid.shape[0]
    labels = np.full((s, s), -1, np.int64)
    cur = 0
    for sx in range(s):
        for sy in range(s):
            if grid[sx, sy] == OBSTACLE or labels[sx, sy] != -1:
                continue
            q = deque([(sx, sy)])
            labels[sx, sy] = cur
            while q:
                x, y = q.popleft()
                for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    nx, ny = x + dx, y + dy
                    if (
                        0 <= nx < s and 0 <= ny < s
                        and grid[nx, ny] == FREE and labels[nx, ny] == -1
                    ):
                        labels[nx, ny] = cur
                        q.append((nx, ny))
            cur += 1
    return labels


def host_generate(cfg: GridConfig, max_retries: int = 100):
    """(grid list[list[int]], agents_xy, targets_xy) using
    np.random.default_rng(cfg.seed) in the reconstructed reference order:
    obstacles first, then agent starts (distinct free cells in components
    of size >= 2), then per-agent targets (distinct free cells reachable
    from the start, != the start). Retries the whole draw when placement
    fails, like upstream generate_obstacles/placement."""
    rng = np.random.default_rng(cfg.seed)
    s = cfg.size
    for _ in range(max_retries):
        grid = (rng.random((s, s)) < cfg.density).astype(np.uint8)
        labels = _components(grid)
        sizes = np.bincount(labels[labels >= 0], minlength=labels.max() + 2)
        eligible = [
            (x, y)
            for x in range(s)
            for y in range(s)
            if labels[x, y] >= 0 and sizes[labels[x, y]] >= 2
        ]
        if len(eligible) < cfg.num_agents:
            continue
        idx = rng.choice(len(eligible), size=cfg.num_agents, replace=False)
        agents = [eligible[i] for i in idx]
        used = set()
        targets = []
        ok = True
        for ax, ay in agents:
            comp = labels[ax, ay]
            options = [
                (x, y)
                for x in range(s)
                for y in range(s)
                if labels[x, y] == comp and (x, y) != (ax, ay)
                and (x, y) not in used
            ]
            if not options:
                ok = False
                break
            tx, ty = options[rng.integers(len(options))]
            used.add((tx, ty))
            targets.append((tx, ty))
        if not ok:
            continue
        return (
            grid.astype(int).tolist(),
            [list(a) for a in agents],
            [list(t) for t in targets],
        )
    raise RuntimeError("could not place agents after retries — config too dense")


def parity_config(cfg: GridConfig) -> GridConfig:
    """A copy of ``cfg`` with the host-generated map/placement baked in,
    ready for ``pogema_v0``/``PogemaCore``."""
    grid, agents_xy, targets_xy = host_generate(cfg)
    return cfg.model_copy(
        update={"map": grid, "agents_xy": agents_xy, "targets_xy": targets_xy}
    )
