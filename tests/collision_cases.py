"""'priority' collision scenarios for the tests of K2 and its plain
version: numpy inputs, shared by the CPU tests (against the JAX package)
and the card tests (which import no JAX), and the tests' oracle, the
sequential rule as a loop over the agents."""

import numpy as np
import torch

from pogema_torch.grid_config import MOVES

AGENTS = (1, 2, 31, 32, 33, 64, 128, 255, 256, 257)
ENVS = 3

# MOVES: 1 up (-1, 0), 2 down (1, 0), 3 left (0, -1), 4 right (0, 1).
UP, DOWN, LEFT, RIGHT = 1, 2, 3, 4


def _side(n):
    """One grid side for every scenario at N agents, so JAX compiles once
    per N: room for a corridor of N + 1 cells and for N crowded agents."""
    return max(n + 3, 8)


def _crowded(n, p, rng, actions=(0, 5), inactive=0.2):
    """Agents on most cells of a small open square (a tenth of it walls),
    random actions, some agents inactive."""
    k = int(np.ceil(np.sqrt(1.6 * n))) + 1
    grid = np.ones((p, p), np.uint8)
    grid[1:k + 1, 1:k + 1] = np.random.default_rng(rng.integers(2**31)).random((k, k)) < 0.1
    free = np.argwhere(grid == 0)
    while len(free) < n:  # the walls left too few cells: open the square
        grid[1:k + 1, 1:k + 1] = 0
        free = np.argwhere(grid == 0)
    xy = free[rng.choice(len(free), n, replace=False)]
    return grid, xy, rng.random(n) >= inactive, rng.integers(*actions, n)


def _chain(n, p, rng, front_first):
    """N agents in a corridor, all moving right toward its one free cell:
    index 0 at the back (each waits on a later agent: the fixpoint's
    deepest chain) or at the front (all move)."""
    grid = np.ones((p, p), np.uint8)
    grid[1, 1:n + 2] = 0
    cols = np.arange(n)[::-1] + 1 if front_first else np.arange(n) + 1
    xy = np.stack([np.ones(n, np.int64), cols], -1)
    return grid, xy, np.ones(n, bool), np.full(n, RIGHT)


def _cycles(n, p, rng):
    """2x2 rotations (each agent moves onto the next one's cell), agents
    numbered in a random order; the last cycle is short where N is not a
    multiple of 4, so its head has a free cell to move to."""
    grid = np.ones((p, p), np.uint8)
    ring = ((0, 0, RIGHT), (0, 1, DOWN), (1, 1, LEFT), (1, 0, UP))
    per_row = (p - 2) // 3
    xy, act = [], []
    for a in range(n):
        c, (dx, dy, move) = divmod(a, 4)[0], ring[a % 4]
        x0, y0 = 1 + 3 * (c // per_row), 1 + 3 * (c % per_row)
        grid[x0:x0 + 2, y0:y0 + 2] = 0
        xy.append((x0 + dx, y0 + dy))
        act.append(move)
    order = rng.permutation(n)
    return grid, np.array(xy)[order], np.ones(n, bool), np.array(act)[order]


def _pairs(n, p, rng, onto_inactive):
    """Agents two by two on neighbouring cells of a row. Head-on: they
    move toward each other. Onto inactive: the left one moves onto the
    cell of the right one, which is inactive (and asks to move left)."""
    grid = np.ones((p, p), np.uint8)
    per_row = (p - 2) // 3
    xy, act, active = [], [], []
    for a in range(n):
        c, side = divmod(a, 2)
        x, y = 1 + c // per_row, 1 + 3 * (c % per_row) + side
        grid[x, y] = 0
        xy.append((x, y))
        act.append(LEFT if side else RIGHT)
        active.append(not (onto_inactive and side))
    order = rng.permutation(n)
    return grid, np.array(xy)[order], np.array(active)[order], np.array(act)[order]


SCENARIOS = {
    "crowded": lambda n, p, rng: _crowded(n, p, rng),
    "unknown_actions": lambda n, p, rng: _crowded(n, p, rng, actions=(-3, 9)),
    "chain_back_first": lambda n, p, rng: _chain(n, p, rng, front_first=False),
    "chain_front_first": lambda n, p, rng: _chain(n, p, rng, front_first=True),
    "cycles": _cycles,
    "head_on": lambda n, p, rng: _pairs(n, p, rng, onto_inactive=False),
    "onto_inactive": lambda n, p, rng: _pairs(n, p, rng, onto_inactive=True),
}


def scenario(name, n, seed=0):
    """ENVS envs of one scenario at N agents: numpy grid u8[B, P, P],
    xy i32[B, N, 2], active bool[B, N], actions i32[B, N]."""
    p = _side(n)
    envs = [SCENARIOS[name](n, p, np.random.default_rng([seed, n, e])) for e in range(ENVS)]
    grid, xy, active, actions = (np.stack(parts) for parts in zip(*envs))
    return grid, xy.astype(np.int32), active.astype(bool), actions.astype(np.int32)


def random_inputs(b, n, p, seed, density=0.3, inactive=0.1, actions=(-1, 6)):
    """Inputs at a benchmark cell's shapes, as CPU tensors: a border of
    obstacles and `density` walls inside, N agents on distinct free cells
    (the N best of random scores), a share of them inactive, and actions
    drawn from `actions` (values outside [0, 5) stay)."""
    g = torch.Generator().manual_seed(seed)
    grid = torch.ones(b, p, p, dtype=torch.uint8)
    grid[:, 1:-1, 1:-1] = (torch.rand(b, p - 2, p - 2, generator=g) < density).to(torch.uint8)
    scores = torch.rand(b, p * p, generator=g).masked_fill(grid.reshape(b, -1) != 0, -1.0)
    cells = scores.topk(n, dim=1).indices
    xy = torch.stack([cells // p, cells % p], -1).to(torch.int32)
    active = torch.rand(b, n, generator=g) >= inactive
    acts = torch.randint(*actions, (b, n), generator=g, dtype=torch.int32)
    return grid, xy, active, acts


def sequential_priority(obstacles, agents_xy, active, actions):
    """The 'priority' rule as stated: agents in index order, each step
    batched over the envs; agent i moves iff it is active, its action is a
    move in [1, 5), the cell is free of obstacles, and no active agent
    holds the cell at i's turn (earlier agents on their new cells, later
    ones on their old cells). Tensors as K2's wrapper takes them; returns
    i32[B, N, 2]."""
    b, p, _ = obstacles.shape
    n = agents_xy.shape[1]
    act = actions.long()
    known = (act >= 0) & (act < len(MOVES))
    delta = torch.tensor(MOVES, dtype=torch.int32, device=act.device)[act.clamp(0, len(MOVES) - 1)]
    delta = delta * known[..., None].to(torch.int32)
    proposed = agents_xy + delta
    px, py = proposed[..., 0].long(), proposed[..., 1].long()
    inside = (px >= 0) & (px < p) & (py >= 0) & (py < p)
    cell = px.clamp(0, p - 1) * p + py.clamp(0, p - 1)
    hit = inside & (obstacles.reshape(b, p * p).gather(1, cell) != 0)
    cur = agents_xy[..., 0].long() * p + agents_xy[..., 1].long()
    des = cur + delta[..., 0].long() * p + delta[..., 1].long()
    moving = active & ~hit & (des != cur)
    # held[b, j]: the cell agent j holds now; none while inactive.
    held = torch.where(active, cur, torch.iinfo(torch.int64).min)
    moved = torch.zeros_like(moving)
    for i in range(n):
        free = ~(held == des[:, i, None]).any(dim=1)
        moved[:, i] = moving[:, i] & free
        held[:, i] = torch.where(moved[:, i], des[:, i], held[:, i])
    return torch.where(moved[..., None], proposed, agents_xy)
