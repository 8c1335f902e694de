"""Grids for the tests of K4 and its plain version: u8 [B, P, P] numpy
arrays (nonzero = obstacle), shared by the CPU tests (against the JAX
package) and the card tests (which import no JAX).

The families: the three kinds of world the reset floods (Bernoulli(0.3)
maps, sidewinder mazes and config E's braided mixed pool, each inside the
padded border of width 5 that ``pad_grid`` adds) and hand-made extremes
(an all-free grid, an all-obstacle grid, a checkerboard, isolated cells
on the even lattice, one corridor that spirals inward, the longest
chain of the plain version's sweeps, and rows of three-cell runs, whose
components are too small for all the agents placed in them).
"""

import functools

import numpy as np
import torch

from pogema_torch import GridConfig
from pogema_torch.core import generator
from pogema_torch.maps import mixed_pool

BORDER = 5
WORLDS = ("random", "sidewinder", "pool")
EXTREMES = ("free", "walls", "checkerboard", "isolated", "spiral", "trominoes")
FAMILIES = WORLDS + EXTREMES


def _padded(inner):
    return np.pad(inner, ((0, 0), (BORDER, BORDER), (BORDER, BORDER)), constant_values=1)


@functools.lru_cache(maxsize=None)
def _pool(size):
    """Config E's pool at a side: half Bernoulli maps, half braided mazes."""
    return mixed_pool(size, k=4, braid=0.15)


def spiral(p):
    """One free corridor, one cell wide, that winds inward from the top
    left corner between walls one cell thick: ring k runs along rows and
    columns 1 + 2k and P - 2 - 2k, left open just below its first cell,
    and steps into ring k + 1 from its left column."""
    g = np.ones((p, p), np.uint8)
    lo, hi = 1, p - 2
    while lo <= hi:
        g[lo, lo:hi + 1] = 0
        g[lo:hi + 1, hi] = 0
        g[hi, lo:hi + 1] = 0
        g[lo + 2:hi + 1, lo] = 0
        if lo + 2 <= hi - 2:
            g[lo + 2, lo + 1] = 0
        lo, hi = lo + 2, hi - 2
    return g


def grids(family, b, p, seed=0):
    """u8[B, P, P] of a family; worlds need P > 2 * BORDER."""
    rng = np.random.default_rng(seed)
    s = p - 2 * BORDER
    if family == "random":
        return _padded((rng.random((b, s, s)) < 0.3).astype(np.uint8))
    if family == "sidewinder":
        keys = torch.as_tensor(rng.integers(0, 2**32, (b, 2)), dtype=torch.int64)
        return _padded(generator.sidewinder_maze(GridConfig(size=s).to_static(), keys).numpy())
    if family == "pool":
        return _padded(_pool(s)[rng.integers(0, 4, b)])
    x, y = np.indices((p, p))
    one = {"free": np.zeros((p, p), np.uint8), "walls": np.ones((p, p), np.uint8),
           "checkerboard": ((x + y) % 2).astype(np.uint8),
           "isolated": ((x % 2) | (y % 2)).astype(np.uint8),
           "spiral": spiral(p),
           "trominoes": ((x % 2) | (y % 4 == 3)).astype(np.uint8)}[family]
    return np.broadcast_to(one, (b, p, p)).copy()
