"""The 'priority' collision rule in CUDA for Hopper: K2.

The kernel lives in ``csrc/collisions.cu`` (design and bound in its source
note), is built with nvcc at first use and launched through
``ops/launch.py``. It does the whole of :func:`resolve_priority` for a
batch of envs in one launch: the obstacle check of the proposed moves and
the sequential rule (agents in index order; agent i moves iff it is
active, its action is a move in [1, 5), the cell is free of obstacles, and
no active agent holds the cell at i's turn: earlier agents on their new
cells, later ones on their old cells).

:func:`resolve_priority` returns the plain version,
``ops.collisions.resolve_priority`` (the Jacobi fixpoint whose unique
fixpoint is the sequential result), for tensors on the CPU, and launches
the kernel or raises for CUDA tensors. Either way it first refuses what
the kernel does not take (dtype, shape, contiguity, devices), so a
caller's fault shows on the CPU too. ``collisions_cuda.launches`` counts
the launches.

Precondition on the card: every agent lies inside the P x P grid (states
of the env keep every agent inside the padded border). The kernel works on
flat int32 cells and writes a blocked mover's position back from its flat
cell, which gives the agent's coordinates only inside the grid.
"""

from __future__ import annotations

import torch

from . import collisions, launch
from .launch import I32, PTR

# Agents per env above which the kernel keeps its per-agent slots in a
# global scratch buffer instead of shared memory
# (``csrc/collisions.cu::pogema_collisions_smem_agents``).
SMEM_AGENTS = 6144
# Flat cells (x * P + y, and one step beyond the grid) must fit in int32.
MAX_SIDE = 46340

_GRID, _I32, _BOOL = (torch.uint8, torch.bool), (torch.int32,), (torch.bool,)
_ACTIONS = (torch.int32, torch.int64)


class _Priority(launch.Kernel):
    """K2's launch entry, bound only where the kernel keeps as many agents
    in shared memory as :data:`SMEM_AGENTS` says."""

    def bind(self):
        smem = launch.bind("collisions", "pogema_collisions_smem_agents")()
        if smem != SMEM_AGENTS:
            raise RuntimeError(f"csrc/collisions.cu keeps {smem} agents in shared memory, "
                               f"the wrapper expects {SMEM_AGENTS}")
        return super().bind()


def collisions_cuda(obstacles, agents_xy, active, actions) -> torch.Tensor:
    """One K2 launch on checked CUDA inputs; returns i32[B, N, 2]."""
    b, p, _ = obstacles.shape
    n = agents_xy.shape[1]
    out = torch.empty((b, n, 2), dtype=torch.int32, device=agents_xy.device)
    if b * n == 0:  # nothing to launch (and nothing counted)
        return out
    # Above SMEM_AGENTS the kernel keeps two int32 slots an agent, in
    # whole warps of 32, in global memory.
    scratch = (torch.empty((b, 64 * -(-n // 32)), dtype=torch.int32, device=agents_xy.device)
               if n > SMEM_AGENTS else None)
    _K2(agents_xy.device, obstacles.data_ptr(), agents_xy.data_ptr(), active.data_ptr(),
        actions.data_ptr(), int(actions.dtype == torch.int64), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, n, p)
    return out


_K2 = _Priority("collisions", "pogema_collisions", (PTR,) * 4 + (I32,) + (PTR,) * 2 + (I32,) * 3,
                "priority_kernel", collisions_cuda)


def resolve_priority(obstacles: torch.Tensor, agents_xy: torch.Tensor, active: torch.Tensor,
                     actions: torch.Tensor) -> torch.Tensor:
    """K2. obstacles: u8 or bool [B, P, P] (nonzero = obstacle); agents_xy:
    i32[B, N, 2]; active: bool[B, N]; actions: i32 or i64 [B, N], values
    outside [0, 5) staying. Returns the new positions, i32[B, N, 2]."""
    launch.check(("obstacles", obstacles, _GRID), ("agents_xy", agents_xy, _I32),
                 ("active", active, _BOOL), ("actions", actions, _ACTIONS))
    if obstacles.dim() != 3 or obstacles.shape[1] != obstacles.shape[2]:
        raise ValueError(f"obstacles must be [B, P, P], got {tuple(obstacles.shape)}")
    if not 1 <= obstacles.shape[1] <= MAX_SIDE:
        raise ValueError(f"the grid's side must be in [1, {MAX_SIDE}], got {obstacles.shape[1]}")
    b = obstacles.shape[0]
    n = agents_xy.shape[1] if agents_xy.dim() == 3 else -1
    for name, t, shape in (("agents_xy", agents_xy, (b, n, 2)), ("active", active, (b, n)),
                           ("actions", actions, (b, n))):
        if n < 0 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} with the obstacles' B and "
                             f"agents_xy's N, got {tuple(t.shape)}")
    if obstacles.device.type == "cpu":
        return collisions.resolve_priority(obstacles, agents_xy, active, actions)
    return collisions_cuda(obstacles, agents_xy, active, actions)
