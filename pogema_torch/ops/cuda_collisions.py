"""The 'priority' collision rule in CUDA for Hopper: K2.

The kernel lives in ``csrc/collisions.cu`` (design and bound in its source
note), is built with nvcc at first use and called through ctypes. It does
the whole of ``core/collisions.py``'s ``resolve_priority`` for a batch of
envs in one launch: the obstacle check of the proposed moves and the
sequential rule (agents in index order; agent i moves iff it is active,
its action is a move in [1, 5), the cell is free of obstacles, and no
active agent holds the cell at i's turn: earlier agents on their new
cells, later ones on their old cells).

:func:`resolve_priority` returns the plain version,
:func:`resolve_priority_ref` (the same rule as a loop over the agents),
for tensors on the CPU, and launches the kernel or raises for CUDA
tensors. Either way it first refuses what the kernel does not take
(dtype, shape, contiguity, devices), so a caller's fault shows on the CPU
too. ``collisions_cuda.launches`` counts the launches.

Precondition on the card: every agent lies inside the P x P grid (states
of the env keep every agent inside the padded border). The kernel works on
flat int32 cells and writes a blocked mover's position back from its flat
cell, which gives the agent's coordinates only inside the grid.
"""

from __future__ import annotations

import ctypes

import torch

from ..grid_config import MOVES
from . import build

# Agents per env above which the kernel keeps its per-agent slots in a
# global scratch buffer instead of shared memory
# (``csrc/collisions.cu::pogema_collisions_smem_agents``).
SMEM_AGENTS = 6144
# Flat cells (x * P + y, and one step beyond the grid) must fit in int32.
MAX_SIDE = 46340

_fns: dict = {}


def _lib() -> dict:
    if not _fns:
        lib = build.load("collisions")
        fn = lib.pogema_collisions
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        smem = lib.pogema_collisions_smem_agents
        smem.argtypes, smem.restype = [], ctypes.c_int
        if smem() != SMEM_AGENTS:
            raise RuntimeError(f"csrc/collisions.cu keeps {smem()} agents in shared memory, "
                               f"the wrapper expects {SMEM_AGENTS}")
        _fns["pogema_collisions"] = fn
    return _fns


def _check(obstacles, agents_xy, active, actions) -> None:
    tensors = (("obstacles", obstacles), ("agents_xy", agents_xy), ("active", active),
               ("actions", actions))
    if obstacles.device.type not in ("cpu", "cuda") or any(t.device != obstacles.device
                                                           for _, t in tensors):
        raise ValueError("all inputs must lie on one device, the CPU or a CUDA device, got "
                         + ", ".join(f"{k}: {t.device}" for k, t in tensors))
    for name, t, dtypes in (("obstacles", obstacles, (torch.uint8, torch.bool)),
                            ("agents_xy", agents_xy, (torch.int32,)),
                            ("active", active, (torch.bool,)),
                            ("actions", actions, (torch.int32, torch.int64))):
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
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
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def resolve_priority_ref(obstacles, agents_xy, active, actions) -> torch.Tensor:
    """The plain version: the sequential rule as a loop over the agents,
    each step batched over the envs. Returns i32[B, N, 2]."""
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
    fn = _lib()["pogema_collisions"]
    with torch.cuda.device(agents_xy.device):
        rc = fn(obstacles.data_ptr(), agents_xy.data_ptr(), active.data_ptr(), actions.data_ptr(),
                int(actions.dtype == torch.int64), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), b, n, p,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"priority_kernel launch failed: CUDA error {rc}")
    collisions_cuda.launches += 1
    return out


collisions_cuda.launches = 0


def resolve_priority(obstacles: torch.Tensor, agents_xy: torch.Tensor, active: torch.Tensor,
                     actions: torch.Tensor) -> torch.Tensor:
    """K2. obstacles: u8 or bool [B, P, P] (nonzero = obstacle); agents_xy:
    i32[B, N, 2]; active: bool[B, N]; actions: i32 or i64 [B, N], values
    outside [0, 5) staying. Returns the new positions, i32[B, N, 2]."""
    _check(obstacles, agents_xy, active, actions)
    if obstacles.device.type == "cpu":
        return resolve_priority_ref(obstacles, agents_xy, active, actions)
    return collisions_cuda(obstacles, agents_xy, active, actions)
