"""Egocentric windows by direct slicing, and the packed observation.

An agent at (x, y) of the padded grid sees ``grid[x - r : x + r + 1,
y - r : y + r + 1]``; a cell outside the grid reads 0. These functions
cut exactly those slices (every window of the grid, padded by r zeros,
as a view; then each agent's), batched over envs. They replace both
hand-written kernels of the measured program by the definition of what
those kernels compute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def windows(grid, xy, w: int) -> torch.Tensor:
    """f32[B, M, w, w]: ``out[b, m] = grid[b, x - r : x + r + 1, y - r : y
    + r + 1]`` for (x, y) = ``xy[b, m]``, zeros outside the grid."""
    r = w // 2
    padded = F.pad(grid.to(torch.float32), (r, r, r, r))
    every = padded.unfold(1, w, 1).unfold(2, w, 1)  # [B, P, P, w, w]
    envs = torch.arange(grid.shape[0], device=grid.device)[:, None]
    return every[envs, xy[..., 0].long(), xy[..., 1].long()]


def agent_counts(grid_shape, xy, active) -> torch.Tensor:
    """f32[B, P, P]: how many active agents stand on each cell."""
    b, p, _ = grid_shape
    counts = torch.zeros(b, p, p, dtype=torch.float32, device=xy.device)
    envs = torch.arange(b, device=xy.device)[:, None].expand(xy.shape[:2])
    counts.index_put_((envs, xy[..., 0].long(), xy[..., 1].long()), active.to(torch.float32),
                      accumulate=True)
    return counts


def target_onehot(agents_xy, targets_xy, w: int) -> torch.Tensor:
    """f32[B, N, w, w]: the agent's own goal marked, clamped onto the
    window border when it lies outside."""
    b, n, _ = agents_xy.shape
    r = w // 2
    rel = (targets_xy.long() - agents_xy.long()).clamp(-r, r) + r
    out = torch.zeros(b, n, w * w, dtype=torch.float32, device=agents_xy.device)
    out.scatter_(2, (rel[..., 0] * w + rel[..., 1])[..., None], 1.0)
    return out.reshape(b, n, w, w)


def observation(grid, agents_xy, targets_xy, active, w: int) -> torch.Tensor:
    """f32[B, N, 3, w, w]: obstacles, the active agents (self included)
    and the own target, each in the agent's window."""
    return torch.stack([windows(grid, agents_xy, w),
                        windows(agent_counts(grid.shape, agents_xy, active), agents_xy, w),
                        target_onehot(agents_xy, targets_xy, w)], dim=2)


def packed_observation(grid, agents_xy, targets_xy, active, w: int) -> torch.Tensor:
    """f32[B, N, 3*w*w]: :func:`observation` with its three blocks laid
    back to back."""
    b, n, _ = agents_xy.shape
    return observation(grid, agents_xy, targets_xy, active, w).reshape(b, n, 3 * w * w)
