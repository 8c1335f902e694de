"""Egocentric windows and pairwise agent geometry, in plain PyTorch.

Counterparts of ``pogema_tpu/ops/windows.py``. The JAX package builds
these from one-hot matmuls because gathers serialize on the TPU; on the
card (and on the CPU) a gather over the window offsets is the direct
form, so these functions index the grid. Every function is batched over
envs ``B``; out-of-range cells read as 0, as the one-hot form gives.

``extract_windows_packed_ref`` and ``packed_observation_ref`` are the
plain versions of the two hand-written CUDA kernels in
``ops/cuda_windows.py``: K1, the port of the Pallas kernel
``pogema_tpu/ops/pallas_windows.py::extract_windows_packed``, and K1b,
the whole packed observation in one launch.
"""

from __future__ import annotations

import torch


def packed_lanes(w: int) -> int:
    """Lane width of the packed window layout: w*w rounded up to 128."""
    return 128 * -(-(w * w) // 128)


def extract_windows(grid, xy, w: int) -> torch.Tensor:
    """grid: [B, P, P] (any numeric dtype), xy: i32[B, M, 2] window
    centres, w: odd window size. Returns f32[B, M, w, w] with
    ``out[b, n, i, j] = grid[b, x - r + i, y - r + j]``."""
    b, p, _ = grid.shape
    m = xy.shape[1]
    r = w // 2
    offs = torch.arange(w, device=xy.device, dtype=torch.int64) - r
    rows = xy[..., 0:1].long() + offs  # [B, M, w]
    cols = xy[..., 1:2].long() + offs
    valid = ((rows >= 0) & (rows < p))[..., :, None] & ((cols >= 0) & (cols < p))[..., None, :]
    flat = rows.clamp(0, p - 1)[..., :, None] * p + cols.clamp(0, p - 1)[..., None, :]
    vals = grid.reshape(b, p * p).gather(1, flat.reshape(b, m * w * w))
    vals = vals.reshape(b, m, w, w).to(torch.float32)
    return torch.where(valid, vals, torch.zeros((), dtype=torch.float32, device=vals.device))


def neighborhoods3x3(grid, xy) -> torch.Tensor:
    """f32[B, M, 3, 3] neighbourhoods, enough to validate all 5 moves:
    :func:`extract_windows` with w = 3."""
    return extract_windows(grid, xy, 3)


def extract_windows_packed_ref(grid, xy, w: int) -> torch.Tensor:
    """Plain version of the packed-window kernel: f32[B, M, L] with the
    window flattened row-major into lanes [0, w*w) and zeros after,
    ``L = packed_lanes(w)`` (128 for w <= 11)."""
    b, m = xy.shape[:2]
    out = torch.zeros(b, m, packed_lanes(w), dtype=torch.float32, device=grid.device)
    out[..., : w * w] = extract_windows(grid, xy, w).reshape(b, m, w * w)
    return out


def pairwise_agent_windows(xy, active, w: int) -> torch.Tensor:
    """Agents channel, f32[B, N, w, w]: ``out[b, n, i, j]`` counts the
    active agents at offset (i-r, j-r) from agent n, itself included
    (0/1, since active agents never share a cell). Inactive agents are
    invisible."""
    b, n, _ = xy.shape
    r = w // 2
    x = xy[..., 0].long()
    y = xy[..., 1].long()
    dx = x[:, None, :] - x[:, :, None] + r  # [B, n, m]: agent m seen from n
    dy = y[:, None, :] - y[:, :, None] + r
    seen = (dx >= 0) & (dx < w) & (dy >= 0) & (dy < w) & active[:, None, :]
    idx = torch.where(seen, dx * w + dy, torch.full_like(dx, w * w))
    out = torch.zeros(b, n, w * w + 1, dtype=torch.float32, device=xy.device)
    out.scatter_add_(2, idx, torch.ones(idx.shape, dtype=torch.float32, device=xy.device))
    return out[..., : w * w].reshape(b, n, w, w)


def target_onehot(agents_xy, targets_xy, w: int) -> torch.Tensor:
    """Target channel, f32[B, N, w, w]: the agent's own goal marked,
    clamped onto the window border when it lies outside."""
    b, n, _ = agents_xy.shape
    r = w // 2
    rel = (targets_xy.long() - agents_xy.long()).clamp(-r, r) + r  # [B, N, 2]
    idx = (rel[..., 0] * w + rel[..., 1])[..., None]
    out = torch.zeros(b, n, w * w, dtype=torch.float32, device=agents_xy.device)
    out.scatter_(2, idx, 1.0)
    return out.reshape(b, n, w, w)


def packed_observation_ref(grid, agents_xy, targets_xy, active, w: int) -> torch.Tensor:
    """Plain version of the packed-observation kernel: f32[B, N, 3*w*w],
    the [obstacles | agents | target] blocks back to back, composed from
    the three functions above as ``pogema_tpu/core/obs.py::observe``
    composes its own for ``obs_layout='packed'``."""
    b, n, _ = agents_xy.shape
    return torch.cat([extract_windows(grid, agents_xy, w).reshape(b, n, w * w),
                      pairwise_agent_windows(agents_xy, active, w).reshape(b, n, w * w),
                      target_onehot(agents_xy, targets_xy, w).reshape(b, n, w * w)], dim=-1)
