"""Observation assembly, batched over envs.

Counterpart of ``pogema_tpu/core/obs.py``. Three channels per agent:

* obstacles: the egocentric window of the padded grid. On the card it
  comes from the K1 kernel (``ops.cuda_windows.extract_windows_packed``),
  on the CPU from its plain version;
* agents: which active agents stand in the window, self included
  (``ops.windows.pairwise_agent_windows``);
* target: the agent's own goal, clamped onto the window border
  (``ops.windows.target_onehot``).
"""

from __future__ import annotations

import torch

from ..grid_config import StaticConfig
from ..ops.cuda_windows import extract_windows_packed
from ..ops.windows import pairwise_agent_windows, target_onehot


def obstacle_windows(cfg: StaticConfig, obstacles, xy) -> torch.Tensor:
    """f32[B, M, W*W]: obstacle windows centred on ``xy`` (i32[B, M, 2]),
    flattened row-major. One K1 launch for CUDA tensors."""
    w = cfg.window
    return extract_windows_packed(obstacles, xy.contiguous(), w)[..., : w * w]


def target_channel(cfg: StaticConfig, agents_xy, targets_xy) -> torch.Tensor:
    """f32[B, N, W, W]: own goal marked, clamped onto the border."""
    return target_onehot(agents_xy, targets_xy, cfg.window)


def packed_observation(w: int, obstacles, agents_xy, targets_xy, active, obst_w=None):
    """f32[B, N, 3*W*W]: the packed 'default' observation, the
    [obstacles | agents | target] blocks back to back. ``obst_w``: the
    obstacle windows when the caller has them; else one K1 launch for
    CUDA tensors."""
    b, n, _ = agents_xy.shape
    if obst_w is None:
        obst_w = extract_windows_packed(obstacles, agents_xy.contiguous(), w)[..., : w * w]
    return torch.cat([obst_w, pairwise_agent_windows(agents_xy, active, w).reshape(b, n, w * w),
                      target_onehot(agents_xy, targets_xy, w).reshape(b, n, w * w)], dim=-1)


def observe(cfg: StaticConfig, obstacles, agents_xy, targets_xy, active, obst_w=None):
    """Observations of B envs according to ``cfg.observation_type``.

    'default': f32[B, N, 3, W, W] (layout 'grid') or f32[B, N, 3*W*W]
    (layout 'packed': the [obstacles | agents | target] blocks back to
    back, a reshape of the grid layout).
    'POMAPF': dict of per-agent windows plus own and target coordinates.
    'MAPF': POMAPF plus the global obstacle map and all coordinates.
    Coordinates in the dicts are unpadded (logical S×S grid).

    ``obst_w``: the obstacle windows (f32[B, N, W*W]) when the caller has
    them already; computed here otherwise.
    """
    r = cfg.obs_radius
    w = cfg.window
    b, n, _ = agents_xy.shape
    if cfg.observation_type == "default" and cfg.obs_layout == "packed":
        return packed_observation(w, obstacles, agents_xy, targets_xy, active, obst_w)
    if obst_w is None:
        obst_w = obstacle_windows(cfg, obstacles, agents_xy)
    agents_w = pairwise_agent_windows(agents_xy, active, w)

    if cfg.observation_type == "default":
        targ_w = target_channel(cfg, agents_xy, targets_xy)
        return torch.stack([obst_w.reshape(b, n, w, w), agents_w, targ_w], dim=2)

    out = {
        "obstacles": obst_w.reshape(b, n, w, w),
        "agents": agents_w,
        "xy": agents_xy - r,
        "target_xy": targets_xy - r,
    }
    if cfg.observation_type == "MAPF":
        s = cfg.size
        out["global_obstacles"] = obstacles[:, r:r + s, r:r + s].contiguous()
        out["global_xy"] = agents_xy - r
        out["global_target_xy"] = targets_xy - r
    return out
