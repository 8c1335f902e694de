"""Observation assembly, batched over envs.

Counterpart of ``pogema_tpu/core/obs.py``. Three channels per agent:

* obstacles: the egocentric window of the padded grid;
* agents: how many active agents stand in each window cell, self
  included (``ops.windows.pairwise_agent_windows``);
* target: the agent's own goal, clamped onto the window border
  (``ops.windows.target_onehot``).

On the card two hand-written kernels build them
(``ops.cuda_windows``): the packed 'default' layout is one launch of K1b
(``packed_observation_cuda``, all three blocks at once), and every other
layout and type takes its obstacle windows from one launch of K1
(``extract_windows_packed``) and the other two channels from plain
PyTorch. On the CPU both wrappers run their plain versions.
"""

from __future__ import annotations

import torch

from ..grid_config import StaticConfig
from ..ops.cuda_windows import extract_windows_packed, packed_observation_cuda
from ..ops.windows import pairwise_agent_windows, target_onehot


def obstacle_windows(cfg: StaticConfig, obstacles, xy) -> torch.Tensor:
    """f32[B, M, W*W]: obstacle windows centred on ``xy`` (i32[B, M, 2]),
    flattened row-major. One K1 launch for CUDA tensors."""
    w = cfg.window
    return extract_windows_packed(obstacles, xy.contiguous(), w)[..., : w * w]


def target_channel(cfg: StaticConfig, agents_xy, targets_xy) -> torch.Tensor:
    """f32[B, N, W, W]: own goal marked, clamped onto the border."""
    return target_onehot(agents_xy, targets_xy, cfg.window)


def packed_observation(w: int, obstacles, agents_xy, targets_xy, active):
    """f32[B, N, 3*W*W]: the packed 'default' observation, the
    [obstacles | agents | target] blocks back to back. One K1b launch for
    CUDA tensors, the plain composition on the CPU. ``obstacles`` must be
    contiguous (the env's grids are); the per-agent tensors are copied if
    they are views."""
    return packed_observation_cuda(obstacles, agents_xy.contiguous(), targets_xy.contiguous(),
                                   active.contiguous(), w)


def observe(cfg: StaticConfig, obstacles, agents_xy, targets_xy, active, obst_w=None):
    """Observations of B envs according to ``cfg.observation_type``.

    'default': f32[B, N, 3, W, W] (layout 'grid') or f32[B, N, 3*W*W]
    (layout 'packed': the [obstacles | agents | target] blocks back to
    back, a reshape of the grid layout).
    'POMAPF': dict of per-agent windows plus own and target coordinates.
    'MAPF': POMAPF plus the global obstacle map and all coordinates.
    Coordinates in the dicts are unpadded (logical S×S grid).

    ``obst_w``: the obstacle windows (f32[B, N, W*W]) when the caller has
    them already; computed here otherwise. The packed 'default' layout
    builds all three blocks at once and does not take them.
    """
    r = cfg.obs_radius
    w = cfg.window
    b, n, _ = agents_xy.shape
    if cfg.observation_type == "default" and cfg.obs_layout == "packed":
        return packed_observation(w, obstacles, agents_xy, targets_xy, active)
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
