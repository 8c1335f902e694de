"""Observations of B envs: the 'default' observation of three channels
per agent (obstacles, active agents, own target) in its window
(``ops.windows``), in the grid layout [B, N, 3, W, W] or the packed
layout [B, N, 3*W*W]."""

from __future__ import annotations

from ..grid_config import StaticConfig
from ..ops.windows import observation, packed_observation


def observe(cfg: StaticConfig, obstacles, agents_xy, targets_xy, active):
    if cfg.observation_type != "default":
        raise NotImplementedError(f"the reference builds 'default' observations only, not "
                                  f"{cfg.observation_type!r}")
    build = packed_observation if cfg.obs_layout == "packed" else observation
    return build(obstacles, agents_xy, targets_xy, active, cfg.window)
