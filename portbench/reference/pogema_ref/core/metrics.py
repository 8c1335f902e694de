"""Episode metrics for B envs, as in ``pogema_tpu/core/metrics.py``.

* ISR — fraction of agents that reached their goal ('finish': ever
  during the episode; 'nothing': standing on it at the end);
* CSR — 1.0 iff every agent succeeded;
* ep_length — steps taken;
* avg_throughput — LifeLong only: goals achieved per step, over agents.

Values are produced every step and hold for an env on the step its
episode ends (the ``done`` mask).
"""

from __future__ import annotations

import torch

from ..grid_config import StaticConfig
from .types import EnvState


def episode_metrics(cfg: StaticConfig, state: EnvState) -> dict:
    """Dict of f32[B]."""
    steps = state.step_count.clamp(min=1).to(torch.float32)
    out = {"ep_length": state.step_count.to(torch.float32)}
    if cfg.on_target == "restart":
        out["avg_throughput"] = state.goals_achieved.sum(dim=-1).to(torch.float32) / steps
        return out
    if cfg.on_target == "nothing":
        succeeded = (state.agents_xy == state.targets_xy).all(dim=-1)
    else:
        succeeded = state.on_goal_ever
    # jit turns jnp.mean's division by N into a product with the f32
    # reciprocal, which can round one ulp away from the quotient.
    recip = torch.reciprocal(torch.tensor(float(succeeded.shape[-1]), device=steps.device))
    out["ISR"] = succeeded.to(torch.float32).sum(dim=-1) * recip
    out["CSR"] = succeeded.all(dim=-1).to(torch.float32)
    return out
