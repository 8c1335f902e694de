"""EnvState and StepResult as dataclasses of torch tensors.

Counterpart of ``pogema_tpu/core/types.py``. Every field carries the
leading batch axis ``B`` (there is no vmap of one env), and every
tensor lies on one explicit device.

Coordinates are (row, col) in the *padded* grid: the obstacle matrix is
border-padded by ``obs_radius`` on every side, so cell (x, y) of the
logical S×S grid lives at (x + r, y + r) and observation windows never
leave the array.

The JAX state's ``obstacle_nibbles`` leaf is not carried: it caches a
nibble-packed copy of the grid for the TPU's matmul lookup, and the
card reads the grid byte directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Field name -> dtype, in EnvState order (target_queue may also be i32).
FIELDS = {
    "obstacles": torch.uint8,       # [B, P, P], 1 = obstacle
    "agents_xy": torch.int32,       # [B, N, 2] padded coords
    "targets_xy": torch.int32,      # [B, N, 2]
    "target_queue": torch.int16,    # [B, N, Q] LifeLong goal cells, else None
    "active": torch.bool,           # [B, N] visible and moving
    "terminated": torch.bool,       # [B, N]
    "on_goal_ever": torch.bool,     # [B, N]
    "goals_achieved": torch.int32,  # [B, N]
    "step_count": torch.int32,      # [B]
    "key": torch.int64,             # [B, 2] threefry key words in [0, 2**32)
    "placement_ok": torch.bool,     # [B]
}


@dataclasses.dataclass
class EnvState:
    obstacles: torch.Tensor
    agents_xy: torch.Tensor
    targets_xy: torch.Tensor
    # LifeLong ('restart') only, None otherwise: int[B, N, Q] queue of
    # future goal cells per agent; the k-th scored goal reads entry
    # (k-1) mod Q (the head pointer is goals_achieved). Episode-invariant.
    target_queue: Optional[torch.Tensor]
    active: torch.Tensor
    terminated: torch.Tensor
    on_goal_ever: torch.Tensor
    goals_achieved: torch.Tensor
    step_count: torch.Tensor
    key: torch.Tensor
    placement_ok: torch.Tensor

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    def tensors(self) -> dict:
        """Field name -> tensor, without the None leaves."""
        return {f: getattr(self, f) for f in FIELDS if getattr(self, f) is not None}


@dataclasses.dataclass
class StepResult:
    """Everything ``step`` hands back besides the new state."""

    observations: object  # f32[B, N, 3, W, W], [B, N, 3*W*W] or a dict
    rewards: torch.Tensor  # f32[B, N]
    terminated: torch.Tensor  # bool[B, N]
    truncated: torch.Tensor  # bool[B, N]
