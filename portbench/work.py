"""Bytes and operations of the measured work, from shapes alone.

Each function counts what the algorithm needs: every input byte read
once and every output byte written once, whatever a kernel reads again,
and the multiply-adds of the policy's products from the weights' shapes.
"""

from __future__ import annotations

# Bytes per agent of the env state apart from the grid: agents_xy and
# targets_xy (i32 pairs), goals_achieved (i32), active, terminated and
# on_goal_ever (bool).
_AGENT_STATE_BYTES = 8 + 8 + 4 + 1 + 1 + 1
# Bytes per env: step_count (i32), key (two i64 words), placement_ok.
_ENV_STATE_BYTES = 4 + 16 + 1


def padded(size: int, obs_radius: int) -> int:
    """Side of the padded grid the env keeps: the border of width r."""
    return size + 2 * obs_radius


def k1b_bytes(b: int, p: int, n: int, w: int) -> int:
    """Least bytes of one K1b launch: the u8 grid read once, each agent's
    position and target (i32 pairs) and active flag read once, and the
    packed f32 observation [B, N, 3*w*w] written once."""
    return b * p * p + b * n * (2 * 4 + 2 * 4 + 1) + b * n * 3 * w * w * 4


def step_bytes(b: int, p: int, n: int, w: int) -> int:
    """Least bytes of one ``step_autoreset`` with packed observations:
    the grid read once, the state read once and written once, and both
    observations (before and after the reset) written."""
    state = b * (n * _AGENT_STATE_BYTES + _ENV_STATE_BYTES)
    return b * p * p + 2 * state + 2 * b * n * 3 * w * w * 4


def policy_flops(w: int, embed: int, hidden: int, actions: int = 5) -> int:
    """Forward FLOPs of the recurrent policy for one agent-step: the
    embedding GEMM (3*w*w -> embed), the six GRU products (three of the
    input, three of h) and the merged logits-and-value head."""
    return 2 * (3 * w * w * embed + 3 * embed * hidden + 3 * hidden * hidden
                + hidden * (actions + 1))


def train_step_flops(agent_flops: int, envs: int, agents: int, rollout: int,
                     epochs: int) -> int:
    """FLOPs of one recurrent PPO step over ``envs`` global envs: the
    rollout's forwards and the bootstrap forward, and a forward and a
    backward (three forwards) for every agent-step each epoch replays.
    Recomputation is not counted."""
    return agent_flops * envs * agents * (rollout + 1 + 3 * epochs * rollout)
