"""Batched evaluation and PPO training of policies on one device."""

from .evaluator import make_policy_evaluator
from .learner import (
    PPOConfig,
    RecurrentTrainState,
    TrainState,
    init_fused_train_state,
    init_recurrent_train_state,
    init_train_state,
    make_fused_train_many,
    make_fused_train_step,
    make_recurrent_train_many,
    make_recurrent_train_step,
    make_train_step,
)
from .optim import Optimizer
from .rollout import (
    make_recurrent_rollout_fn,
    make_rollout_fn,
    make_state_rollout_fn,
)

__all__ = [
    "make_rollout_fn",
    "make_state_rollout_fn",
    "make_recurrent_rollout_fn",
    "PPOConfig",
    "TrainState",
    "RecurrentTrainState",
    "Optimizer",
    "make_train_step",
    "init_train_state",
    "make_fused_train_step",
    "make_fused_train_many",
    "init_fused_train_state",
    "init_recurrent_train_state",
    "make_recurrent_train_step",
    "make_recurrent_train_many",
    "make_policy_evaluator",
]
