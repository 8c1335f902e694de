"""Batched evaluation and PPO training of policies, on one device or
over a mesh of processes (``mesh``)."""

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
from .mesh import (
    batch_sharding,
    gather_batch,
    global_batch_from_host,
    initialize_distributed,
    make_mesh,
    replicated,
    shard_batch,
)
from .optim import Optimizer
from .rollout import (
    make_recurrent_rollout_fn,
    make_rollout_fn,
    make_state_rollout_fn,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "initialize_distributed",
    "global_batch_from_host",
    "gather_batch",
    "batch_sharding",
    "replicated",
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
