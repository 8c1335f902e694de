"""Convolutional actor-critic over egocentric observations.

Counterpart of ``pogema_tpu/models/actor_critic.py`` (``ActorCritic``):
two 3×3 SAME convolutions, then the ``trunk`` Dense and the ``policy`` and
``value`` heads. Flax stores conv kernels HWIO and runs NHWC; here they
are OIHW on NCHW (``interop.params_from_flax`` converts once), and the
conv output is flattened in NHWC order so that ``trunk`` takes the flax
kernel's row order. Rounding follows flax: each conv and ``trunk`` in
``dtype`` with the bias added in ``dtype``, the heads in f32.

:func:`partition_params` is the tensor-parallel layout of every model
of the package, as the JAX function of that name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..grid_config import NUM_ACTIONS
from .embed_actor_critic import dense, lecun_normal_, linear
from .tensor_parallel import ModelAxis, copy_to_model, gather_from_model, partition, unpartition


class ActorCritic(nn.Module):
    """Input: [..., 3, W, W]. Output: (logits f32[..., 5], value f32[...])."""

    def __init__(self, window: int = 11, hidden: int = 512, channels: int = 64,
                 dtype: torch.dtype = torch.bfloat16, generator=None):
        super().__init__()
        self.window, self.hidden, self.channels, self.dtype = window, hidden, channels, dtype
        self.conv1 = nn.Conv2d(3, channels, 3, padding=1)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        with torch.no_grad():
            for conv in (self.conv1, self.conv2):
                lecun_normal_(conv.weight, 9 * conv.in_channels, generator)
                conv.bias.zero_()
        self.trunk = linear(window * window * channels, hidden, generator=generator)
        self.policy = linear(hidden, NUM_ACTIONS, generator=generator)
        self.value = linear(hidden, 1, generator=generator)
        self.model_axis = None  # set by models.tensor_parallel.shard_module

    def _conv(self, x, conv):
        y = F.conv2d(x, conv.weight.to(self.dtype), padding=1)
        return F.relu(y + conv.bias.to(self.dtype)[:, None, None])

    def forward(self, obs):
        lead = obs.shape[:-3]
        x = obs.reshape(-1, *obs.shape[-3:]).to(self.dtype)
        x = self._conv(self._conv(x, self.conv1), self.conv2)
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)  # NHWC flatten, as flax
        x = F.relu(dense(copy_to_model(x, self.model_axis), self.trunk, self.dtype))
        x = gather_from_model(x, self.model_axis)
        logits = dense(x, self.policy, torch.float32)
        value = dense(x, self.value, torch.float32)
        return logits, value[..., 0]


def init_params(generator: torch.Generator, window: int, hidden: int = 512,
                channels: int = 64, dtype: torch.dtype = torch.bfloat16):
    """(model, state_dict) of a freshly initialised conv actor-critic,
    drawn from ``generator`` (LeCun-normal kernels, zero biases)."""
    model = ActorCritic(window, hidden, channels, dtype, generator=generator)
    return model, model.state_dict()


def partition_params(params: dict, mesh) -> dict:
    """Tensor-parallel layout: ``{name: tensor}`` (a module's parameters
    or state dict) -> this rank's shard of each. The trunk Dense and all
    six GRU gate weights and biases are split over the ``'model'`` axis
    of ``mesh`` column-wise in flax's terms (each rank owns hidden /
    model output features: dim 0 of the torch ``[out, in]`` weight);
    everything else is replicated. The model that runs them is made
    tensor-parallel by ``models.tensor_parallel.shard_module`` (the
    learner's ``init_*`` and ``make_*`` do it when given the mesh)."""
    return partition(params, ModelAxis(mesh))


def gather_params(params: dict, mesh) -> dict:
    """Inverse of :func:`partition_params`: every rank gets the whole
    tensors (to save or compare them). A collective call over the
    mesh's ``'model'`` axis."""
    return unpartition(params, ModelAxis(mesh))
