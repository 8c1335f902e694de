"""Convolutional actor-critic over egocentric observations.

Counterpart of ``pogema_tpu/models/actor_critic.py`` (``ActorCritic``):
two 3×3 SAME convolutions, then the ``trunk`` Dense and the ``policy`` and
``value`` heads. Flax stores conv kernels HWIO and runs NHWC; here they
are OIHW on NCHW (``interop.params_from_flax`` converts once), and the
conv output is flattened in NHWC order so that ``trunk`` takes the flax
kernel's row order. Rounding follows flax: each conv and ``trunk`` in
``dtype`` with the bias added in ``dtype``, the heads in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..grid_config import NUM_ACTIONS
from .embed_actor_critic import dense, lecun_normal_, linear


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

    def _conv(self, x, conv):
        y = F.conv2d(x, conv.weight.to(self.dtype), padding=1)
        return F.relu(y + conv.bias.to(self.dtype)[:, None, None])

    def forward(self, obs):
        lead = obs.shape[:-3]
        x = obs.reshape(-1, *obs.shape[-3:]).to(self.dtype)
        x = self._conv(self._conv(x, self.conv1), self.conv2)
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)  # NHWC flatten, as flax
        x = F.relu(dense(x, self.trunk, self.dtype))
        logits = dense(x, self.policy, torch.float32)
        value = dense(x, self.value, torch.float32)
        return logits, value[..., 0]


def init_params(generator: torch.Generator, window: int, hidden: int = 512,
                channels: int = 64, dtype: torch.dtype = torch.bfloat16):
    """(model, state_dict) of a freshly initialised conv actor-critic,
    drawn from ``generator`` (LeCun-normal kernels, zero biases)."""
    model = ActorCritic(window, hidden, channels, dtype, generator=generator)
    return model, model.state_dict()
