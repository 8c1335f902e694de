"""Recurrent (GRU) actor-critic over the window embedding.

Counterpart of ``pogema_tpu/models/recurrent.py``
(``RecurrentEmbedActorCritic``): the same first layer as
:class:`~.embed_actor_critic.EmbedActorCritic`, one GRU cell, and the
merged logits/value output GEMM. The hidden state is dtype[B, N, H];
callers carry it and zero it where an episode ended.

The cell is written out in ``flax.linen.GRUCell``'s order, each Dense in
``dtype`` (:func:`~.embed_actor_critic.dense`), because
``torch.nn.GRUCell`` rounds bf16 at other points:

    r  = σ(ir(x) + hr(h))
    z  = σ(iz(x) + hz(h))
    n  = tanh(in(x) + r · hn(h))
    h' = (1 − z) · n + z · h

Only ``ir``, ``iz``, ``in`` and ``hn`` have biases, as in flax. σ is
jax's own form (:func:`_sigmoid`).

Tensor-parallel (``models.tensor_parallel.shard_module``): each rank
holds its slice of the six gates' output features, and so its slice of
h. The h-side products read the whole h, gathered over ``'model'``;
``z · h`` reads the rank's own slice; the carried h stays sharded, and
it is gathered once more for the replicated ``head_out``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..grid_config import NUM_ACTIONS
from ..core.obs import packed_observation
from ..ops import cuda_policy
from .embed_actor_critic import dense, embed_obs, linear
from .tensor_parallel import copy_to_model, gather_from_model

GRU_BIASED = ("ir", "iz", "in", "hn")


def _sigmoid(x):
    """``jax.nn.sigmoid`` as it lowers: 1 / (1 + exp(-x)), each op rounded
    to x's dtype (``torch.sigmoid`` rounds once, and differs in bf16)."""
    return 1.0 / (1.0 + torch.exp(-x))


class RecurrentEmbedActorCritic(nn.Module):
    """Both entry points return ``(new_h, logits f32[..., N, 5],
    value f32[..., N])``."""

    def __init__(self, window: int = 11, embed: int = 128, hidden: int = 128,
                 dtype: torch.dtype = torch.bfloat16, generator=None):
        super().__init__()
        self.window, self.embed, self.hidden, self.dtype = window, embed, hidden, dtype
        fan_in = 3 * window * window
        self.embed_kernel = nn.Parameter(torch.empty(3, window * window, embed))
        self.embed_bias = nn.Parameter(torch.zeros(embed))
        with torch.no_grad():
            nn.init.normal_(self.embed_kernel, 0.0, fan_in ** -0.5, generator=generator)
        gru = {}
        for name in ("ir", "iz", "in", "hr", "hz", "hn"):
            fan = embed if name[0] == "i" else hidden
            gru[name] = linear(fan, hidden, bias=name in GRU_BIASED, generator=generator)
            if name[0] == "h":  # flax's recurrent kernels start orthogonal
                with torch.no_grad():
                    nn.init.orthogonal_(gru[name].weight, generator=generator)
        self.gru = nn.ModuleDict(gru)
        self.head_out = linear(hidden, NUM_ACTIONS + 1, generator=generator)
        self.model_axis = None  # set by models.tensor_parallel.shard_module

    def initial_carry(self, batch_shape, device=None) -> torch.Tensor:
        """Zero hidden state: dtype[*batch_shape, hidden], or this rank's
        slice of hidden when the model is tensor-parallel."""
        device = self.embed_kernel.device if device is None else device
        width = self.gru["hr"].weight.shape[0]
        return torch.zeros(*batch_shape, width, dtype=self.dtype, device=device)

    def _cell(self, h, x):
        g, dt, axis = self.gru, self.dtype, self.model_axis
        h = h.to(dt)
        x = copy_to_model(x, axis)
        h_all = h if axis is None else copy_to_model(gather_from_model(h, axis), axis)
        r = _sigmoid(dense(x, g["ir"], dt) + dense(h_all, g["hr"], dt))
        z = _sigmoid(dense(x, g["iz"], dt) + dense(h_all, g["hz"], dt))
        n = torch.tanh(dense(x, g["in"], dt) + r * dense(h_all, g["hn"], dt))
        return (1.0 - z) * n + z * h

    def _finish(self, h, e):
        new_h = self._cell(h, F.relu(e))
        o = dense(gather_from_model(new_h, self.model_axis), self.head_out, torch.float32)
        return new_h, o[..., :NUM_ACTIONS], o[..., NUM_ACTIONS]

    def step_from_state(self, grids, agents_xy, targets_xy, active, h):
        """One recurrent step from raw state: grids u8[B, P, P];
        agents_xy/targets_xy i32[B, N, 2]; active bool[B, N]; h
        dtype[B, N, hidden]. The packed observation is one K1b launch on
        the card. The rest is one K8 launch where
        ``ops.cuda_policy.engages`` (under inference mode on the card, in
        bf16 at 128/128), else :meth:`step_from_obs`."""
        obs = packed_observation(self.window, grids, agents_xy, targets_xy, active)
        if cuda_policy.engages(self, obs.device):
            h = h.to(self.dtype).contiguous()
            if h.data_ptr() % 16:  # K8 reads h 16 bytes at a time
                h = h.clone()
            return cuda_policy.policy_step(self, obs, h)
        return self.step_from_obs(obs, h)

    def step_from_obs(self, obs, h):
        """The step from the packed observation obs f32[..., N, 3*W*W]:
        the embedding with its bias rounded to ``dtype``, as the JAX
        module's ``step_from_state`` adds it, the cell and the head. K8's
        plain version."""
        bias = self.embed_bias.to(self.dtype)
        return self._finish(h, embed_obs(self.embed_kernel, bias, self.dtype, obs))

    def forward(self, obs, h):
        """obs [..., N, 3, W, W] or packed [..., N, 3*W*W]; h dtype[..., N, hidden].
        As in the JAX module, this path adds the embedding bias unrounded."""
        k = 3 * self.window * self.window
        lead = obs.shape[:-3] if obs.shape[-1] != k else obs.shape[:-1]
        e = embed_obs(self.embed_kernel, self.embed_bias, self.dtype, obs.reshape(*lead, k))
        return self._finish(h, e)


def init_recurrent_params(generator: torch.Generator, window: int, embed: int = 128,
                          hidden: int = 128, dtype: torch.dtype = torch.bfloat16):
    """(model, state_dict) of a freshly initialised recurrent actor-critic,
    drawn from ``generator`` (flax's inits: LeCun-normal input kernels,
    orthogonal recurrent kernels, zero biases)."""
    model = RecurrentEmbedActorCritic(window, embed, hidden, dtype, generator=generator)
    return model, model.state_dict()
