"""Recurrent (GRU) actor-critic over the window embedding, as
``pogema_tpu/models/recurrent.py`` (``RecurrentEmbedActorCritic``)
defines it: one linear embedding of the packed observation, one GRU
cell, and the merged logits-and-value output. The hidden state is
dtype[B, N, H]; callers carry it and zero it where an episode ended.

The cell is written out in ``flax.linen.GRUCell``'s order, each Dense in
``dtype`` (:func:`dense`):

    r  = σ(ir(x) + hr(h))
    z  = σ(iz(x) + hz(h))
    n  = tanh(in(x) + r · hn(h))
    h' = (1 − z) · n + z · h

Only ``ir``, ``iz``, ``in`` and ``hn`` have biases, as in flax. σ is
jax's own form (:func:`_sigmoid`).

bf16 rounding points follow flax: a ``Dense(dtype=bf16)`` casts input
and kernel to bf16, its f32-accumulated product is rounded to bf16, then
the bias is added in bf16; ``head_out`` runs in f32. Under autograd the
same casts round the gradients where flax's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..grid_config import NUM_ACTIONS
from ..ops.windows import packed_observation

GRU_BIASED = ("ir", "iz", "in", "hn")


def dense(x, layer: nn.Linear, dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input and kernel cast to ``dtype``,
    the product accumulated in f32 and rounded to ``dtype``, then the
    bias added in ``dtype``."""
    y = torch.matmul(x.to(dtype).float(), layer.weight.to(dtype).float().t()).to(dtype)
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)
    return y


def embed_obs(embed_kernel, bias, dtype, obs) -> torch.Tensor:
    """dtype[..., E]: ``obs`` [..., 3*W*W] (cast to ``dtype``) against the
    kernel rounded to ``dtype``, accumulated in f32, plus ``bias`` in f32,
    then rounded to ``dtype`` once."""
    kernel = embed_kernel.to(dtype).float().reshape(-1, embed_kernel.shape[-1])
    return (torch.matmul(obs.to(dtype).float(), kernel) + bias.float()).to(dtype)


def _sigmoid(x):
    """``jax.nn.sigmoid`` as it lowers: 1 / (1 + exp(-x)), each op rounded
    to x's dtype."""
    return 1.0 / (1.0 + torch.exp(-x))


class RecurrentEmbedActorCritic(nn.Module):
    """Parameters named as the flattened flax leaves; load them with
    ``load_state_dict``."""

    def __init__(self, window: int, embed: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.window, self.dtype = window, dtype
        self.embed_kernel = nn.Parameter(torch.zeros(3, window * window, embed))
        self.embed_bias = nn.Parameter(torch.zeros(embed))
        self.gru = nn.ModuleDict({
            name: nn.Linear(embed if name[0] == "i" else hidden, hidden, bias=name in GRU_BIASED)
            for name in ("ir", "iz", "in", "hr", "hz", "hn")})
        self.head_out = nn.Linear(hidden, NUM_ACTIONS + 1)

    def initial_carry(self, batch_shape, device=None) -> torch.Tensor:
        device = self.embed_kernel.device if device is None else device
        return torch.zeros(*batch_shape, self.gru["hr"].weight.shape[0], dtype=self.dtype,
                           device=device)

    def step_from_state(self, grids, agents_xy, targets_xy, active, h):
        """(new_h, logits f32[B, N, 5], value f32[B, N]) from raw state:
        grids u8[B, P, P]; agents_xy / targets_xy i32[B, N, 2]; active
        bool[B, N]; h dtype[B, N, hidden]."""
        g, dt = self.gru, self.dtype
        obs = packed_observation(grids, agents_xy, targets_xy, active, self.window)
        x = F.relu(embed_obs(self.embed_kernel, self.embed_bias.to(dt), dt, obs))
        h = h.to(dt)
        r = _sigmoid(dense(x, g["ir"], dt) + dense(h, g["hr"], dt))
        z = _sigmoid(dense(x, g["iz"], dt) + dense(h, g["hz"], dt))
        n = torch.tanh(dense(x, g["in"], dt) + r * dense(h, g["hn"], dt))
        new_h = (1.0 - z) * n + z * h
        o = dense(new_h, self.head_out, torch.float32)
        return new_h, o[..., :NUM_ACTIONS], o[..., NUM_ACTIONS]
