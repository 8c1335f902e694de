"""Feedforward window-embedding actor-critic.

Counterpart of ``pogema_tpu/models/embed_actor_critic.py``
(``EmbedActorCritic``, ``embed_state_windows``,
``embed_state_windows_occ``). The first layer is a
linear map of the egocentric observation ``[3, W, W]`` (obstacles,
agents, target), so it is stored as one ``embed_kernel`` f32[3, W*W, E].

Form chosen here: the packed observation ``[B*N, 3*W*W]`` is built and
contracted against the kernel in ONE f32 GEMM ``[B*N, 3*W*W] @ [3*W*W,
E]``. The JAX package sums three per-channel einsums instead; both
compute the same function (``tests/test_fused.py`` gates that on the JAX
side), up to the f32 summation order. The observation entries are 0/1
and the kernel is rounded to ``dtype`` first, so the f32 GEMM reproduces
JAX's ``dtype`` einsum with f32 accumulation (``preferred_element_type``);
the sum and the bias are rounded to ``dtype`` once.

The observation is ``core.obs.packed_observation``, the env's own packed
layout: on the card one launch of the K1b kernel per ``from_state`` call
(``ops.cuda_windows.packed_observation_cuda``, all three blocks at
once), on the CPU K1b's plain version.

bf16 rounding points follow flax: a ``Dense(dtype=bf16)`` casts input
and kernel to bf16, its f32-accumulated product is rounded to bf16, then
the bias is added in bf16 (:func:`dense`); ``head_out`` runs in f32 on
the promoted input. On the CPU this reproduces flax bit for bit wherever
the f32 summation order agrees.

Under autograd the same casts round the gradients where flax's do: in
:func:`dense` and :func:`embed_obs` the cotangent of a ``dtype`` output
is ``dtype``, the two products of the backward pass run in f32 on it, and
``dW`` and ``dx`` are rounded to ``dtype`` by the backward of
``.to(dtype).float()`` before the f32 parameter (or the layer below) sees
them, as the transposes of flax's bf16 ``dot_general`` do. With
``dtype=float32`` every cast is the identity.

A third entry point, ``from_state_pre``, reads a precomputed
``grid_embed`` (one VALID conv of the static grids) for the obstacle
term; the learner's ``'pre'`` path uses it, and it launches no kernel of
``ops.cuda_windows``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.obs import packed_observation
from ..grid_config import NUM_ACTIONS
from ..ops.windows import extract_windows, pairwise_agent_windows, target_onehot
from .tensor_parallel import copy_to_model, gather_from_model


def dense(x, layer: nn.Linear, dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input and kernel cast to ``dtype``,
    the product accumulated in f32 and rounded to ``dtype``, then the
    bias added in ``dtype``. The product runs as an f32 GEMM of the
    rounded operands, which is that function exactly; a bf16 GEMM may
    reduce in bf16 (cuBLAS's reduced-precision reduction, oneDNN's
    blocking) and then differs from flax in the last bit."""
    y = torch.matmul(x.to(dtype).float(), layer.weight.to(dtype).float().t()).to(dtype)
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)
    return y


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's default kernel init: truncated normal on [-2σ, 2σ] with the
    variance 1/fan_in."""
    std = fan_in ** -0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def linear(fan_in: int, fan_out: int, bias: bool = True, generator=None) -> nn.Linear:
    """A Linear with flax's default init (LeCun normal, zero bias)."""
    layer = nn.Linear(fan_in, fan_out, bias=bias)
    with torch.no_grad():
        lecun_normal_(layer.weight, fan_in, generator)
        if bias:
            layer.bias.zero_()
    return layer


def embed_obs(embed_kernel, bias, dtype, obs) -> torch.Tensor:
    """dtype[..., E]: ``obs`` [..., 3*W*W] (cast to ``dtype``) against the
    kernel rounded to ``dtype``, accumulated in f32, plus ``bias`` in f32,
    then rounded to ``dtype`` once. Callers pass the bias rounded to
    ``dtype`` or not, as the JAX method they mirror does."""
    e = embed_kernel.shape[-1]
    kernel = embed_kernel.to(dtype).float().reshape(-1, e)
    x = obs.to(dtype).float()
    return (torch.matmul(x, kernel) + bias.float()).to(dtype)


def embed_state_windows_occ(embed_kernel, embed_bias, dtype, window,
                            grids, agents_xy, targets_xy, active) -> torch.Tensor:
    """The first layer from raw state, dtype[B, N, E], with the agents
    channel read from a per-env occupancy grid: the counterpart of the
    JAX function of that name, the same function as
    :meth:`EmbedActorCritic.embed_state_windows` (held to it by the
    tests). ``occ[b, x, y]`` counts the active agents on a cell (one
    ``scatter_add_``), and both window blocks are the same
    :func:`~pogema_torch.ops.windows.extract_windows` of a grid, as K1b
    reads its obstacle bytes and counts on the card; an active agent
    outside the P x P grid is seen by nobody, as there. Plain PyTorch on
    any device, on no step path. Rounding as the JAX function: the
    kernel and bias in ``dtype``, f32 accumulation, ``dtype`` once."""
    w = window
    b, p, _ = grids.shape
    x, y = agents_xy[..., 0].long(), agents_xy[..., 1].long()
    seen = active & (x >= 0) & (x < p) & (y >= 0) & (y < p)
    occ = torch.zeros(b, p * p, dtype=torch.float32, device=grids.device)
    occ.scatter_add_(1, (x * p + y).clamp(0, p * p - 1), seen.float())
    n = agents_xy.shape[1]
    obs = torch.cat([extract_windows(grids, agents_xy, w).reshape(b, n, w * w),
                     extract_windows(occ.reshape(b, p, p), agents_xy, w).reshape(b, n, w * w),
                     target_onehot(agents_xy, targets_xy, w).reshape(b, n, w * w)], dim=-1)
    return embed_obs(embed_kernel, embed_bias.to(dtype), dtype, obs)


class EmbedActorCritic(nn.Module):
    """Input (either form): the egocentric view of window W = 2r+1.
    Output: (logits f32[..., N, 5], value f32[..., N])."""

    def __init__(self, window: int = 11, embed: int = 256, hidden: int = 256,
                 dtype: torch.dtype = torch.bfloat16, generator=None):
        super().__init__()
        self.window, self.embed, self.hidden, self.dtype = window, embed, hidden, dtype
        fan_in = 3 * window * window
        self.embed_kernel = nn.Parameter(torch.empty(3, window * window, embed))
        self.embed_bias = nn.Parameter(torch.zeros(embed))
        with torch.no_grad():
            nn.init.normal_(self.embed_kernel, 0.0, fan_in ** -0.5, generator=generator)
        self.trunk = linear(embed, hidden, generator=generator)
        # Logits and value share one output GEMM: cols 0..4 are logits,
        # col 5 the value.
        self.head_out = linear(hidden, NUM_ACTIONS + 1, generator=generator)
        # Set by models.tensor_parallel.shard_module: the trunk then holds
        # this rank's slice of the hidden features.
        self.model_axis = None

    def _head(self, e):
        x = copy_to_model(F.relu(e), self.model_axis)
        x = F.relu(dense(x, self.trunk, self.dtype))
        o = dense(gather_from_model(x, self.model_axis), self.head_out, torch.float32)
        return o[..., :NUM_ACTIONS], o[..., NUM_ACTIONS]

    def embed_state_windows(self, grids, agents_xy, targets_xy, active) -> torch.Tensor:
        """dtype[B, N, E]: the first layer from raw state."""
        obs = packed_observation(self.window, grids, agents_xy, targets_xy, active)
        return embed_obs(self.embed_kernel, self.embed_bias.to(self.dtype), self.dtype, obs)

    def forward(self, obs):
        """obs: [..., 3, W, W] or packed [..., 3*W*W]."""
        k = 3 * self.window * self.window
        lead = obs.shape[:-3] if obs.shape[-1] != k else obs.shape[:-1]
        x = obs.reshape(*lead, k)
        return self._head(embed_obs(self.embed_kernel, self.embed_bias.to(self.dtype), self.dtype, x))

    def grid_embed(self, grids) -> torch.Tensor:
        """dtype[B, Sr, Sc, E]: the obstacle term of the first layer for
        every window centre of the logical map, ``(Sr, Sc) = (Pr - 2r,
        Pc - 2r)``: ``e_grid[b, x-r, y-r] = sum_ij grids[b, x-r+i, y-r+j]
        * k_obst[i, j]``, a VALID convolution of the padded grid u8[B, Pr,
        Pc] with the obstacle block of ``embed_kernel``. Operands rounded
        to ``dtype``, accumulated in f32, rounded to ``dtype`` once (the
        JAX method's ``dtype`` in, ``dtype`` out). Maps are static for a
        whole rollout, so this runs once per rollout and once per
        minibatch loss, where the obstacle kernel's gradient flows
        through it. ``grid_embed.calls`` counts the convolutions."""
        w, e = self.window, self.embed
        k = self.embed_kernel[0].to(self.dtype).float().t().reshape(e, 1, w, w)
        g = grids.to(self.dtype).float()[:, None]  # [B, 1, Pr, Pc]
        EmbedActorCritic.grid_embed.calls += 1
        return F.conv2d(g, k).permute(0, 2, 3, 1).to(self.dtype)

    def from_state_pre(self, e_grid, agents_xy, targets_xy, active):
        """Policy from a precomputed :meth:`grid_embed`: the same function
        as :meth:`from_state` up to f32 summation order.

        e_grid dtype[B, Sr, Sc, E]; agents_xy/targets_xy i32[..., B, N, 2]
        padded coordinates, optionally with leading time axes (the env
        axis must align with e_grid's); active bool[..., B, N]. Returns
        (logits f32[..., B, N, 5], value f32[..., B, N]).

        The JAX method selects with one-hot matmuls; here the obstacle
        term is a row gather ``e_grid[b, cell]`` (zero where the cell
        index falls outside ``[0, Sr*Sc)``, as a one-hot with no match
        gives), and the agent and target terms are the rows of the
        stacked ``[2*w*w, E]`` kernel table (agents block, then target
        block) summed per agent, taken as one GEMM of the per-agent row
        counts (``ops.windows.pairwise_agent_windows`` and
        ``target_onehot``) against the table. The counts apply the
        in-window mask before the flat index can alias (``dx`` in range
        with ``dy`` out of range), leave inactive neighbours invisible,
        include the agent itself and clip the target to the border.
        Rounding: ``e_grid`` and the table in ``dtype``; the three terms
        and the unrounded f32 bias summed in f32; one rounding to
        ``dtype``."""
        w, emb = self.window, self.embed
        r = w // 2
        b, sr, sc = e_grid.shape[0], e_grid.shape[-3], e_grid.shape[-2]
        rows = e_grid.to(self.dtype).reshape(b * sr * sc, emb)
        lead = agents_xy.shape[:-2]
        n = agents_xy.shape[-2]
        cell = (agents_xy[..., 0].long() - r) * sc + (agents_xy[..., 1].long() - r)
        inside = (cell >= 0) & (cell < sr * sc)
        env = torch.arange(b, device=cell.device).reshape(b, 1) * (sr * sc)
        e_obst = rows[(cell.clamp(0, sr * sc - 1) + env).reshape(-1)].float()
        e_obst = e_obst.reshape(*lead, n, emb) * inside[..., None]

        axy = agents_xy.reshape(-1, n, 2)
        counts = torch.cat([
            pairwise_agent_windows(axy, active.reshape(-1, n), w).reshape(-1, n, w * w),
            target_onehot(axy, targets_xy.reshape(-1, n, 2), w).reshape(-1, n, w * w)], dim=-1)
        table = self.embed_kernel[1:].to(self.dtype).float().reshape(2 * w * w, emb)
        e_rest = torch.matmul(counts, table).reshape(*lead, n, emb)

        e = (e_obst + e_rest + self.embed_bias.float()).to(self.dtype)
        return self._head(e)

    def from_state(self, grids, agents_xy, targets_xy, active):
        """grids u8[B, P, P] padded obstacle grids; agents_xy/targets_xy
        i32[B, N, 2] padded coordinates; active bool[B, N]. Returns
        (logits f32[B, N, 5], value f32[B, N])."""
        return self._head(self.embed_state_windows(grids, agents_xy, targets_xy, active))


EmbedActorCritic.grid_embed.calls = 0


def init_embed_params(generator: torch.Generator, window: int, embed: int = 256,
                      hidden: int = 256, dtype: torch.dtype = torch.bfloat16):
    """(model, state_dict) of a freshly initialised EmbedActorCritic:
    embed_kernel ~ N(0, (3W²)^-½), zero biases, LeCun-normal Dense
    kernels, all drawn from ``generator``."""
    model = EmbedActorCritic(window, embed, hidden, dtype, generator=generator)
    return model, model.state_dict()
