"""Trajectory collection on one device with the policy in the loop.

Counterpart of ``pogema_tpu/parallel/rollout.py``. The JAX package runs a
rollout as one ``lax.scan``; here it is a Python loop of batched tensor
ops under ``torch.no_grad()``, writing each step into ``[T, B, ...]``
tensors allocated on the core's device before the loop. ``unroll`` (a
``lax.scan`` option) has no meaning here and the argument is dropped.

The policy callables take no parameter tree: a ``torch.nn.Module`` holds
its own parameters, so ``apply_state(grids, agents_xy, targets_xy,
active)`` stands where JAX has ``apply_state(params, grids, ...)``, and
the rollouts lose their leading ``params`` argument likewise.

Every rollout splits its key once per step (``key, k_act = split(key)``),
draws the actions with ``core.random.categorical`` (bit-equal to
``jax.random.categorical`` for equal logits) and advances the env with
``core.step_autoreset``. A rank that holds the envs ``[env_offset,
env_offset + B)`` of a global batch (``parallel.mesh``) draws exactly its
rows of the global draw.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import random as jr


def log_prob_of(logits, actions) -> torch.Tensor:
    """log pi(a|s) per agent. The JAX function sums a one-hot product
    because gathers serialize on the TPU; a gather is the direct form."""
    return torch.log_softmax(logits, dim=-1).gather(-1, actions.long()[..., None])[..., 0]


@dataclasses.dataclass
class Transition:
    obs: torch.Tensor  # [T, B, N, 3, W, W] (or the packed layout)
    actions: torch.Tensor  # i32[T, B, N]
    log_probs: torch.Tensor  # f32[T, B, N]
    values: torch.Tensor  # f32[T, B, N]
    rewards: torch.Tensor  # f32[T, B, N]
    dones: torch.Tensor  # bool[T, B, N] (per-agent terminated | truncated)
    env_dones: torch.Tensor  # bool[T, B]
    metrics: dict  # f32[T, B] each, valid where env_dones


@dataclasses.dataclass
class StateTransition:
    """Observation-free trajectory: the state the policy's first layer
    reads, from which the update recomputes its input."""

    agents_xy: torch.Tensor  # i32[T, B, N, 2] (pre-step positions)
    targets_xy: torch.Tensor  # i32[T, B, N, 2]
    active: torch.Tensor  # bool[T, B, N]
    actions: torch.Tensor  # i32[T, B, N]
    log_probs: torch.Tensor  # f32[T, B, N]
    values: torch.Tensor  # f32[T, B, N]
    rewards: torch.Tensor  # f32[T, B, N]
    dones: torch.Tensor  # bool[T, B, N]
    env_dones: torch.Tensor  # bool[T, B]
    metrics: dict  # f32[T, B] each, valid where env_dones


class _Recorder:
    """[T, ...] buffers on the device, allocated at the first step from
    the shapes and dtypes of that step's values."""

    def __init__(self, num_steps: int):
        self.num_steps = num_steps
        self.buffers = None

    def _alloc(self, v):
        if isinstance(v, dict):
            return {k: self._alloc(x) for k, x in v.items()}
        return torch.empty((self.num_steps,) + tuple(v.shape), dtype=v.dtype, device=v.device)

    def write(self, t: int, **values):
        if self.buffers is None:
            self.buffers = {k: self._alloc(v) for k, v in values.items()}
        for k, v in values.items():
            if isinstance(v, dict):
                for name, x in v.items():
                    self.buffers[k][name][t] = x
            else:
                self.buffers[k][t] = v


def _sample(k_act, logits, env_offset: int):
    per_env = math.prod(logits.shape[1:])
    actions = jr.categorical(k_act, logits, offset=env_offset * per_env).to(torch.int32)
    return actions, log_prob_of(logits, actions)


def make_state_rollout_fn(core, apply_state, num_steps: int, make_ctx=None, env_offset: int = 0):
    """Observation-free rollout: the policy reads the state through
    ``apply_state(grids, agents_xy, targets_xy, active) -> (logits,
    values)`` and the env step skips observation assembly. Returns
    ``rollout(env_state, initial_state, key) -> (env_state, key,
    StateTransition)``.

    With ``make_ctx`` (the grid embedding, ``EmbedActorCritic.grid_embed``)
    a per-rollout context is built once from the initial grids and given
    to ``apply_state`` in place of the grids at every step; sound because
    maps are static for a whole rollout
    (``parallel.learner._check_static_maps``)."""

    @torch.no_grad()
    def rollout(env_state, initial_state, key):
        ctx = None if make_ctx is None else make_ctx(env_state.obstacles)
        rec = _Recorder(num_steps)
        s = env_state
        for t in range(num_steps):
            key, k_act = jr.split(key)
            grid_in = s.obstacles if make_ctx is None else ctx
            logits, values = apply_state(grid_in, s.agents_xy, s.targets_xy, s.active)
            actions, log_probs = _sample(k_act, logits, env_offset)
            new_state, _, res, env_done, metrics = core.step_autoreset(
                s, initial_state, actions, with_obs=False)
            rec.write(t, agents_xy=s.agents_xy, targets_xy=s.targets_xy, active=s.active,
                      actions=actions, log_probs=log_probs, values=values,
                      rewards=res.rewards, dones=res.terminated | res.truncated,
                      env_dones=env_done, metrics=metrics)
            s = new_state
        return s, key, StateTransition(**rec.buffers)

    return rollout


def make_recurrent_rollout_fn(core, apply_cell, num_steps: int, env_offset: int = 0):
    """Observation-free rollout of the recurrent family:
    ``apply_cell(grids, agents_xy, targets_xy, active, h) -> (new_h,
    logits, values)``; the hidden state dtype[B, N, H] is zeroed where an
    agent's episode ended, and the dones are stored so that the update
    replays the same hidden-state evolution. Returns ``rollout(env_state,
    initial_state, h, key) -> (env_state, h, key, StateTransition)``."""

    @torch.no_grad()
    def rollout(env_state, initial_state, h, key):
        rec = _Recorder(num_steps)
        s = env_state
        for t in range(num_steps):
            key, k_act = jr.split(key)
            new_h, logits, values = apply_cell(s.obstacles, s.agents_xy, s.targets_xy,
                                               s.active, h)
            actions, log_probs = _sample(k_act, logits, env_offset)
            new_state, _, res, env_done, metrics = core.step_autoreset(
                s, initial_state, actions, with_obs=False)
            dones = res.terminated | res.truncated
            h = torch.where(dones[..., None], torch.zeros((), dtype=new_h.dtype, device=new_h.device),
                            new_h)
            rec.write(t, agents_xy=s.agents_xy, targets_xy=s.targets_xy, active=s.active,
                      actions=actions, log_probs=log_probs, values=values,
                      rewards=res.rewards, dones=dones, env_dones=env_done, metrics=metrics)
            s = new_state
        return s, h, key, StateTransition(**rec.buffers)

    return rollout


def make_rollout_fn(core, apply_fn, num_steps: int, env_offset: int = 0):
    """Observation-based rollout: ``apply_fn(obs) -> (logits, values)``.
    Returns ``rollout(env_state, initial_state, obs, key) -> (env_state,
    obs, key, Transition)``; ``initial_state`` feeds the cached
    auto-reset (see ``core.api``)."""

    @torch.no_grad()
    def rollout(env_state, initial_state, obs, key):
        rec = _Recorder(num_steps)
        s = env_state
        for t in range(num_steps):
            key, k_act = jr.split(key)
            logits, values = apply_fn(obs)
            actions, log_probs = _sample(k_act, logits, env_offset)
            new_state, new_obs, res, env_done, metrics = core.step_autoreset(
                s, initial_state, actions)
            rec.write(t, obs=obs, actions=actions, log_probs=log_probs, values=values,
                      rewards=res.rewards, dones=res.terminated | res.truncated,
                      env_dones=env_done, metrics=metrics)
            s, obs = new_state, new_obs
        return s, obs, key, Transition(**rec.buffers)

    return rollout
