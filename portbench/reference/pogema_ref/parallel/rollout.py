"""Trajectory collection with the recurrent policy in the loop, as
``pogema_tpu/parallel/rollout.py`` defines it (there one ``lax.scan``,
here a Python loop of batched tensor ops under ``torch.no_grad()``).

Every step splits its key once (``key, k_act = split(key)``), draws the
actions with ``core.random.categorical`` (``jax.random.categorical``'s
draw) and advances the env with ``core.step_autoreset``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import random as jr


def log_prob_of(logits, actions) -> torch.Tensor:
    """log pi(a|s) per agent. The JAX function sums a one-hot product
    because gathers serialize on the TPU; a gather is the direct form."""
    return torch.log_softmax(logits, dim=-1).gather(-1, actions.long()[..., None])[..., 0]


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


def _sample(k_act, logits):
    actions = jr.categorical(k_act, logits).to(torch.int32)
    return actions, log_prob_of(logits, actions)


def make_recurrent_rollout_fn(core, apply_cell, num_steps: int):
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
            actions, log_probs = _sample(k_act, logits)
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
