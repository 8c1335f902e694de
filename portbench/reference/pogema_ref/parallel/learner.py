"""PPO for the recurrent (GRU) policy on one device, as
``pogema_tpu/parallel/learner.py`` (``make_recurrent_train_step``)
defines it: a rollout of T steps -> bootstrap values and GAE -> E epochs
x M minibatches of clipped-surrogate updates. The JAX package jits the
whole step into one XLA program of nested ``lax.scan``s; here the same
sequence runs as Python loops of batched tensor ops, autograd gives the
gradients, and ``parallel.optim`` is the optimizer.

A train state carries the parameters as a plain ``{name: tensor}`` dict
(the module's ``named_parameters``); ``train_step(ts)`` writes them into
the module and returns a new state.

Minibatches slice the ENV axis (sequences stay whole), composed by
:func:`_epoch_mix` as the JAX package composes them (same keys, same
partition, same row order); each loss replays the whole sequence from
the stored pre-rollout hidden state and the stored per-step dones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core import random as jr
from .optim import Optimizer
from .rollout import make_recurrent_rollout_fn


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    rollout_steps: int = 128
    epochs: int = 2
    minibatches: int = 4


@dataclasses.dataclass
class RecurrentTrainState:
    params: dict
    opt_state: dict
    env_state: Any
    initial_env_state: Any
    h: torch.Tensor  # GRU hidden dtype[B, N, H], carried across rollouts
    key: torch.Tensor

    def replace(self, **kw) -> "RecurrentTrainState":
        return dataclasses.replace(self, **kw)


def params_of(model) -> dict:
    """A detached copy of the module's parameters, ``{name: tensor}``."""
    return {k: v.detach().clone() for k, v in model.named_parameters()}


@torch.no_grad()
def load_params(model, params: dict) -> None:
    for k, p in model.named_parameters():
        p.copy_(params[k])


def init_recurrent_train_state(core, model, params, config: PPOConfig, key) -> tuple:
    """(RecurrentTrainState, Optimizer). ``params``: a ``{name: tensor}``
    dict, or None for the module's own; ``key``: int64[2] key words."""
    tx = Optimizer(lr=config.lr, max_norm=config.max_grad_norm)
    model.to(core.device)
    if params is None:
        params = params_of(model)
    else:
        params = {k: torch.as_tensor(v).detach().to(core.device, torch.float32).clone()
                  for k, v in params.items()}
    key = torch.as_tensor(key, device=core.device).to(torch.int64)
    key, k_reset = jr.split(key)
    env_state, _ = core.reset(k_reset, with_obs=False)
    h = model.initial_carry(tuple(env_state.active.shape), device=core.device)
    ts = RecurrentTrainState(params=params, opt_state=tx.init(params), env_state=env_state,
                             initial_env_state=env_state, h=h, key=key)
    return ts, tx


def _epoch_mix(key, n: int, minibatches: int) -> Callable:
    """The minibatch partition of one epoch: ``mix(x)`` maps [n, ...] to
    [n // M, M, ...] with the minibatch on axis 1: a roll by ``shift``
    (drawn in [0, n)) composed with a block interleave of granularity
    ``g`` (drawn from the powers of two up to 128 that divide n // M):
    rolled row r goes into minibatch (r // g) % M."""
    mb = n // minibatches
    gs = [g for g in (1, 2, 4, 8, 16, 32, 64, 128) if mb % g == 0]
    k_shift, k_g = jr.split(key)
    shift = int(jr.randint(k_shift, (), 0, n))
    g = gs[int(jr.randint(k_g, (), 0, len(gs)))]

    def mix(x):
        x = torch.roll(x, shift, dims=0)
        x = x.reshape((n // (minibatches * g), minibatches, g) + x.shape[1:])
        return x.transpose(1, 2).reshape((mb, minibatches) + x.shape[3:])

    return mix


def compute_gae(traj, last_values, gamma, lam):
    """Per-agent GAE over the time axis, reset at per-agent dones.
    Returns (advantages, targets), f32[T, B, N]."""
    advantages = torch.empty_like(traj.values)
    gae = torch.zeros_like(last_values)
    next_value = last_values
    not_dones = 1.0 - traj.dones.to(torch.float32)
    for t in range(traj.values.shape[0] - 1, -1, -1):
        delta = traj.rewards[t] + gamma * next_value * not_dones[t] - traj.values[t]
        gae = delta + gamma * lam * not_dones[t] * gae
        advantages[t] = gae
        next_value = traj.values[t]
    return advantages, advantages + traj.values


def _ppo_total(config: PPOConfig, pg_loss, v_loss, entropy):
    total = pg_loss + config.vf_coef * v_loss - config.entropy_coef * entropy
    return total, (pg_loss, v_loss, entropy)


def _ppo_loss_terms(config: PPOConfig, logits, values, actions, old_log_probs, advantages,
                    targets):
    """Clipped-surrogate PPO loss: (total, (pg_loss, v_loss, entropy)),
    the advantages normalized by their mean and population std."""
    adv = (advantages - advantages.mean()) / (advantages.std(unbiased=False) + 1e-8)
    log_probs_all = torch.log_softmax(logits, dim=-1)
    log_probs = log_probs_all.gather(-1, actions.long()[..., None])[..., 0]
    ratio = torch.exp(log_probs - old_log_probs)
    pg = torch.minimum(ratio * adv,
                       torch.clamp(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps) * adv)
    entropy = -(torch.softmax(logits, dim=-1) * log_probs_all).sum(dim=-1)
    return _ppo_total(config, -pg.mean(), 0.5 * ((values - targets) ** 2).mean(), entropy.mean())


def _train_stats(stats, traj) -> dict:
    """stats: f32[E, M, 4] (loss, pg, v, entropy per minibatch)."""
    loss, pg, vl, ent = stats.mean(dim=(0, 1))
    out = {"loss": loss, "pg_loss": pg, "v_loss": vl, "entropy": ent,
           "reward_per_step": traj.rewards.mean()}
    # Episode metrics averaged over the episodes that ended in the rollout.
    done_f = traj.env_dones.to(torch.float32)
    denom = done_f.sum().clamp(min=1.0)
    for k, v in traj.metrics.items():
        out[f"episode_{k}"] = (v * done_f).sum() / denom
    out["episodes_finished"] = done_f.sum()
    return out


def make_recurrent_train_step(core, model, config: PPOConfig, tx: Optimizer, grad_hook=None):
    """``train_step(ts) -> (ts, stats)``. ``grad_hook(epoch, i, loss,
    grads)`` sees each minibatch's gradient as the optimizer gets it."""
    if core.num_envs % config.minibatches:
        raise ValueError("num_envs must be divisible by minibatches")
    rollout = make_recurrent_rollout_fn(core, model.step_from_state, config.rollout_steps)

    def loss_fn(batch):
        # Minibatch fields are [mb, T, ...]; the replay walks time, so T
        # goes in front. The copies are contiguous: a mean over a strided
        # view sums in another order, and the loss's reductions then round
        # otherwise.
        grids, h = batch[0].contiguous(), batch[1]
        (axy, txy, active, actions, old_log_probs, advantages, targets,
         dones) = (x.transpose(0, 1).contiguous() for x in batch[2:])
        logits, values = [], []
        for t in range(axy.shape[0]):
            new_h, lg, v = model.step_from_state(grids, axy[t], txy[t], active[t], h)
            h = torch.where(dones[t][..., None], torch.zeros_like(new_h), new_h)
            logits.append(lg)
            values.append(v)
        return _ppo_loss_terms(config, torch.stack(logits), torch.stack(values), actions,
                               old_log_probs, advantages, targets)

    def train_step(ts: RecurrentTrainState):
        load_params(model, ts.params)
        h0 = ts.h
        env_state, h_last, key, traj = rollout(ts.env_state, ts.initial_env_state, ts.h, ts.key)
        with torch.no_grad():
            _, _, last_values = model.step_from_state(
                env_state.obstacles, env_state.agents_xy, env_state.targets_xy,
                env_state.active, h_last)
            advantages, targets = compute_gae(traj, last_values, config.gamma,
                                              config.gae_lambda)
        # Env-major dataset [B, T, ...]; the grids hold for the whole
        # rollout ('regen' with 'restart' episodes that end on rollout
        # boundaries, or 'cached').
        dataset = [ts.env_state.obstacles, h0] + [x.transpose(0, 1) for x in (
            traj.agents_xy, traj.targets_xy, traj.active, traj.actions, traj.log_probs,
            advantages, targets, traj.dones)]
        named = dict(model.named_parameters())
        opt_state, stats = ts.opt_state, []
        for epoch in range(config.epochs):
            key, k_mix = jr.split(key)
            mix = _epoch_mix(k_mix, core.num_envs, config.minibatches)
            shuffled = [mix(x) for x in dataset]
            for i in range(config.minibatches):
                loss, aux = loss_fn([x[:, i] for x in shuffled])
                grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
                grads = {k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(named.items(), grads)}
                if grad_hook is not None:
                    grad_hook(epoch, i, loss.detach(), grads)
                updates, opt_state = tx.update(grads, opt_state)
                with torch.no_grad():
                    for k, p in named.items():
                        p.add_(updates[k])
                stats.append(torch.stack([loss.detach(), *(a.detach() for a in aux)]))
        stats = torch.stack(stats).reshape(config.epochs, config.minibatches, 4)
        new_ts = ts.replace(params=params_of(model), opt_state=opt_state, env_state=env_state,
                            h=h_last, key=key)
        return new_ts, _train_stats(stats, traj)

    return train_step
