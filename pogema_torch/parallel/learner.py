"""PPO learner over the batched env on one device.

Counterpart of ``pogema_tpu/parallel/learner.py``. One ``train_step`` =
rollout of T steps -> bootstrap values and GAE -> E epochs x M
minibatches of clipped-surrogate updates. The JAX package jits the whole
step into one XLA program of nested ``lax.scan``s; here the same
sequence runs as Python loops of batched tensor ops, autograd gives the
gradients, and ``parallel.optim`` is the optimizer.

Parameters. A ``torch.nn.Module`` holds its own parameters, so the apply
functions take no parameter tree. A train state carries the parameters
as a plain ``{name: tensor}`` dict (the model's ``named_parameters``);
``train_step(ts)`` writes them into the module, works on the module's
tensors, and returns a new state whose tensors alias neither the old
state's nor the module's. After a step the module holds the new
parameters.

Minibatches are composed by :func:`_epoch_mix` exactly as the JAX
package composes them (same keys, same partition, same row order), so a
whole train step follows the JAX one to f32 noise.

Four flavours, as there:

* :func:`make_train_step`: observations stored in the trajectory, rows
  are single agents;
* :func:`make_fused_train_step` ``'windows'``: compact state stored, the
  loss rebuilds the policy input with ``from_state`` (one launch of the
  observation kernel per minibatch loss), rows are env-steps and each row
  gathers its env's grid;
* ``'pre'``: the obstacle term comes from ``grid_embed`` (one VALID conv
  per loss), minibatches slice the time axis, the observation kernel is not
  used;
* :func:`make_recurrent_train_step`: minibatches slice the env axis and
  each loss replays the whole sequence from the stored hidden state (one
  launch of the observation kernel per replayed step).

Over a mesh (``parallel.mesh``; every ``init_*`` and ``make_*`` takes
``mesh``, and ``None`` runs the code above unchanged) each rank holds the
envs of its data coordinate, and the update computes what the JAX
package's global program computes, not a per-rank average:

* the epoch's partition is drawn over the GLOBAL rows with the same
  keys, and each rank takes, in global row order, the rows of each
  minibatch that it holds (a share that may differ from minibatch to
  minibatch, or be empty; an empty rank still joins every collective);
* the advantages are normalized by the global mean and population
  standard deviation, and each loss mean is the local sum over the
  global count, so the sum of the ranks' gradients (an all-reduce over
  'data') is the gradient of the global loss;
* the clipping norm sums the squares of the 'model'-sharded leaves over
  'model' and counts the replicated ones once (``optim.global_norm``);
* the statistics are global sums over global counts.

Every rank draws the same keys; the rollout's actions are the rank's
rows of the global draw (``core.random``'s ``offset``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core import random as jr
from .mesh import all_reduce_sum, axis_size, data_rows, shard_batch
from .optim import Optimizer, global_norm
from .rollout import (
    make_recurrent_rollout_fn,
    make_rollout_fn,
    make_state_rollout_fn,
)


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
    # Fused-path obstacle-term strategy: 'pre' precomputes the grid
    # embedding as a VALID conv and reads rows of it (needs
    # rollout_steps % minibatches == 0), 'windows' extracts per-agent
    # windows (no constraints), 'auto' picks by the rule in
    # make_fused_train_step.
    obstacle_path: str = "auto"
    # 'pre' minibatch loss: evaluate the policy one TIME step at a time
    # under activation checkpointing instead of all T_mb steps at once.
    scan_minibatch_time: Optional[bool] = False

    def replace(self, **kw) -> "PPOConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    env_state: Any
    initial_env_state: Any
    obs: Any
    key: torch.Tensor

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


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


# -- parameters in and out of the module -----------------------------------


def params_of(model) -> dict:
    """A detached copy of the module's parameters, ``{name: tensor}``."""
    return {k: v.detach().clone() for k, v in model.named_parameters()}


@torch.no_grad()
def load_params(model, params: dict) -> None:
    """Write ``params`` into the module's own tensors (strict names)."""
    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"parameter names differ: {sorted(set(own) ^ set(params))}")
    for k, p in own.items():
        if p.shape != params[k].shape:
            raise ValueError(f"parameter {k}: {tuple(params[k].shape)} for a module that holds "
                             f"{tuple(p.shape)} (over a mesh with a 'model' axis, pass this "
                             "rank's shards: models.partition_params)")
        p.copy_(params[k])


def _place(core, model, mesh) -> None:
    """Move the module to the core's device and, over a mesh, make it
    tensor-parallel (``models.tensor_parallel.shard_module``)."""
    model.to(core.device)
    if mesh is not None:
        from ..models.tensor_parallel import shard_module

        shard_module(model, mesh)


def _own_params(core, model, params, mesh=None) -> dict:
    _place(core, model, mesh)
    if params is None:
        return params_of(model)
    return {k: torch.as_tensor(v).detach().to(core.device, torch.float32).clone()
            for k, v in params.items()}


def _optimizer(config: PPOConfig) -> Optimizer:
    return Optimizer(lr=config.lr, max_norm=config.max_grad_norm)


def _reset(core, key, with_obs: bool, mesh):
    """(key, env_state, obs) of a new train state. Over a mesh each rank
    resets the GLOBAL batch (deterministic, so every rank draws the same)
    and keeps its rows."""
    key = torch.as_tensor(key, device=core.device).to(torch.int64)
    key, k_reset = jr.split(key)
    env_state, obs = core.reset(k_reset, with_obs=with_obs)
    if mesh is not None:
        env_state, obs = shard_batch((env_state, obs), mesh)
    return key, env_state, obs


def _init_state(core, model, params, config: PPOConfig, key, with_obs: bool, mesh):
    """Shared by both feedforward flavours so that their optimizers
    cannot drift apart."""
    tx = _optimizer(config)
    params = _own_params(core, model, params, mesh)
    key, env_state, obs = _reset(core, key, with_obs, mesh)
    ts = TrainState(params=params, opt_state=tx.init(params), env_state=env_state,
                    initial_env_state=env_state, obs=obs, key=key)
    return ts, tx


def init_train_state(core, model, params, config: PPOConfig, key, mesh=None) -> tuple:
    """(TrainState, Optimizer) of the observation-based path. ``params``:
    a ``{name: tensor}`` dict, or None for the module's current ones;
    ``key``: int64[2] key words (``core.make_key(seed)``). The module is
    moved to the core's device.

    With ``mesh`` (``parallel.make_mesh``) the core describes the GLOBAL
    batch, the state holds this rank's envs, the module is made
    tensor-parallel over the mesh's 'model' axis, and ``params`` are
    this rank's shards (``models.partition_params``) or None."""
    return _init_state(core, model, params, config, key, True, mesh)


def init_fused_train_state(core, model, params, config: PPOConfig, key, mesh=None) -> tuple:
    """As :func:`init_train_state` for the fused paths: no observation
    tensor is ever held."""
    return _init_state(core, model, params, config, key, False, mesh)


def init_recurrent_train_state(core, model, params, config: PPOConfig, key, mesh=None) -> tuple:
    """(RecurrentTrainState, Optimizer) of the GRU family; ``mesh`` as in
    :func:`init_train_state` (the hidden state is then this rank's envs
    and, with tensor parallelism, its slice of the hidden features)."""
    tx = _optimizer(config)
    params = _own_params(core, model, params, mesh)
    key, env_state, _ = _reset(core, key, False, mesh)
    h = model.initial_carry(tuple(env_state.active.shape), device=core.device)
    ts = RecurrentTrainState(params=params, opt_state=tx.init(params), env_state=env_state,
                             initial_env_state=env_state, h=h, key=key)
    return ts, tx


# -- minibatch composition -----------------------------------------------


def _epoch_mix(key, n: int, minibatches: int) -> Callable:
    """The minibatch partition of one epoch: ``mix(x)`` maps [n, ...] to
    [n // M, M, ...] with the minibatch on axis 1.

    The same function of the same key as the JAX package's
    ``_epoch_mix``: a roll by ``shift`` (drawn in [0, n)) composed with a
    block interleave of granularity ``g`` (drawn from the powers of two
    up to 128 that divide n // M): reshape (n/(M*g), M, g), swap,
    flatten, which puts rolled row r into minibatch (r // g) % M. The
    JAX package chose this form to avoid a row gather on the TPU; the
    port keeps it because the parity of a whole train step depends on
    the two packages composing the same minibatches in the same row
    order. One host read per epoch fetches the two draws."""
    mb = n // minibatches
    gs = [g for g in (1, 2, 4, 8, 16, 32, 64, 128) if mb % g == 0]
    k_shift, k_g = jr.split(key)
    shift, g_idx = torch.stack([jr.randint(k_shift, (), 0, n),
                                jr.randint(k_g, (), 0, len(gs))]).tolist()
    g = gs[g_idx]

    def mix(x):
        x = torch.roll(x, shift, dims=0)
        x = x.reshape((n // (minibatches * g), minibatches, g) + x.shape[1:])
        return x.transpose(1, 2).reshape((mb, minibatches) + x.shape[3:])

    return mix


class _DataAxis:
    """The mesh as the update sees it: this rank's envs ``[lo, hi)`` of
    the global batch of ``num_envs``, sums over the 'data' ranks, and the
    'model' group of the clipping norm (None without tensor
    parallelism)."""

    def __init__(self, mesh, num_envs: int):
        self.group = mesh.get_group("data")
        self.size = axis_size(mesh, "data")
        self.num_envs = num_envs
        self.lo, self.hi = data_rows(mesh, num_envs)
        self.model_group = mesh.get_group("model") if axis_size(mesh, "model") > 1 else None

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(x, self.group)

    def minibatch_rows(self, key, n: int, minibatches: int, inner) -> list:
        """This rank's rows of each minibatch of the epoch that ``key``
        mixes, as indices into its local dataset, in global row order.
        Global row ``r`` of ``n`` is ``(o, b, i)`` of the axes (outer,
        num_envs, ``inner``); the rank holds it when ``lo <= b < hi``, at
        local row ``(o, b - lo, i)``. ``inner=None``: the mixed axis holds
        no env (every rank holds every row)."""
        perm = _epoch_mix(key, n, minibatches)(torch.arange(n, device=key.device))
        out = []
        for i in range(minibatches):
            rows = perm[:, i]
            if inner is not None:
                b, span = self.num_envs, self.num_envs * inner
                env = (rows // inner) % b
                rows = rows[(env >= self.lo) & (env < self.hi)]
                rows = (rows // span) * ((self.hi - self.lo) * inner) + rows % span - self.lo * inner
            out.append(rows)
        return out

    def normalize(self, advantages):
        """((a - mean) / (std + 1e-8) over the global minibatch, the
        global element count), with the population standard deviation."""
        f64 = torch.float64
        s = self.sum(torch.stack([advantages.sum().to(f64),
                                  torch.tensor(advantages.numel(), dtype=f64,
                                               device=advantages.device)]))
        count = s[1]
        mean = (s[0] / count).float()
        dev2 = self.sum(((advantages - mean) ** 2).sum().to(f64))
        std = torch.sqrt(dev2 / count).float()
        return (advantages - mean) / (std + 1e-8), count.float()

    def sum_grads(self, grads: dict) -> dict:
        """The gradients summed over 'data' (one all-reduce of all of them)."""
        flat = self.sum(torch.cat([g.reshape(-1) for g in grads.values()]))
        out, at = {}, 0
        for k, g in grads.items():
            out[k] = flat[at:at + g.numel()].view_as(g)
            at += g.numel()
        return out

    def norm(self, grads: dict):
        """The clipping norm of the whole gradient; None (the optimizer's
        own) without tensor parallelism."""
        if self.model_group is None:
            return None
        from ..models.tensor_parallel import is_sharded

        return global_norm(grads, {k for k in grads if is_sharded(k)}, self.model_group)


def _data_axis(core, model, mesh):
    """The data axis of a train step (None without a mesh), after
    :func:`_place`."""
    _place(core, model, mesh)
    return None if mesh is None else _DataAxis(mesh, core.num_envs)


def _offset(axis) -> int:
    """The rank's first env in the global batch."""
    return 0 if axis is None else axis.lo


def _global_rows(n: int, axis) -> int:
    """The global row count of a dataset whose mixed axis splits over
    'data' evenly (``n`` rows here)."""
    return n if axis is None else n * axis.size


def _check_minibatch_divisibility(n, minibatches, what):
    if n % minibatches:
        raise ValueError(
            f"{what} ({n}) must be divisible by minibatches "
            f"({minibatches}); adjust rollout_steps/num_envs/minibatches"
        )


def compute_gae(traj, last_values, gamma, lam):
    """Per-agent GAE over the time axis, reset at per-agent dones: a
    reverse loop over T. Returns (advantages, targets), f32[T, B, N]."""
    advantages = torch.empty_like(traj.values)
    gae = torch.zeros_like(last_values)
    next_value = last_values
    not_dones = 1.0 - traj.dones.to(torch.float32)
    for t in range(traj.values.shape[0] - 1, -1, -1):
        not_done = not_dones[t]
        delta = traj.rewards[t] + gamma * next_value * not_done - traj.values[t]
        gae = delta + gamma * lam * not_done * gae
        advantages[t] = gae
        next_value = traj.values[t]
    return advantages, advantages + traj.values


def _check_static_maps(core, config: PPOConfig):
    """The fused updates recompute embeddings from per-ENV grids captured
    once per rollout, which is sound only when no env's map can change
    mid-rollout: 'cached' auto-reset never regenerates maps, and 'regen'
    is safe exactly when episodes end only at the time limit ('restart')
    on rollout boundaries (rollout_steps divides max_episode_steps; all
    envs step in lockstep from step_count 0)."""
    if core.auto_reset_mode == "cached":
        return
    gc = core.grid_config
    if gc.on_target == "restart" and gc.max_episode_steps % config.rollout_steps == 0:
        return
    raise ValueError(
        "fused train step needs static per-rollout maps: use "
        "auto_reset_mode='cached', or 'regen' with on_target='restart' "
        "and rollout_steps dividing max_episode_steps "
        f"(got mode={core.auto_reset_mode!r}, on_target={gc.on_target!r}, "
        f"max_episode_steps={gc.max_episode_steps}, "
        f"rollout_steps={config.rollout_steps}); the obs-based "
        "make_train_step has no such restriction"
    )


# -- the loss ---------------------------------------------------------------


def _ppo_element_terms(config: PPOConfig, logits, values, actions, old_log_probs,
                       adv_normalized, targets):
    """Per-element clipped-surrogate terms (no reductions), shared by the
    one-shot loss and the time-scanned loss. Returns (min(pg1, pg2),
    squared value error, entropy) elementwise."""
    log_probs_all = torch.log_softmax(logits, dim=-1)
    log_probs = log_probs_all.gather(-1, actions.long()[..., None])[..., 0]
    ratio = torch.exp(log_probs - old_log_probs)
    pg1 = ratio * adv_normalized
    pg2 = torch.clamp(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps) * adv_normalized
    pg_el = torch.minimum(pg1, pg2)
    v_el = (values - targets) ** 2
    ent_el = -(torch.softmax(logits, dim=-1) * log_probs_all).sum(dim=-1)
    return pg_el, v_el, ent_el


def _normalize_adv(advantages):
    """(a - mean) / (std + 1e-8) with the population standard deviation,
    as ``jnp.std`` (``torch.std`` defaults to the sample one). Over a
    mesh: ``_DataAxis.normalize``."""
    return (advantages - advantages.mean()) / (advantages.std(unbiased=False) + 1e-8)


def _ppo_total(config: PPOConfig, pg_loss, v_loss, entropy):
    total = pg_loss + config.vf_coef * v_loss - config.entropy_coef * entropy
    return total, (pg_loss, v_loss, entropy)


def _ppo_loss_terms(config: PPOConfig, logits, values, actions, old_log_probs, advantages,
                    targets, axis=None):
    """Clipped-surrogate PPO loss from policy outputs: (total, (pg_loss,
    v_loss, entropy)). Shared by every flavour. Over a mesh (``axis``)
    each term is this rank's sum over the global count: the ranks' losses
    add up to the global one."""
    if axis is None:
        adv = _normalize_adv(advantages)
    else:
        adv, count = axis.normalize(advantages)
    pg_el, v_el, ent_el = _ppo_element_terms(config, logits, values, actions, old_log_probs,
                                             adv, targets)
    if axis is None:
        return _ppo_total(config, -pg_el.mean(), 0.5 * v_el.mean(), ent_el.mean())
    return _ppo_total(config, -pg_el.sum() / count, 0.5 * v_el.sum() / count,
                      ent_el.sum() / count)


def _train_stats(stats, traj, axis=None) -> dict:
    """stats: f32[E, M, 4] (loss, pg, v, entropy per minibatch)."""
    if axis is not None:
        return _global_train_stats(stats, traj, axis)
    loss, pg, vl, ent = stats.mean(dim=(0, 1))
    out = {"loss": loss, "pg_loss": pg, "v_loss": vl, "entropy": ent,
           "reward_per_step": traj.rewards.mean()}
    # Episode metrics averaged over the episodes that ENDED during the
    # rollout (the mask is traj.env_dones); finite when none ended.
    done_f = traj.env_dones.to(torch.float32)
    denom = done_f.sum().clamp(min=1.0)
    for k, v in traj.metrics.items():
        out[f"episode_{k}"] = (v * done_f).sum() / denom
    out["episodes_finished"] = done_f.sum()
    return out


def _global_train_stats(stats, traj, axis) -> dict:
    """:func:`_train_stats` over a mesh: one all-reduce over 'data' of the
    minibatch losses (each rank's share of the global ones), of the
    rewards' sum and of the ended episodes' metric sums and count."""
    done_f = traj.env_dones.to(torch.float32)
    names = list(traj.metrics)
    sums = torch.stack([traj.rewards.sum(), done_f.sum()]
                       + [(traj.metrics[k] * done_f).sum() for k in names])
    total = axis.sum(torch.cat([stats.reshape(-1), sums]))
    k = stats.numel()
    loss, pg, vl, ent = total[:k].reshape(stats.shape).mean(dim=(0, 1))
    reward_sum, finished = total[k], total[k + 1]
    out = {"loss": loss, "pg_loss": pg, "v_loss": vl, "entropy": ent,
           "reward_per_step": reward_sum / (traj.rewards.numel() * axis.size)}
    denom = finished.clamp(min=1.0)
    for j, name in enumerate(names):
        out[f"episode_{name}"] = total[k + 2 + j] / denom
    out["episodes_finished"] = finished
    return out


def _update(model, config: PPOConfig, tx: Optimizer, opt_state, key, n, dataset, loss_fn,
            grad_hook=None, axis=None, inner=None):
    """E epochs x M minibatches on the module's own parameters (already
    loaded). ``dataset``: tensors with the mixed axis (length n) first;
    ``loss_fn(batch)`` gets the list of their minibatch slices ([n // M,
    ...], views: make contiguous what a kernel reads). Returns
    (params, opt_state, key, stats f32[E, M, 4]).

    Over a mesh (``axis``), ``n`` is the global row count, the dataset
    holds this rank's rows (laid out as ``_DataAxis.minibatch_rows``
    reads ``inner``), a minibatch is this rank's share of the global one
    (copies, in global row order), and the gradients are summed over
    'data' before ``grad_hook`` sees them."""
    named = dict(model.named_parameters())
    names, tensors = list(named), list(named.values())
    stats = []
    for epoch in range(config.epochs):
        key, k_mix = jr.split(key)
        if axis is None:
            mix = _epoch_mix(k_mix, n, config.minibatches)
            shuffled = [mix(x) for x in dataset]
        else:
            rows = axis.minibatch_rows(k_mix, n, config.minibatches, inner)
        for i in range(config.minibatches):
            if axis is None:
                loss, aux = loss_fn([x[:, i] for x in shuffled])
            else:
                loss, aux = loss_fn([x.index_select(0, rows[i]) for x in dataset])
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for k, p, g in zip(names, tensors, grads)}
            if axis is not None:
                grads = axis.sum_grads(grads)
            if grad_hook is not None:
                grad_hook(epoch, i, loss.detach(), grads)
            updates, opt_state = tx.update(grads, opt_state,
                                           None if axis is None else axis.norm(grads))
            with torch.no_grad():
                for k, p in named.items():
                    p.add_(updates[k])
            stats.append(torch.stack([loss.detach(), *(a.detach() for a in aux)]))
    stats = torch.stack(stats).reshape(config.epochs, config.minibatches, 4)
    return params_of(model), opt_state, key, stats


def _noop(_name):
    pass


# -- observation-based ------------------------------------------------------


def make_train_step(core, model, config: PPOConfig, tx: Optimizer, grad_hook=None,
                    phase_hook=None, mesh=None):
    """Returns ``train_step(TrainState) -> (TrainState, stats)`` of the
    observation-based path: ``model(obs)`` over rows of single agents.

    ``grad_hook(epoch, minibatch, loss, grads)`` is called after every
    backward pass and ``phase_hook(name)`` at the end of 'rollout', 'gae'
    and 'update' (tests and timing; both optional, on every flavour).
    The module is moved to the core's device. ``mesh``: the state's mesh
    (see :func:`init_train_state`), on every flavour."""
    axis = _data_axis(core, model, mesh)
    rollout = make_rollout_fn(core, model, config.rollout_steps, env_offset=_offset(axis))
    phase = phase_hook or _noop

    def loss_fn(batch):
        obs, actions, old_log_probs, advantages, targets = batch
        logits, values = model(obs)
        return _ppo_loss_terms(config, logits, values, actions, old_log_probs, advantages,
                               targets, axis)

    def train_step(ts: TrainState):
        load_params(model, ts.params)
        env_state, obs, key, traj = rollout(ts.env_state, ts.initial_env_state, ts.obs, ts.key)
        phase("rollout")
        with torch.no_grad():
            _, last_values = model(obs)
            advantages, targets = compute_gae(traj, last_values, config.gamma,
                                              config.gae_lambda)
        phase("gae")

        def flat(x):  # (T, B, N, ...) -> (T*B*N, ...)
            return x.reshape((-1,) + x.shape[3:])

        dataset = [flat(traj.obs), flat(traj.actions), flat(traj.log_probs), flat(advantages),
                   flat(targets)]
        n = _global_rows(dataset[1].shape[0], axis)
        _check_minibatch_divisibility(n, config.minibatches, "rollout rows T*B*N")
        params, opt_state, key, stats = _update(model, config, tx, ts.opt_state, key, n,
                                                dataset, loss_fn, grad_hook, axis,
                                                inner=core.cfg.num_agents)
        phase("update")
        new_ts = ts.replace(params=params, opt_state=opt_state, env_state=env_state, obs=obs,
                            key=key)
        return new_ts, _train_stats(stats, traj, axis)

    return train_step


# -- fused ------------------------------------------------------------------


def make_fused_train_step(core, model, config: PPOConfig, tx: Optimizer, grad_hook=None,
                          phase_hook=None, mesh=None):
    """PPO train step on the fused, observation-free path: the rollout
    stores compact state instead of observations and the update rebuilds
    the policy input from state and the per-env static grids.

    Two obstacle-term strategies (``config.obstacle_path``):

    * 'pre': the grid embedding is one VALID conv
      (``EmbedActorCritic.grid_embed``) per rollout and per minibatch
      loss, and each agent reads its row of it. Minibatches slice the
      TIME axis (every env in every minibatch), so the grids stay
      aligned with the env axis. Needs rollout_steps % minibatches == 0.
    * 'windows': per-agent window extraction (``from_state``, one launch
      of the observation kernel per call) with minibatches of env-steps; each
      row's grid is a row gather ``grids[ids]`` (the JAX package selects
      it with a one-hot matmul). No constraints.
    * 'auto': 'pre' when it is allowed and ``S*S <= 8*w*w`` and the bf16
      grid embedding stays under 6 GB, else 'windows'. The thresholds are
      the JAX package's, kept so that both packages pick the same path
      for the same shapes; they were not measured on this device. Over a
      mesh they read the global ``num_envs``, so every rank picks the
      same path.
    """
    _check_static_maps(core, config)
    time_mb = config.rollout_steps % config.minibatches == 0
    if config.obstacle_path == "pre":
        if not time_mb:
            raise ValueError(
                "obstacle_path='pre' needs rollout_steps divisible by "
                f"minibatches (got {config.rollout_steps} % "
                f"{config.minibatches})"
            )
        use_pre = True
    elif config.obstacle_path == "windows":
        use_pre = False
    elif config.obstacle_path == "auto":
        s_est = core.cfg.size
        w_est = core.cfg.window
        pre_bytes = 2 * core.num_envs * s_est * s_est * model.embed
        use_pre = (time_mb and s_est * s_est <= 8 * w_est * w_est
                   and pre_bytes <= 6_000_000_000)
    else:
        raise ValueError(
            f"unknown obstacle_path {config.obstacle_path!r} "
            "(expected 'auto', 'pre' or 'windows')"
        )
    if use_pre:
        return _make_fused_pre_train_step(core, model, config, tx, grad_hook, phase_hook, mesh)

    axis = _data_axis(core, model, mesh)
    rollout = make_state_rollout_fn(core, model.from_state, config.rollout_steps,
                                    env_offset=_offset(axis))
    phase = phase_hook or _noop

    def train_step(ts: TrainState):
        load_params(model, ts.params)
        # Valid for every transition of this rollout (static-map check).
        grids = ts.env_state.obstacles
        b = grids.shape[0]
        env_state, key, traj = rollout(ts.env_state, ts.initial_env_state, ts.key)
        phase("rollout")
        with torch.no_grad():
            _, last_values = model.from_state(env_state.obstacles, env_state.agents_xy,
                                              env_state.targets_xy, env_state.active)
            advantages, targets = compute_gae(traj, last_values, config.gamma,
                                              config.gae_lambda)
        phase("gae")

        # Rows are env-steps: (T, B, ...) -> (T*B, ...), row s's env is s % B.
        t_steps = traj.actions.shape[0]
        n = t_steps * b

        def flat(x):
            return x.reshape((n,) + x.shape[2:])

        env_ids = torch.arange(b, device=grids.device).repeat(t_steps)
        dataset = [flat(traj.agents_xy), flat(traj.targets_xy), flat(traj.active),
                   flat(traj.actions), flat(traj.log_probs), flat(advantages), flat(targets),
                   env_ids]
        n = _global_rows(n, axis)
        _check_minibatch_divisibility(n, config.minibatches, "rollout rows T*B")

        def loss_fn(batch):
            axy, txy, active, actions, old_log_probs, advantages, targets, ids = batch
            # The observation kernel reads contiguous tensors; the minibatch
            # slices are views of the mixed dataset.
            logits, values = model.from_state(grids[ids], axy.contiguous(), txy.contiguous(),
                                              active)
            return _ppo_loss_terms(config, logits, values, actions, old_log_probs, advantages,
                                   targets, axis)

        params, opt_state, key, stats = _update(model, config, tx, ts.opt_state, key, n,
                                                dataset, loss_fn, grad_hook, axis, inner=1)
        phase("update")
        new_ts = ts.replace(params=params, opt_state=opt_state, env_state=env_state, key=key)
        return new_ts, _train_stats(stats, traj, axis)

    return train_step


def _make_fused_pre_train_step(core, model, config: PPOConfig, tx: Optimizer, grad_hook,
                               phase_hook, mesh):
    """The 'pre' flavour of :func:`make_fused_train_step` (see there).
    Over a mesh every rank holds every time row, for its envs."""
    axis = _data_axis(core, model, mesh)
    rollout = make_state_rollout_fn(core, model.from_state_pre, config.rollout_steps,
                                    make_ctx=model.grid_embed, env_offset=_offset(axis))
    phase = phase_hook or _noop

    def train_step(ts: TrainState):
        load_params(model, ts.params)
        # Valid for every transition of this rollout (static-map check).
        grids = ts.env_state.obstacles
        env_state, key, traj = rollout(ts.env_state, ts.initial_env_state, ts.key)
        phase("rollout")
        # The post-rollout state's maps may already be regenerated
        # ('regen' fires exactly on the rollout boundary): the bootstrap
        # values embed ITS grids, not the rollout's.
        with torch.no_grad():
            _, last_values = model.from_state_pre(
                model.grid_embed(env_state.obstacles), env_state.agents_xy,
                env_state.targets_xy, env_state.active)
            advantages, targets = compute_gae(traj, last_values, config.gamma,
                                              config.gae_lambda)
        phase("gae")

        def loss_fn(batch):
            axy, txy, active, actions, old_log_probs, advantages, targets = batch
            # Recomputed per minibatch so that the obstacle kernel's
            # gradient flows through the conv (over the B static grids,
            # not per row).
            e_grid = model.grid_embed(grids)
            logits, values = model.from_state_pre(e_grid, axy, txy, active)
            return _ppo_loss_terms(config, logits, values, actions, old_log_probs, advantages,
                                   targets, axis)

        def loss_fn_scan_t(batch):
            """The same loss with the policy evaluated one TIME step at a
            time under activation checkpointing: the per-step
            intermediates of ``from_state_pre`` are recomputed in the
            backward pass instead of being kept for all T_mb steps.
            Identical math up to the order of the reductions."""
            axy, txy, active, actions, old_log_probs, advantages, targets = batch
            e_grid = model.grid_embed(grids)
            if axis is None:  # over the whole minibatch
                adv_n, count = _normalize_adv(advantages), float(actions.numel())
            else:
                adv_n, count = axis.normalize(advantages)

            def one_t(e_grid, axy_t, txy_t, act_t, actions_t, old_t, advn_t, tgt_t):
                logits, values = model.from_state_pre(e_grid, axy_t, txy_t, act_t)
                pg_el, v_el, ent_el = _ppo_element_terms(config, logits, values, actions_t,
                                                         old_t, advn_t, tgt_t)
                return torch.stack([pg_el.sum(), v_el.sum(), ent_el.sum()])

            sums = torch.zeros(3, dtype=torch.float32, device=e_grid.device)
            for t in range(actions.shape[0]):
                sums = sums + checkpoint(one_t, e_grid, axy[t], txy[t], active[t], actions[t],
                                         old_log_probs[t], adv_n[t], targets[t],
                                         use_reentrant=False)
            return _ppo_total(config, -sums[0] / count, 0.5 * sums[1] / count, sums[2] / count)

        # The dataset stays [T, B, ...]: minibatches are interleaved
        # slices of the TIME axis, remixed per epoch.
        t_steps = traj.actions.shape[0]
        _check_minibatch_divisibility(t_steps, config.minibatches, "rollout_steps")
        dataset = [traj.agents_xy, traj.targets_xy, traj.active, traj.actions, traj.log_probs,
                   advantages, targets]
        params, opt_state, key, stats = _update(
            model, config, tx, ts.opt_state, key, t_steps, dataset,
            loss_fn_scan_t if config.scan_minibatch_time else loss_fn, grad_hook, axis)
        phase("update")
        new_ts = ts.replace(params=params, opt_state=opt_state, env_state=env_state, key=key)
        return new_ts, _train_stats(stats, traj, axis)

    return train_step


def _train_many(step, steps: int):
    def train_many(ts):
        all_stats = []
        for _ in range(steps):
            ts, stats = step(ts)
            all_stats.append(stats)
        out = {k: torch.stack([s[k] for s in all_stats]).mean() for k in all_stats[0]}
        out["episodes_finished"] = torch.stack(
            [s["episodes_finished"] for s in all_stats]).sum()
        return ts, out

    return train_many


def make_fused_train_many(core, model, config: PPOConfig, tx: Optimizer, steps: int,
                          mesh=None):
    """``steps`` fused train steps in one call: a plain loop (the JAX
    package scans them into one program to save host dispatches). The
    state after it is bit-identical to ``steps`` sequential calls; the
    stats are averaged over the steps and ``episodes_finished`` is
    summed. Returns ``train_many(ts) -> (ts, stats)``."""
    return _train_many(make_fused_train_step(core, model, config, tx, mesh=mesh), steps)


# -- recurrent --------------------------------------------------------------


def make_recurrent_train_step(core, model, config: PPOConfig, tx: Optimizer, grad_hook=None,
                              phase_hook=None, mesh=None):
    """PPO for the recurrent (GRU) family.

    Rollout: observation-free, the hidden state carried and zeroed at
    agent dones. Update: minibatches slice the ENV axis (sequences stay
    whole), and each loss replays the whole rollout-length sequence from
    the stored pre-rollout hidden state; the stored per-step dones
    reproduce the hidden-state evolution the rollout saw, so at epoch 0
    the replayed log-probs equal the rollout's. Each replayed step is
    one ``step_from_state``, hence one launch of the observation kernel.
    Needs num_envs % minibatches == 0 (the global num_envs over a mesh)."""
    _check_static_maps(core, config)
    axis = _data_axis(core, model, mesh)
    rollout = make_recurrent_rollout_fn(core, model.step_from_state, config.rollout_steps,
                                        env_offset=_offset(axis))
    _check_minibatch_divisibility(core.num_envs, config.minibatches,
                                  "num_envs (recurrent minibatches "
                                  "slice the env axis)")
    phase = phase_hook or _noop

    def loss_fn(batch):
        # Minibatch fields are [mb, T, ...] views of the mixed env-major
        # dataset; the replay walks time, so T goes in front, and the
        # copies are contiguous because the observation kernel reads them.
        grids_mb, h = batch[0].contiguous(), batch[1]
        (axy, txy, active, actions, old_log_probs, advantages, targets,
         dones) = (x.transpose(0, 1).contiguous() for x in batch[2:])
        logits, values = [], []
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        for t in range(axy.shape[0]):
            new_h, lg, v = model.step_from_state(grids_mb, axy[t], txy[t], active[t], h)
            h = torch.where(dones[t][..., None], zero, new_h)
            logits.append(lg)
            values.append(v)
        return _ppo_loss_terms(config, torch.stack(logits), torch.stack(values), actions,
                               old_log_probs, advantages, targets, axis)

    def train_step(ts: RecurrentTrainState):
        load_params(model, ts.params)
        # Valid for every transition of this rollout (static-map check).
        grids = ts.env_state.obstacles
        h0 = ts.h
        env_state, h_last, key, traj = rollout(ts.env_state, ts.initial_env_state, ts.h, ts.key)
        phase("rollout")
        with torch.no_grad():
            _, _, last_values = model.step_from_state(
                env_state.obstacles, env_state.agents_xy, env_state.targets_xy,
                env_state.active, h_last)
            advantages, targets = compute_gae(traj, last_values, config.gamma,
                                              config.gae_lambda)
        phase("gae")

        # Env-major dataset [B, T, ...]: the epoch mix partitions envs.
        dataset = [grids, h0] + [x.transpose(0, 1) for x in (
            traj.agents_xy, traj.targets_xy, traj.active, traj.actions, traj.log_probs,
            advantages, targets, traj.dones)]
        params, opt_state, key, stats = _update(model, config, tx, ts.opt_state, key,
                                                core.num_envs, dataset, loss_fn, grad_hook, axis,
                                                inner=1)
        phase("update")
        new_ts = ts.replace(params=params, opt_state=opt_state, env_state=env_state, h=h_last,
                            key=key)
        return new_ts, _train_stats(stats, traj, axis)

    return train_step


def make_recurrent_train_many(core, model, config: PPOConfig, tx: Optimizer, steps: int,
                              mesh=None):
    """``steps`` recurrent train steps in one call; the recurrent
    counterpart of :func:`make_fused_train_many`."""
    return _train_many(make_recurrent_train_step(core, model, config, tx, mesh=mesh), steps)
