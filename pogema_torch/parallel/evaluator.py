"""Batched evaluation of a trained policy over B envs on one device.

Counterpart of ``pogema_tpu/parallel/evaluator.py``
(``make_policy_evaluator``): reset, then ``max_episode_steps`` times the
observation-free policy forward (``EmbedActorCritic.from_state`` or
``RecurrentEmbedActorCritic.step_from_state``, one K1b launch each on the
card), the action, the env step, and the freeze of the envs whose
episode had already ended; then the episode metrics. An episode runs
under ``torch.inference_mode``: its tensors can never enter autograd, so
a recurrent bf16 128/128 policy's steps on the card go to K8
(``ops.cuda_policy.engages``). The JAX package
runs this as one jitted ``lax.scan``; here it is a Python loop of batched
tensor ops.

    core = PogemaCore(cfg, num_envs=1024)                # on the card
    model = load_policy("pogema_torch/weights/rec128_ft.npz")
    run = make_policy_evaluator(core, model)
    state, metrics = run(core.make_key(seed))
    float(metrics["avg_throughput"].mean())
"""

from __future__ import annotations

import torch

from ..core import metrics as metrics_mod
from ..core import random as jr
from ..core import step as step_mod
from ..core.api import select_state
from ..utils.profiling import traced

# Folded into the caller's key for the per-step action stream.
ACTION_STREAM = 0x9E3779B9


def make_policy_evaluator(core, model, greedy: bool = True):
    """Returns ``run(key) -> (final_state, {metric: f32[B]})``.

    ``model``: an EmbedActorCritic or RecurrentEmbedActorCritic (told
    apart by ``initial_carry``) on the core's device. ``greedy``: argmax
    actions (first index on ties, as ``jnp.argmax``); False samples
    ``jax.random.categorical`` from the logits.

    The reset consumes the caller's key verbatim, so the world matches
    ``core.reset(key)`` and the planner evaluator on the same key; it
    raises ValueError when placement failed for any env. The action keys
    come from ``fold_in(key, ACTION_STREAM)``, split once per step; a
    greedy run draws nothing from them and skips the split. Finished envs
    are frozen, so ep_length, ISR and CSR stop at the true episode end."""
    cfg = core.cfg
    recurrent = hasattr(model, "initial_carry")

    @traced("pogema.policy")
    def policy(st, h):
        if recurrent:
            h, logits, _ = model.step_from_state(st.obstacles, st.agents_xy, st.targets_xy,
                                                 st.active, h)
            return h, logits
        logits, _ = model.from_state(st.obstacles, st.agents_xy, st.targets_xy, st.active)
        return h, logits

    @torch.inference_mode()
    @traced("pogema.episode")
    def run(key):
        key = torch.as_tensor(key, device=core.device).to(torch.int64)
        state, _ = core.reset(key, with_obs=False)
        k = jr.fold_in(key, ACTION_STREAM)
        h = (model.initial_carry((core.num_envs, cfg.num_agents), device=core.device)
             if recurrent else None)
        for _ in range(cfg.max_episode_steps):
            done = step_mod.episode_done(cfg, state)
            h, logits = policy(state, h)
            if greedy:
                actions = logits.argmax(dim=-1)
            else:
                k, k_act = jr.split(k)
                actions = jr.categorical(k_act, logits)
            new_state, _ = step_mod.step(cfg, state, actions.to(torch.int32), with_obs=False)
            state = select_state(done, state, new_state)
        return state, metrics_mod.episode_metrics(cfg, state)

    return run
