"""One whole PPO train step of pogema_tpu and of pogema_torch from one JAX
``init_*_train_state``: the harness and the checks shared by
``test_torch_learner.py`` and the ``test_torch_train_step_*.py`` files,
which state the tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pogema_torch import parallel as tp
from pogema_torch.interop import (params_from_flax, state_to_flax, train_state_from_numpy,
                                  train_state_to_numpy)
from pogema_torch.parallel import learner as tl
from pogema_tpu import models as jm
from pogema_tpu import parallel as jp
from pogema_tpu.parallel import learner as jl
from pogema_tpu.parallel import rollout as jroll
from torch_parity import (assert_states_equal, jax_train_state_to_numpy, make_cores,
                          max_tree_diff, np_tree)

PIECE_TOL = 1e-5
STATS_TOL = 1e-4
GRAD_TOL = 1e-5
BF16_STATS_TOL = 2e-3
BF16_GRAD_TOL = 5e-2
GRID = dict(seed=0, size=8, density=0.2, num_agents=2, obs_radius=2, max_episode_steps=16,
            on_target="restart")
PPO = dict(rollout_steps=8, epochs=2, minibatches=2)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def tp_model(family, dtype):
    """(JAX module, port module, JAX params) of one family, same weights."""
    jd, td = DTYPES[dtype]
    w = 2 * GRID["obs_radius"] + 1
    if family == "conv":
        _, params = jm.init_params(jax.random.key(0), w, hidden=32, channels=4)
        jmodel = jm.ActorCritic(hidden=32, channels=4, dtype=jd)
    elif family == "recurrent":
        _, params = jm.init_recurrent_params(jax.random.key(0), w, embed=32, hidden=32)
        jmodel = jm.RecurrentEmbedActorCritic(window=w, embed=32, hidden=32, dtype=jd)
    else:
        _, params = jm.init_embed_params(jax.random.key(0), w, embed=32, hidden=32)
        jmodel = jm.EmbedActorCritic(window=w, embed=32, hidden=32, dtype=jd)
    model, _ = params_from_flax(np_tree(params), td)
    return jmodel, model, params


FLAVOURS = {
    # name: (family, obstacle_path, jax init, jax make, port make)
    "obs": ("conv", "auto", jp.init_train_state, jp.make_train_step, tp.make_train_step),
    "fused_windows": ("fused", "windows", jp.init_fused_train_state, jp.make_fused_train_step,
                      tp.make_fused_train_step),
    "fused_pre": ("fused", "pre", jp.init_fused_train_state, jp.make_fused_train_step,
                  tp.make_fused_train_step),
    "recurrent": ("recurrent", "auto", jp.init_recurrent_train_state,
                  jp.make_recurrent_train_step, tp.make_recurrent_train_step),
}


def _jax_first_minibatch_grads(flavour, jc, jmodel, jcfg, ts):
    """The first minibatch's loss gradient rebuilt from the JAX package's
    own pieces: its rollout, ``compute_gae``, ``_epoch_mix`` with the key
    the train step would use, ``model.apply`` and ``_ppo_loss_terms``."""
    t_steps, m = jcfg.rollout_steps, jcfg.minibatches
    mcls = type(jmodel)
    params = ts.params
    if flavour == "obs":
        roll = jax.jit(jroll.make_rollout_fn(jc, jmodel.apply, t_steps))
        env_state, obs, key, traj = roll(params, ts.env_state, ts.initial_env_state, ts.obs, ts.key)
        _, last = jmodel.apply(params, obs)
        adv, tgt = jl.compute_gae(traj, last, jcfg.gamma, jcfg.gae_lambda)
        flat = lambda x: x.reshape((-1,) + x.shape[3:])
        data = [flat(x) for x in (traj.obs, traj.actions, traj.log_probs, adv, tgt)]
        n = data[1].shape[0]

        def loss(p, batch):
            o, a, lp, ad, tg = batch
            logits, values = jmodel.apply(p, o)
            return jl._ppo_loss_terms(jcfg, logits, values, a, lp, ad, tg)[0]
    elif flavour == "recurrent":
        cell = lambda p, *a: jmodel.apply(p, *a, method=mcls.step_from_state)
        roll = jax.jit(jroll.make_recurrent_rollout_fn(jc, cell, t_steps))
        env_state, h_last, key, traj = roll(params, ts.env_state, ts.initial_env_state, ts.h, ts.key)
        _, _, last = cell(params, env_state.obstacles, env_state.agents_xy,
                          env_state.targets_xy, env_state.active, h_last)
        adv, tgt = jl.compute_gae(traj, last, jcfg.gamma, jcfg.gae_lambda)
        em = lambda x: jnp.swapaxes(x, 0, 1)
        data = [ts.env_state.obstacles, ts.h] + [em(x) for x in (
            traj.agents_xy, traj.targets_xy, traj.active, traj.actions, traj.log_probs, adv, tgt,
            traj.dones)]
        n = jc.num_envs

        def loss(p, batch):
            grids, h = batch[0], batch[1]
            axy, txy, act, a, lp, ad, tg, dn = (jnp.swapaxes(x, 0, 1) for x in batch[2:])
            logits, values = [], []
            for t in range(t_steps):
                h, lg, v = cell(p, grids, axy[t], txy[t], act[t], h)
                h = jnp.where(dn[t][..., None], 0, h)
                logits.append(lg)
                values.append(v)
            return jl._ppo_loss_terms(jcfg, jnp.stack(logits), jnp.stack(values), a, lp, ad, tg)[0]
    else:
        pre = flavour == "fused_pre"
        embed = lambda p, g: jmodel.apply(p, g, method=mcls.grid_embed)
        apply = lambda p, *a: jmodel.apply(p, *a, method=mcls.from_state_pre if pre
                                           else mcls.from_state)
        roll = jax.jit(jroll.make_state_rollout_fn(jc, apply, t_steps,
                                                   make_ctx=embed if pre else None))
        env_state, key, traj = roll(params, ts.env_state, ts.initial_env_state, ts.key)
        g_last = env_state.obstacles
        _, last = apply(params, embed(params, g_last) if pre else g_last, env_state.agents_xy,
                        env_state.targets_xy, env_state.active)
        adv, tgt = jl.compute_gae(traj, last, jcfg.gamma, jcfg.gae_lambda)
        fields = (traj.agents_xy, traj.targets_xy, traj.active, traj.actions, traj.log_probs,
                  adv, tgt)
        grids = ts.env_state.obstacles
        if pre:
            data, n = list(fields), t_steps

            def loss(p, batch):
                axy, txy, act, a, lp, ad, tg = batch
                logits, values = apply(p, embed(p, grids), axy, txy, act)
                return jl._ppo_loss_terms(jcfg, logits, values, a, lp, ad, tg)[0]
        else:
            b = jc.num_envs
            n = t_steps * b
            data = [x.reshape((n,) + x.shape[2:]) for x in fields]
            data.append(jnp.tile(jnp.arange(b, dtype=jnp.int32), t_steps))

            def loss(p, batch):
                axy, txy, act, a, lp, ad, tg, ids = batch
                logits, values = apply(p, grids[ids], axy, txy, act)
                return jl._ppo_loss_terms(jcfg, logits, values, a, lp, ad, tg)[0]
    key, k_mix = jax.random.split(key)
    mix = jl._epoch_mix(k_mix, n, m)
    batch = [mix(x)[:, 0] for x in data]
    return jax.grad(loss)(params, batch), traj


def _setup(flavour, dtype):
    family, path, jinit, jmake, tmake = FLAVOURS[flavour]
    jmodel, model, params = tp_model(family, dtype)
    mode = "cached" if flavour == "obs" else "regen"
    jc, tc = make_cores(GRID, 8, auto_reset_mode=mode)
    jcfg = jl.PPOConfig(obstacle_path=path, **PPO)
    tcfg = tl.PPOConfig(obstacle_path=path, **PPO)
    ts, tx = jinit(jc, jmodel, params, jcfg, jax.random.key(1))
    return jc, tc, jmodel, model, jcfg, tcfg, ts, tx, jmake, tmake


_CACHE = {}


def _one_step(flavour, dtype):
    """One train step of both packages from one JAX init; cached per
    (flavour, dtype) so that the tests below share the compile."""
    if (flavour, dtype) in _CACHE:
        return _CACHE[flavour, dtype]
    jc, tc, jmodel, model, jcfg, tcfg, ts, tx, jmake, tmake = _setup(flavour, dtype)
    jts, jstats = jax.jit(jmake(jc, jmodel, jcfg, tx))(ts)
    jgrads, jtraj = _jax_first_minibatch_grads(flavour, jc, jmodel, jcfg, ts)
    grads = []
    tts0 = train_state_from_numpy(jax_train_state_to_numpy(ts), "cpu", DTYPES[dtype][1])
    topt = tp.Optimizer(lr=tcfg.lr, max_norm=tcfg.max_grad_norm)
    step = tmake(tc, model, tcfg, topt,
                 grad_hook=lambda e, i, loss, g: grads.append({k: v.clone() for k, v in g.items()}))
    tts, tstats = step(tts0)
    out = dict(jts=jts, jstats=jstats, jgrads=jgrads, tts0=tts0, tts=tts, tstats=tstats,
               grads=grads, tcfg=tcfg, model=model, step=step)
    _CACHE[flavour, dtype] = out
    return out


def _stats_close(tstats, jstats, tol, where):
    assert set(tstats) == set(jstats), where
    for k in jstats:
        want, got = float(jstats[k]), float(tstats[k])
        assert np.isfinite(got), (where, k)
        assert abs(got - want) <= tol * max(1.0, abs(want)), f"{where} {k}: {got} vs {want}"


def _integer_state_equal(r, where):
    assert_states_equal(r["jts"].env_state, r["tts"].env_state, f"{where} env state")
    np.testing.assert_array_equal(r["tts"].key.numpy(),
                                  np.asarray(jax.random.key_data(r["jts"].key)).astype(np.int64),
                                  err_msg=f"{where} key")


def check_whole_train_step_f32(flavour):
    r = _one_step(flavour, "f32")
    _integer_state_equal(r, flavour)
    _stats_close(r["tstats"], r["jstats"], STATS_TOL, flavour)
    cfg = r["tcfg"]
    assert len(r["grads"]) == cfg.epochs * cfg.minibatches
    # First minibatch's gradients, relative to the largest entry.
    got = state_to_flax(r["grads"][0])
    scale = max(float(np.abs(np.asarray(x)).max()) for x in jax.tree.leaves(r["jgrads"]))
    err, at = max_tree_diff(r["jgrads"], got, flavour)
    assert err <= GRAD_TOL * scale, f"{flavour}: gradient differs by {err} (scale {scale}) at {at}"
    # Parameters after E*M Adam steps.
    got_p = state_to_flax(r["tts"].params)
    err, at = max_tree_diff(r["jts"].params, got_p, flavour)
    bound = 2 * cfg.lr * cfg.epochs * cfg.minibatches
    assert err <= bound, f"{flavour}: parameters differ by {err} > {bound} at {at}"
    diffs = np.concatenate([
        np.abs(np.asarray(a) - b).ravel() for a, b in
        zip(jax.tree.leaves(r["jts"].params), jax.tree.leaves(got_p))])
    assert (diffs <= 1e-6).mean() >= 0.99, f"{flavour}: {(diffs > 1e-6).mean()} of entries off"
    # The optimizer state came along: count and the moments.
    adam = r["jts"].opt_state[1][0]
    tnp = train_state_to_numpy(r["tts"])
    assert int(tnp["opt_state"]["count"]) == int(adam.count) == cfg.epochs * cfg.minibatches
    err, at = max_tree_diff(adam.mu, tnp["opt_state"]["mu"], flavour)
    assert err <= GRAD_TOL * scale, (flavour, "mu", err, at)
    if flavour == "recurrent":
        np.testing.assert_allclose(tnp["h"], np.asarray(r["jts"].h, np.float32), atol=PIECE_TOL)


def check_whole_train_step_bf16(flavour):
    r = _one_step(flavour, "bf16")
    _integer_state_equal(r, flavour)
    _stats_close(r["tstats"], r["jstats"], BF16_STATS_TOL, flavour)
    scale = max(float(np.abs(np.asarray(x)).max()) for x in jax.tree.leaves(r["jgrads"]))
    err, at = max_tree_diff(r["jgrads"], state_to_flax(r["grads"][0]), flavour)
    assert err <= BF16_GRAD_TOL * scale, f"{flavour}: bf16 gradient differs by {err} " \
                                          f"(scale {scale}) at {at}"
    cfg = r["tcfg"]
    err, at = max_tree_diff(r["jts"].params, state_to_flax(r["tts"].params), flavour)
    assert err <= 2 * cfg.lr * cfg.epochs * cfg.minibatches, (flavour, err, at)


def check_train_step_returns_a_new_state(flavour):
    """The step aliases neither the old state nor the module: a second
    step leaves the first result untouched, and the module holds the
    newest parameters."""
    r = _one_step(flavour, "f32")
    before = {k: v.clone() for k, v in r["tts"].params.items()}
    start = {k: v.clone() for k, v in r["tts0"].params.items()}
    tts2, _ = r["step"](r["tts"])
    for k in before:
        assert torch.equal(r["tts"].params[k], before[k]), k
        assert torch.equal(r["tts0"].params[k], start[k]), k
        assert r["tts"].params[k].data_ptr() != tts2.params[k].data_ptr()
    assert any(not torch.equal(before[k], tts2.params[k]) for k in before)
    own = dict(r["model"].named_parameters())
    assert all(torch.equal(own[k], tts2.params[k]) and own[k].data_ptr() != tts2.params[k].data_ptr()
               for k in own)
    assert int(tts2.opt_state["count"]) == 2 * int(r["tts"].opt_state["count"])
