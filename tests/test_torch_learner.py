"""The pieces of the port's PPO learner against pogema_tpu's, on the CPU:
GAE, log-probs, the loss terms, the minibatch partition, the error
messages; then the port's own properties: the recurrent replay,
``train_many`` == sequential steps, the time-scanned 'pre' loss, the
'auto' rule. Whole train steps against JAX are in
``test_torch_train_step_ff.py`` and ``test_torch_train_step_seq.py``.

Tolerance of the pieces on random f32 inputs: ``PIECE_TOL`` = 1e-5
(absolute and relative), for summation order and the last bit of exp and
log. The partition and the messages are equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pogema_torch import parallel as tp
from pogema_torch.core import random as jr
from pogema_torch.interop import train_state_from_numpy
from pogema_torch.parallel import learner as tl
from pogema_torch.parallel.rollout import StateTransition, log_prob_of
from pogema_tpu.parallel import learner as jl
from pogema_tpu.parallel import rollout as jroll
from torch_parity import jax_train_state_to_numpy, make_cores
from torch_train_parity import GRID, PIECE_TOL, _setup, tp_model


# -- pieces -------------------------------------------------------------------


def _random_traj(rng, t=6, b=3, n=4):
    f = lambda: rng.normal(size=(t, b, n)).astype(np.float32)
    return dict(values=f(), rewards=f(), dones=rng.random((t, b, n)) < 0.2,
                last=rng.normal(size=(b, n)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_gae_matches_jax(seed):
    d = _random_traj(np.random.default_rng(seed))
    jt = jroll.StateTransition(None, None, None, None, None, jnp.asarray(d["values"]),
                               jnp.asarray(d["rewards"]), jnp.asarray(d["dones"]), None, {})
    tt = StateTransition(None, None, None, None, None, torch.tensor(d["values"]),
                         torch.tensor(d["rewards"]), torch.tensor(d["dones"]), None, {})
    ja, jt_ = jl.compute_gae(jt, jnp.asarray(d["last"]), 0.99, 0.95)
    ta, tt_ = tl.compute_gae(tt, torch.tensor(d["last"]), 0.99, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=PIECE_TOL, rtol=PIECE_TOL)
    np.testing.assert_allclose(tt_.numpy(), np.asarray(jt_), atol=PIECE_TOL, rtol=PIECE_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_log_prob_and_loss_terms_match_jax(seed):
    rng = np.random.default_rng(seed)
    shape = (5, 3, 4)
    logits = rng.normal(size=shape + (5,)).astype(np.float32) * 2
    actions = rng.integers(0, 5, shape).astype(np.int32)
    values, targets, adv = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    want_lp = np.asarray(jroll.log_prob_of(jnp.asarray(logits), jnp.asarray(actions)))
    got_lp = log_prob_of(torch.tensor(logits), torch.tensor(actions)).numpy()
    np.testing.assert_allclose(got_lp, want_lp, atol=PIECE_TOL)
    old = (want_lp + rng.normal(size=shape) * 0.3).astype(np.float32)  # ratios on both sides of the clip
    jcfg, tcfg = jl.PPOConfig(entropy_coef=0.02), tl.PPOConfig(entropy_coef=0.02)
    jtot, jaux = jl._ppo_loss_terms(jcfg, *(jnp.asarray(x) for x in
                                            (logits, values, actions, old, adv, targets)))
    ttot, taux = tl._ppo_loss_terms(tcfg, *(torch.tensor(x) for x in
                                            (logits, values, actions, old, adv, targets)))
    np.testing.assert_allclose(float(ttot), float(jtot), atol=PIECE_TOL)
    for g, w in zip(taux, jaux):
        np.testing.assert_allclose(float(g), float(w), atol=PIECE_TOL)
    # The normalisation uses the population standard deviation.
    a = torch.tensor(adv)
    np.testing.assert_allclose(tl._normalize_adv(a).numpy(),
                               np.asarray(jl._normalize_adv(jnp.asarray(adv))), atol=PIECE_TOL)


@pytest.mark.parametrize("n,m", [(16, 2), (64, 4), (96, 8), (1024, 8), (40, 5)])
def test_epoch_mix_same_partition_same_order(n, m):
    """The port's minibatches hold the same rows in the same order as
    JAX's, for several keys."""
    rows = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    seen = set()
    for seed in range(6):
        want = np.asarray(jl._epoch_mix(jax.random.key(seed), n, m)(jnp.asarray(rows)))
        got = tl._epoch_mix(jr.key(seed), n, m)(torch.tensor(rows)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.shape == (n // m, m, 3)
        seen.add(tuple(got[:4, 0, 0]))
    assert len(seen) > 1  # the composition varies with the key


def test_divisibility_and_static_map_errors_carry_the_jax_messages():
    def messages(fn_j, fn_t):
        with pytest.raises(ValueError) as ej:
            fn_j()
        with pytest.raises(ValueError) as et:
            fn_t()
        assert str(ej.value) == str(et.value)
        return str(et.value)

    msg = messages(lambda: jl._check_minibatch_divisibility(10, 4, "rollout rows T*B"),
                   lambda: tl._check_minibatch_divisibility(10, 4, "rollout rows T*B"))
    assert "must be divisible by minibatches" in msg
    grid = dict(GRID, on_target="finish")
    jc, tc = make_cores(grid, 4, auto_reset_mode="regen")
    msg = messages(lambda: jl._check_static_maps(jc, jl.PPOConfig(rollout_steps=8)),
                   lambda: tl._check_static_maps(tc, tl.PPOConfig(rollout_steps=8)))
    assert "static per-rollout maps" in msg
    jc, tc = make_cores(GRID, 4, auto_reset_mode="regen")
    messages(lambda: jl._check_static_maps(jc, jl.PPOConfig(rollout_steps=7)),
             lambda: tl._check_static_maps(tc, tl.PPOConfig(rollout_steps=7)))
    tl._check_static_maps(tc, tl.PPOConfig(rollout_steps=8))  # regen + restart, aligned
    _, cached = make_cores(grid, 4)
    tl._check_static_maps(cached, tl.PPOConfig(rollout_steps=7))  # cached is always fine
    model, _ = tp_model("fused", "f32")[1:]
    with pytest.raises(ValueError, match="needs rollout_steps divisible by"):
        tp.make_fused_train_step(tc, model, tl.PPOConfig(rollout_steps=8, minibatches=3,
                                                         obstacle_path="pre"), None)
    with pytest.raises(ValueError, match="unknown obstacle_path"):
        tp.make_fused_train_step(tc, model, tl.PPOConfig(rollout_steps=8, obstacle_path="x"), None)
    rmodel = tp_model("recurrent", "f32")[1]
    with pytest.raises(ValueError, match="recurrent minibatches slice the env axis"):
        tp.make_recurrent_train_step(tc, rmodel, tl.PPOConfig(rollout_steps=8, minibatches=3),
                                     None)


# -- the recurrent replay, train_many, scan_minibatch_time ----------------------


def test_recurrent_replay_reproduces_the_rollout():
    """Replaying the stored (state, dones) sequence from the pre-rollout
    hidden state gives the rollout's log-probs, values and final hidden
    state again, bit for bit on the CPU: what the recurrent loss relies
    on at epoch 0 (the property of tests/test_recurrent.py's replay test)."""
    from pogema_torch.parallel.rollout import make_recurrent_rollout_fn

    grid = dict(GRID, on_target="finish", max_episode_steps=8, num_agents=3)
    _, tc = make_cores(grid, 8)
    _, model, _ = tp_model("recurrent", "f32")
    state, _ = tc.reset(tc.make_key(1), with_obs=False)
    h0 = model.initial_carry((8, 3))
    rollout = make_recurrent_rollout_fn(tc, model.step_from_state, 20)
    _, h_last, _, traj = rollout(state, state, h0, tc.make_key(2))
    assert bool(traj.env_dones.any()), "want episode ends inside the rollout"
    h = h0
    with torch.no_grad():
        for t in range(20):
            h, logits, values = model.step_from_state(state.obstacles, traj.agents_xy[t],
                                                      traj.targets_xy[t], traj.active[t], h)
            h = torch.where(traj.dones[t][..., None], torch.zeros(()), h)
            assert torch.equal(log_prob_of(logits, traj.actions[t]), traj.log_probs[t]), t
            assert torch.equal(values, traj.values[t]), t
    assert torch.equal(h, h_last)


def _leaves(ts):
    out = dict(ts.params)
    out.update({f"mu/{k}": v for k, v in ts.opt_state["mu"].items()})
    out.update({f"nu/{k}": v for k, v in ts.opt_state["nu"].items()})
    out.update({f"env/{k}": v for k, v in ts.env_state.tensors().items()})
    out["count"], out["key"] = ts.opt_state["count"], ts.key
    if hasattr(ts, "h"):
        out["h"] = ts.h
    return out


@pytest.mark.parametrize("flavour", ["fused_pre", "recurrent"])
def test_train_many_equals_sequential_steps(flavour):
    _, tc, _, model, _, tcfg, ts, _, _, tmake = _setup(flavour, "f32")
    tts = train_state_from_numpy(jax_train_state_to_numpy(ts), "cpu", torch.float32)
    topt = tp.Optimizer(lr=tcfg.lr, max_norm=tcfg.max_grad_norm)
    step = tmake(tc, model, tcfg, topt)
    many = (tp.make_recurrent_train_many if flavour == "recurrent"
            else tp.make_fused_train_many)(tc, model, tcfg, topt, 3)
    seq, losses, finished = tts, [], 0.0
    for _ in range(3):
        seq, stats = step(seq)
        losses.append(float(stats["loss"]))
        finished += float(stats["episodes_finished"])
    got, stats_many = many(tts)
    a, b = _leaves(seq), _leaves(got)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert np.isclose(float(stats_many["loss"]), np.mean(losses), rtol=1e-5)
    assert float(stats_many["episodes_finished"]) == finished == 8.0  # 24 steps, limit 16


def test_scan_minibatch_time_matches_one_shot_loss():
    """The time-scanned, checkpointed 'pre' loss against the one-shot
    loss over three steps, at the bounds of tests/test_fused.py's test of
    the same name: stats rtol 1e-3 / atol 1e-5, parameters rtol 2e-3 /
    atol 2e-4, positions identical."""
    _, tc, _, model, _, tcfg, ts, _, _, tmake = _setup("fused_pre", "f32")
    _, model_b, _ = tp_model("fused", "f32")
    start = train_state_from_numpy(jax_train_state_to_numpy(ts), "cpu", torch.float32)
    topt = tp.Optimizer(lr=tcfg.lr, max_norm=tcfg.max_grad_norm)
    step = tmake(tc, model, tcfg, topt)
    step_scan = tmake(tc, model_b, tcfg.replace(scan_minibatch_time=True), topt)
    ts_a, ts_b = start, start
    for i in range(3):
        ts_a, stats_a = step(ts_a)
        ts_b, stats_b = step_scan(ts_b)
        for k in ("loss", "pg_loss", "v_loss", "entropy"):
            np.testing.assert_allclose(float(stats_a[k]), float(stats_b[k]), rtol=1e-3, atol=1e-5,
                                       err_msg=f"step {i} stat {k}")
    assert torch.equal(ts_a.env_state.agents_xy, ts_b.env_state.agents_xy)
    for k in ts_a.params:
        np.testing.assert_allclose(ts_a.params[k].numpy(), ts_b.params[k].numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=k)


def test_auto_rule_picks_the_same_path_as_jax():
    """'auto' follows the JAX package's thresholds: 'pre' for S^2 <= 8 w^2
    with rollout_steps % minibatches == 0, else 'windows' (told apart by
    whether the step convolves the grids)."""
    from pogema_torch.models import EmbedActorCritic

    for size, minibatches, want_pre in ((8, 2, True), (8, 3, False), (16, 2, False)):
        grid = dict(GRID, size=size)
        _, tc = make_cores(grid, 6, auto_reset_mode="regen")
        _, model, _ = tp_model("fused", "f32")
        cfg = tl.PPOConfig(rollout_steps=4, epochs=1, minibatches=minibatches)
        ts, topt = tp.init_fused_train_state(tc, model, None, cfg, tc.make_key(0))
        EmbedActorCritic.grid_embed.calls = 0
        _, stats = tp.make_fused_train_step(tc, model, cfg, topt)(ts)
        assert (EmbedActorCritic.grid_embed.calls > 0) == want_pre, (size, minibatches)
        if want_pre:  # one per rollout, one for the bootstrap, one per loss
            assert EmbedActorCritic.grid_embed.calls == 2 + cfg.epochs * minibatches
        assert all(torch.isfinite(v) for v in stats.values())
