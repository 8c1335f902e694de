"""The port's policy evaluator against pogema_tpu's, on the CPU.

* f32 models (dtype=float32 on both sides, at the sizes of
  tests/test_policy_evaluator.py): the final state and the metrics of
  whole episodes must be bit-equal, for 'finish' and 'restart', several
  keys, greedy and sampled actions.
* bf16, teacher-forced: a JAX greedy trajectory, run as the JAX
  evaluator's loop runs it, feeds its states step by step to both
  models, and the per-step logits must
  agree within ``BF16_TOL`` (tests/test_torch_models.py says why), the
  JAX side applied eagerly (see the test).
  A free-running bf16 episode could diverge on one flipped near-tie
  argmax, which says nothing about the loop.
* ``greedy=False`` draws: ``random.categorical`` against
  ``jax.random.categorical`` on fixed logits and keys.
* The port's new modules import no JAX (a subprocess).
"""

import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pogema_torch.core import random as jr
from pogema_torch.interop import params_from_flax, state_from_numpy
from pogema_torch.parallel import make_policy_evaluator
from pogema_tpu import models as jm
from pogema_tpu.core import step as jstep
from pogema_tpu.parallel import make_policy_evaluator as jax_policy_evaluator
from pogema_tpu.utils.checkpoint import restore_checkpoint
from test_torch_models import BF16_TOL, _close, _greedy_agree, _np_tree
from torch_parity import assert_states_equal, assert_trees_equal, jax_state_to_numpy, make_cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cores(on_target, num_envs=16, **kw):
    grid = dict(seed=0, size=12, density=0.25, num_agents=4, obs_radius=3,
                max_episode_steps=24, on_target=on_target)
    grid.update(kw)
    return make_cores(grid, num_envs)


def _f32_models(recurrent):
    if recurrent:
        _, params = jm.init_recurrent_params(jax.random.key(1), 7, embed=32, hidden=32)
        jmodel = jm.RecurrentEmbedActorCritic(window=7, embed=32, hidden=32, dtype=jnp.float32)
    else:
        _, params = jm.init_embed_params(jax.random.key(0), 7, embed=32, hidden=32)
        jmodel = jm.EmbedActorCritic(window=7, embed=32, hidden=32, dtype=jnp.float32)
    model, _ = params_from_flax(_np_tree(params), torch.float32)
    return jmodel, params, model


@pytest.mark.parametrize("recurrent,on_target,greedy", [
    (False, "finish", True), (True, "finish", True),
    (False, "restart", True), (True, "restart", True),
    (True, "restart", False), (False, "finish", False)])
def test_policy_evaluator_bit_equal_f32(recurrent, on_target, greedy):
    jc, tc = _cores(on_target)
    jmodel, params, model = _f32_models(recurrent)
    jrun = jax_policy_evaluator(jc, jmodel, params, greedy=greedy)
    trun = make_policy_evaluator(tc, model, greedy=greedy)
    for seed in (7, 2**31 + 3):
        js, jmet = jrun(jax.random.key(seed))
        ts, tmet = trun(tc.make_key(seed))
        assert_states_equal(js, ts, f"final state, seed {seed}")
        assert_trees_equal(jmet, tmet, f"metrics, seed {seed}")
    if on_target == "restart":
        np.testing.assert_array_equal(tmet["ep_length"].numpy(), 24.0)


def test_teacher_forced_bf16_logits_on_the_jax_trajectory():
    """The shipped recurrent checkpoint in bf16 on LifeLong 16x16, 8
    agents, r=5: JAX's greedy trajectory drives both models; the port
    carries its own hidden state, built from the same states."""
    params = restore_checkpoint(os.path.join(ROOT, ".ckpt_rec128_ft"))
    jc, tc = _cores("restart", num_envs=4, size=16, num_agents=8, obs_radius=5,
                    max_episode_steps=8)
    jmodel = jm.RecurrentEmbedActorCritic(window=11, embed=128, hidden=128)
    model, _ = params_from_flax(_np_tree(params))
    cfg = jc.cfg
    # Eager, not jitted: under jit XLA may feed the GRU's unrounded f32
    # output to the f32 head (excess precision), which moves the logits by
    # up to ~2e-2; the port rounds h to bf16 first, as the flax code reads.
    policy = partial(jmodel.apply, method=jm.RecurrentEmbedActorCritic.step_from_state)
    env_step = jax.jit(jax.vmap(partial(jstep.step_one, cfg)))
    done_fn = jax.jit(jax.vmap(partial(jstep.episode_done, cfg)))
    st, _ = jc.reset(jax.random.key(5), with_obs=False)
    hj = jmodel.initial_carry((4, 8))
    ht = model.initial_carry((4, 8))
    for t in range(cfg.max_episode_steps):
        done = done_fn(st)
        hj, lj, vj = policy(params, st.obstacles, st.agents_xy, st.targets_xy, st.active, hj)
        ts = state_from_numpy(jax_state_to_numpy(st), "cpu")
        with torch.no_grad():
            ht, lt, vt = model.step_from_state(ts.obstacles, ts.agents_xy, ts.targets_xy,
                                               ts.active, ht)
        _close(lt, lj, BF16_TOL, f"logits, step {t}")
        _close(vt, vj, BF16_TOL, f"values, step {t}")
        _greedy_agree(lt, lj, BF16_TOL, f"step {t}")
        new, _ = env_step(st, jnp.argmax(lj, axis=-1).astype(jnp.int32))
        st = jax.tree.map(lambda a, b: jnp.where(done.reshape(done.shape + (1,) * (a.ndim - 1)),
                                                 b, a), new, st)
    assert float(np.asarray(st.goals_achieved).sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2**32 - 1])
def test_categorical_matches_jax(seed):
    logits = np.random.default_rng(seed).normal(size=(16, 9, 5)).astype(np.float32)
    logits[0, 0] = 0.0  # all-equal logits: the draw alone decides
    want = np.asarray(jax.random.categorical(jax.random.key(seed), jnp.asarray(logits)))
    got = jr.categorical(jr.key(seed), torch.as_tensor(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    g = jr.gumbel(jr.key(seed), (7, 3)).numpy()
    np.testing.assert_allclose(g, np.asarray(jax.random.gumbel(jax.random.key(seed), (7, 3))),
                               rtol=1e-6, atol=1e-6)


def test_evaluator_reset_matches_core_reset_and_raises_when_unplaceable():
    _, tc = _cores("finish", num_envs=3)
    _, _, model = _f32_models(False)
    state, _ = make_policy_evaluator(tc, model)(tc.make_key(4))
    ref, _ = tc.reset(tc.make_key(4), with_obs=False)
    assert torch.equal(state.obstacles, ref.obstacles)
    with pytest.warns(UserWarning):
        _, tiny = make_cores(dict(size=3, num_agents=10, density=0.5), 2)
    with pytest.raises(ValueError, match="placement failed"):
        make_policy_evaluator(tiny, model)(tiny.make_key(0))


def test_port_modules_import_no_jax():
    code = ("import sys; import pogema_torch.models, pogema_torch.parallel, "
            "pogema_torch.parallel.learner, pogema_torch.parallel.rollout, "
            "pogema_torch.parallel.optim, pogema_torch.utils.checkpoint, "
            "pogema_torch.core.planner, pogema_torch.interop; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pogema_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
