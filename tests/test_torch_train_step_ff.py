"""One whole PPO train step of the port against pogema_tpu's, on the CPU:
the observation-based (conv model) and fused 'windows' flavours.

Both packages start from ONE JAX ``init_*_train_state``, carried across
as numpy (``torch_parity.jax_train_state_to_numpy`` ->
``interop.train_state_from_numpy``), and take one train step of 2 epochs
x 2 minibatches. Sizes follow ``tests/test_fused.py``: 8 envs x 2 agents,
8x8, r=2, T=8, embed/hidden 32. The harness is ``torch_train_parity.py``.

Tolerances:

* f32 model: integer env state and the key bit-equal; stats within
  ``STATS_TOL`` = 1e-4 (absolute, relative where the value exceeds 1;
  measured 2e-7); the first minibatch's gradients, rebuilt on the JAX
  side from its rollout, ``compute_gae``, ``_epoch_mix``, ``model.apply``
  and ``_ppo_loss_terms``, within ``GRAD_TOL`` = 1e-5 of the largest
  gradient entry (measured 6e-7: f32 summation order); parameters after
  the step within 2 * lr * E * M absolutely, the most that sign flips of
  ill-conditioned Adam steps could move a weight (the first steps are
  about ``-lr * sign(g)``, so an entry with |g| near eps takes a step
  whose sign f32 noise decides), and, because that bound alone is loose,
  at least 99% of all entries within 1e-6 (measured: all within 5e-8);
  Adam's first moment within ``GRAD_TOL`` of the same scale.
* bf16 model: integer state and key bit-equal (the sampled trajectories
  agree because the port's bf16 forward equals flax's wherever the f32
  sums agree); stats within ``BF16_STATS_TOL`` = 2e-3 (measured 5e-5);
  gradients within ``BF16_GRAD_TOL`` = 5e-2 of the largest entry: the
  backward pass rounds each cotangent to bf16 (2^-8 relative) at every
  layer on both sides, but at other points inside sigmoid (autograd
  differentiates 1/(1+exp(-x)) op by op, JAX uses s*(1-s)) and in
  another summation order; measured 0.4e-2 to 1.8e-2. Parameters within
  2 * lr * E * M (measured 6e-4).
"""

import pytest

from torch_train_parity import (check_train_step_returns_a_new_state,
                                check_whole_train_step_bf16, check_whole_train_step_f32)

FLAVOURS = ["obs", "fused_windows"]


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_whole_train_step_f32(flavour):
    check_whole_train_step_f32(flavour)


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_whole_train_step_bf16(flavour):
    check_whole_train_step_bf16(flavour)


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_train_step_returns_a_new_state(flavour):
    check_train_step_returns_a_new_state(flavour)
