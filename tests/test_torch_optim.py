"""The port's optimizer against optax, on the CPU.

The same numpy gradients go through ``optax.chain(clip_by_global_norm,
adam)`` and ``pogema_torch.parallel.optim`` for several steps, with the
global norm both under and over ``max_norm``. Tolerance: 1e-6 relative to
the largest magnitude of each leaf, on updates, parameters and both
moments (the float ops are in optax's order, so what differs is the last
bit of ``pow`` and ``sqrt``); the step count is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pogema_torch.interop import opt_state_from_optax, opt_state_to_numpy
from pogema_torch.parallel import optim

REL_TOL = 1e-6
SHAPES = {"embed_kernel": (3, 25, 16), "embed_bias": (16,), "trunk": {"kernel": (16, 24),
                                                                      "bias": (24,)}}


def _tree(rng, scale):
    def make(shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {k: ({n: make(s) for n, s in v.items()} if isinstance(v, dict) else make(v))
            for k, v in SHAPES.items()}


def _flat(tree):
    """The port's names of this nest (Dense kernels transposed)."""
    return {"embed_kernel": tree["embed_kernel"], "embed_bias": tree["embed_bias"],
            "trunk.weight": tree["trunk"]["kernel"].T, "trunk.bias": tree["trunk"]["bias"]}


def _assert_close(got: dict, want_tree, what):
    want = _flat(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(g - want[k]).max()) / scale
        assert err <= REL_TOL, f"{what} {k}: relative error {err}"


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0, 30.0], ids=["under", "mixed", "over"])
def test_chain_matches_optax(grad_scale):
    rng = np.random.default_rng(0)
    max_norm, lr = 0.5, 3e-4
    params = _tree(rng, 0.1)
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    topt = optim.Optimizer(lr=lr, max_norm=max_norm)
    tparams = {k: torch.tensor(v) for k, v in _flat(params).items()}
    tstate = topt.init(tparams)
    seen = set()
    for step in range(5):
        scale = grad_scale * (0.005 if grad_scale == 1.0 and step % 2 else 1.0)
        grads = _tree(rng, scale)
        norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                 for g in _flat(grads).values())))
        seen.add(norm < max_norm)
        jupd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tupd, tstate = topt.update({k: torch.tensor(v) for k, v in _flat(grads).items()}, tstate)
        tparams = {k: p + tupd[k] for k, p in tparams.items()}
        adam = jstate[1][0]
        assert int(tstate["count"]) == int(adam.count) == step + 1
        _assert_close(tupd, jupd, f"step {step} update")
        _assert_close(tparams, jparams, f"step {step} params")
        _assert_close(tstate["mu"], adam.mu, f"step {step} mu")
        _assert_close(tstate["nu"], adam.nu, f"step {step} nu")
    assert seen == ({True} if grad_scale == 1e-3 else {False} if grad_scale == 30.0
                    else {True, False})


def test_clip_is_optax_rule_not_torch():
    """Over the limit the gradient is scaled by max_norm / norm exactly
    (no 1e-6 in the denominator); under it, returned unchanged."""
    g = {"a": torch.tensor([3.0, 4.0])}
    out = optim.clip_by_global_norm(g, 0.5)["a"]
    assert torch.equal(out, (g["a"] / 5.0) * 0.5)
    assert float(optim.global_norm(g)) == 5.0
    small = {"a": torch.tensor([0.03, 0.04])}
    assert torch.equal(optim.clip_by_global_norm(small, 0.5)["a"], small["a"])


def test_update_returns_new_tensors_and_state_round_trips():
    params = {"w": torch.ones(3)}
    opt = optim.Optimizer(lr=1e-2, max_norm=0.5)
    s0 = opt.init(params)
    upd, s1 = opt.update({"w": torch.tensor([1.0, -2.0, 0.5])}, s0)
    assert int(s0["count"]) == 0 and not s0["mu"]["w"].any() and int(s1["count"]) == 1
    # The first Adam step is -lr * sign(g) up to eps.
    np.testing.assert_allclose(upd["w"].numpy(), [-1e-2, 1e-2, -1e-2], rtol=1e-5)
    # Through the numpy carrier and back (flax layout of the moments).
    adam = {"count": np.int32(7), "mu": {"params": {"d": {"kernel": np.ones((2, 3), np.float32)}}},
            "nu": {"params": {"d": {"kernel": np.full((2, 3), 2.0, np.float32)}}}}
    st = opt_state_from_optax(adam, "cpu")
    assert st["mu"]["d.weight"].shape == (3, 2) and int(st["count"]) == 7
    back = opt_state_to_numpy(st)
    np.testing.assert_array_equal(back["nu"]["params"]["d"]["kernel"], adam["nu"]["params"]["d"]["kernel"])
    assert int(back["count"]) == 7
