"""``embed_state_windows_occ`` of the port against pogema_tpu's and
against the port's own ``EmbedActorCritic.embed_state_windows``, on the
CPU, on states of a JAX reset with a third of the agents inactive.

Tolerances (``tests/test_torch_models.py``): ``F32_TOL = 1e-5`` in f32
(one GEMM here, three einsums in JAX: f32 summation order), ``BF16_TOL =
1e-2`` in bf16 (a sum in another order may round one bf16 element one
ulp apart), each absolute, and relative where |value| exceeds 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pogema_tpu
from pogema_torch.interop import params_from_flax
from pogema_torch.models.embed_actor_critic import embed_state_windows_occ
from pogema_tpu import models as jm
from pogema_tpu.models.embed_actor_critic import embed_state_windows_occ as jax_occ

F32_TOL = 1e-5
BF16_TOL = 1e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _states(radius, seed, b=4, n=8):
    core = pogema_tpu.PogemaCore(pogema_tpu.GridConfig(size=14, num_agents=n, obs_radius=radius,
                                                       density=0.3, max_episode_steps=16),
                                 num_envs=b, device="cpu")
    st, _ = core.reset(jax.random.key(seed))
    active = np.random.default_rng(seed).random((b, n)) > 0.33
    return (np.asarray(st.obstacles), np.asarray(st.agents_xy), np.asarray(st.targets_xy), active)


def _close(got, want, tol, where):
    got = got.detach().float().numpy()
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(jnp.asarray(want, jnp.float32)))
    assert got.shape == want.shape, (where, got.shape, want.shape)
    err = float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())
    assert err <= tol, f"{where}: max |diff| {err} > {tol}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("radius,embed", [(2, 16), (5, 24)])
def test_embed_state_windows_occ(dtype, radius, embed):
    jd, td, tol = DTYPES[dtype]
    w = 2 * radius + 1
    _, params = jm.init_embed_params(jax.random.key(radius), w, embed=embed, hidden=16)
    p = params["params"]
    arrays = _states(radius, seed=radius + embed)
    args = [torch.as_tensor(a.copy()) for a in arrays]
    kernel = torch.as_tensor(np.array(p["embed_kernel"]))
    bias = torch.as_tensor(np.array(p["embed_bias"]) + 0.01)  # a nonzero bias, rounded as the JAX function rounds it
    got = embed_state_windows_occ(kernel, bias, td, w, *args)
    assert got.dtype == td and got.shape == (4, 8, embed)
    want = jax_occ(jnp.asarray(kernel.numpy()), jnp.asarray(bias.numpy()), jd, w,
                   *(jnp.asarray(a) for a in arrays))
    _close(got, want, tol, "against the JAX function")
    model, _ = params_from_flax(jax.tree_util.tree_map(np.asarray, params), td)
    with torch.no_grad():
        model.embed_bias.copy_(bias)
        pairwise = model.embed_state_windows(*args)
    _close(got, pairwise, tol, "against embed_state_windows")


def test_agents_sharing_a_cell_or_outside_the_grid():
    # The occupancy grid counts agents on a cell, as the pairwise form
    # does; an agent outside the padded grid is seen by nobody, as in K1b.
    w, p, e = 3, 8, 4
    kernel = torch.zeros(3, w * w, e)
    kernel[1, 4, 0] = 1.0  # the centre of the agents block
    kernel[1, 5, 1] = 1.0  # the cell right of the centre
    grid = torch.zeros(1, p, p, dtype=torch.uint8)
    xy = torch.tensor([[[3, 3], [3, 3], [3, 4], [-1, 4]]], dtype=torch.int32)
    active = torch.tensor([[True, True, True, True]])
    got = embed_state_windows_occ(kernel, torch.zeros(e), torch.float32, w, grid, xy, xy, active)
    assert got[0, :, 0].tolist() == [2.0, 2.0, 1.0, 0.0]
    assert got[0, :, 1].tolist() == [1.0, 1.0, 0.0, 0.0]
