"""The port's mesh (``pogema_torch.parallel.mesh``), its tensor-parallel
layout (``models.partition_params``) and the offset draws of
``core.random``, in one process.

A mesh of 8 ranks is made in this one process with torch's fake process
group (``torch.testing._internal.distributed.fake_pg``: a rank that joins
no peer and runs no collective), once for each rank, so that every
rank's rows and shards are held against the ``addressable_shards`` of
the JAX package's ``shard_batch`` and ``partition_params`` on the 8
virtual devices of ``conftest.py`` at the same mesh coordinate. All
comparisons are exact.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from pogema_torch.core import random as jr
from pogema_torch.interop import state_from_flax
from pogema_torch.models import gather_params, partition_params
from pogema_torch.parallel import (batch_sharding, global_batch_from_host, make_mesh,
                                   replicated, shard_batch)
from pogema_tpu import models as jm
from pogema_tpu.parallel import make_mesh as jax_make_mesh
from pogema_tpu.parallel import shard_batch as jax_shard_batch
from torch_parity import make_cores, np_tree


def _as_rank(rank, world=8):
    """Join a fake world of ``world`` ranks as ``rank``."""
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


@pytest.fixture
def no_group():
    """No process group before or after the test."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_shard_of(arr, jmesh, d, m):
    """The addressable shard of ``arr`` on the device at mesh (d, m)."""
    dev = jmesh.devices[d, m]
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)


def test_make_mesh_in_a_lone_process(no_group):
    mesh = make_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    assert dist.get_world_size() == 1
    with pytest.raises(AssertionError, match="2x1 != 1 devices"):
        make_mesh(data=2, device="cpu")
    with pytest.raises(AssertionError):
        make_mesh(model=2, device="cpu")


@pytest.mark.parametrize("data, model, shape", [(-1, 1, (8, 1)), (4, 2, (4, 2)),
                                                (-1, 4, (2, 4)), (1, 8, (1, 8))])
def test_make_mesh_shapes(no_group, data, model, shape):
    for rank in (0, 5, 7):
        _as_rank(rank)
        mesh = make_mesh(data=data, model=model, device="cpu")
        assert mesh.shape == shape
        assert mesh.get_local_rank("data") == rank // shape[1]
        assert mesh.get_local_rank("model") == rank % shape[1]
    with pytest.raises(AssertionError, match="3x2 != 8 devices"):
        make_mesh(data=3, model=2, device="cpu")
    with pytest.raises(AssertionError):
        make_mesh(model=3, device="cpu")


def test_placements(no_group):
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_mesh(device="cpu")
    assert batch_sharding(mesh) == (Shard(0), Replicate())
    assert replicated(mesh) == (Replicate(), Replicate())


@pytest.mark.parametrize("data, model", [(8, 1), (4, 2), (2, 4)])
def test_shard_batch_rows_equal_jax_shards(no_group, data, model):
    """Each rank's rows of a reset state (every leaf, the key and the
    LifeLong goal queue included) and of its observations are the JAX
    shard on the device at the same mesh coordinate, by shard_batch and by
    global_batch_from_host alike; scalars stay whole."""
    grid = dict(seed=0, size=8, density=0.2, num_agents=2, obs_radius=2, max_episode_steps=8,
                on_target="restart")
    jc, tc = make_cores(grid, 16)
    jstate, jobs = jc.reset(3)
    tstate, tobs = tc.reset(3)
    jmesh = jax_make_mesh(data=data, model=model)
    with jmesh:
        jsh_state = jax_shard_batch(jstate, jmesh)
        jsh_obs = jax_shard_batch(jobs, jmesh)
    host = {k: v.numpy() for k, v in tstate.tensors().items()}
    for rank in range(8):
        _as_rank(rank)
        mesh = make_mesh(data=data, model=model, device="cpu")
        d, m = rank // model, rank % model
        rows = shard_batch({"state": tstate, "obs": tobs, "scalar": torch.tensor(7)}, mesh)
        from_host = global_batch_from_host(host, mesh)
        assert int(rows["scalar"]) == 7
        for name in host:
            leaf = getattr(jsh_state, name)
            if name == "key":
                leaf = jax.random.key_data(leaf)
            want = _jax_shard_of(leaf, jmesh, d, m)
            got = getattr(rows["state"], name)
            assert got.shape[0] == 16 // data, name
            np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype),
                                          err_msg=f"{name} rank {rank}")
            np.testing.assert_array_equal(from_host[name].numpy(), got.numpy(), err_msg=name)
        np.testing.assert_array_equal(rows["obs"].numpy(), _jax_shard_of(jsh_obs, jmesh, d, m))


@pytest.mark.parametrize("family", ["conv", "fused", "recurrent"])
@pytest.mark.parametrize("data, model", [(4, 2), (2, 4), (8, 1)])
def test_partition_params_equal_jax_shards(no_group, family, data, model):
    """The rank's shard of every parameter is the JAX shard of the same
    leaf on the device at its mesh coordinate, carried to torch's layout
    (flax's [in, out] kernel split over columns is the [out, in] weight
    split over rows); gather_params undoes the partition."""
    from pogema_tpu.models import partition_params as jax_partition_params

    key = jax.random.key(0)
    if family == "conv":
        _, params = jm.init_params(key, 5, hidden=32, channels=4)
    elif family == "recurrent":
        _, params = jm.init_recurrent_params(key, 5, embed=32, hidden=32)
    else:
        _, params = jm.init_embed_params(key, 5, embed=32, hidden=32)
    full = {k: torch.as_tensor(v) for k, v in state_from_flax(np_tree(params)).items()}
    jmesh = jax_make_mesh(data=data, model=model)
    with jmesh:
        jparts = jax_partition_params(params, jmesh)
    for rank in range(8):
        _as_rank(rank)
        mesh = make_mesh(data=data, model=model, device="cpu")
        d, m = rank // model, rank % model
        shards = jax.tree.map(lambda a: _jax_shard_of(a, jmesh, d, m), jparts)
        want = state_from_flax(shards)
        got = partition_params(full, mesh)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=f"{k} rank {rank}")
        split = {k for k in full if got[k].shape != full[k].shape}
        expect = {k for k in full if k.split(".")[0] in ("trunk", "gru")} if model > 1 else set()
        assert split == expect
    # A whole round trip needs the collective: the world of one.
    dist.destroy_process_group()
    mesh = make_mesh(device="cpu")
    back = gather_params(partition_params(full, mesh), mesh)
    assert all(torch.equal(back[k], full[k]) for k in full)


# -- offset draws ---------------------------------------------------------------


def _slices(fn, rows, parts):
    step = rows // parts
    return torch.cat([fn(lo, step) for lo in range(0, rows, step)])


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_offset_draws_are_slices_of_the_global_draw(parts):
    """Rows [lo, hi) of a draw over [B, ...], made alone with offset lo *
    (elements per row), are bit-equal to those rows of the global draw:
    bits, uniform (and a shifted range), gumbel, categorical and split;
    the global draws equal jax.random's."""
    key = jr.key(11)
    b, n = 8, 6
    shape = (b, n, 5)
    row = n * 5
    cases = {
        "bits": (lambda: jr.bits(key, shape),
                 lambda lo, k: jr.bits(key, (k, n, 5), offset=lo * row)),
        "uniform": (lambda: jr.uniform(key, shape, -2.0, 3.0),
                    lambda lo, k: jr.uniform(key, (k, n, 5), -2.0, 3.0, offset=lo * row)),
        "gumbel": (lambda: jr.gumbel(key, shape),
                   lambda lo, k: jr.gumbel(key, (k, n, 5), offset=lo * row)),
        "split": (lambda: jr.split(key, b),
                  lambda lo, k: jr.split(key, k, offset=lo)),
    }
    for name, (whole, part) in cases.items():
        assert torch.equal(whole(), _slices(part, b, parts)), name
    logits = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    whole = jr.categorical(key, logits)
    part = _slices(lambda lo, k: jr.categorical(key, logits[lo:lo + k], offset=lo * row),
                   b, parts)
    assert torch.equal(whole, part)
    jkey = jax.random.key(11)
    np.testing.assert_array_equal(jr.bits(key, shape).numpy(),
                                  np.asarray(jax.random.bits(jkey, shape)).astype(np.int64))
    np.testing.assert_array_equal(
        whole.numpy(), np.asarray(jax.random.categorical(jkey, logits.numpy())))
    np.testing.assert_array_equal(jr.split(key, b).numpy(),
                                  np.asarray(jax.random.key_data(jax.random.split(jkey, b))))
