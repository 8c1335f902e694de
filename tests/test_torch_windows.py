"""Windows and observations of pogema_torch against pogema_tpu.

The plain windows against ``ops/windows.py`` and the Pallas kernel
(interpret mode, as tests/test_pallas_windows.py runs it), the agents and
target channels, and ``observe`` in every type and layout: all
bit-equal. The K1 CUDA kernel against its plain version needs a card
(marker ``cuda``) and skips without one; the packed observation as a
whole (K1b) is in ``test_torch_packed_obs.py``.
"""

from functools import partial

import numpy as np
import pytest
import torch

import pogema_torch.grid_config as tgc
from pogema_torch.core import obs as tobs
from pogema_torch.ops import cuda_windows
from pogema_torch.ops import windows as tw

try:
    import jax
    import jax.numpy as jnp

    import pogema_tpu.core.obs as jobs
    import pogema_tpu.grid_config as jgc
    from pogema_tpu.ops import windows as jw
    from pogema_tpu.ops.pallas_windows import extract_windows_packed as pallas_packed
    from torch_parity import assert_trees_equal
except ImportError:  # a GPU machine without the JAX package's dependencies
    jax = None


@pytest.fixture
def ref():
    """The JAX reference; the card's machine may lack it and then runs
    only the card test of this file."""
    if jax is None:
        pytest.skip("the JAX package (jax, flax) is not installed")


def _inputs(seed, b=3, p=20, n=6, margin=3):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 2, size=(b, p, p)).astype(np.uint8)
    xy = rng.integers(margin, p - margin, size=(b, n, 2)).astype(np.int32)
    return grid, xy


@pytest.mark.parametrize("w", [1, 3, 5, 7, 11])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_windows_matches_jax(seed, w, ref):
    grid, xy = _inputs(seed, margin=w // 2)
    got = tw.extract_windows(torch.as_tensor(grid), torch.as_tensor(xy), w)
    want = jax.vmap(lambda g, c: jw.extract_windows(g, c, w))(jnp.asarray(grid), jnp.asarray(xy))
    assert_trees_equal(want, got)


def test_extract_windows_off_grid_reads_zero(ref):
    # The one-hot form gives 0 for rows/cols outside the grid.
    grid, xy = _inputs(5, p=12)
    xy[:, :3] = np.array([[0, 0], [11, 11], [0, 11]], np.int32)
    got = tw.extract_windows(torch.as_tensor(grid), torch.as_tensor(xy), 5)
    want = jax.vmap(lambda g, c: jw.extract_windows(g, c, 5))(jnp.asarray(grid), jnp.asarray(xy))
    assert_trees_equal(want, got)


def test_neighborhoods3x3_matches_jax(ref):
    # Exported from both ops packages; centres on the grid's edge read 0 outside.
    from pogema_torch.ops import neighborhoods3x3

    grid, xy = _inputs(7, p=10, margin=0)
    got = neighborhoods3x3(torch.as_tensor(grid), torch.as_tensor(xy))
    want = jax.vmap(jw.neighborhoods3x3)(jnp.asarray(grid), jnp.asarray(xy))
    assert got.shape == (3, 6, 3, 3)
    assert_trees_equal(want, got)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("w", [3, 5, 11])
def test_packed_ref_matches_pallas_interpret(seed, w, ref):
    grid, xy = _inputs(seed, b=2, p=24, n=5, margin=w // 2)
    want = pallas_packed(jnp.asarray(grid), jnp.asarray(xy), w, interpret=True)
    got = tw.extract_windows_packed_ref(torch.as_tensor(grid), torch.as_tensor(xy), w)
    assert_trees_equal(want, got)
    # On CPU tensors the kernel's wrapper is its plain version.
    before = cuda_windows.extract_windows_packed.launches
    cpu = cuda_windows.extract_windows_packed(torch.as_tensor(grid), torch.as_tensor(xy), w)
    assert torch.equal(cpu, got) and cuda_windows.extract_windows_packed.launches == before


def test_packed_lanes_past_128(ref):
    grid, xy = _inputs(3, p=30, margin=6)
    out = tw.extract_windows_packed_ref(torch.as_tensor(grid), torch.as_tensor(xy), 13)
    assert out.shape == (3, 6, 256) and tw.packed_lanes(11) == 128
    assert (out[..., 169:] == 0).all()
    want = jax.vmap(lambda g, c: jw.extract_windows(g, c, 13))(jnp.asarray(grid), jnp.asarray(xy))
    np.testing.assert_array_equal(out[..., :169].reshape(3, 6, 13, 13).numpy(), np.asarray(want))


@pytest.mark.parametrize("w", [3, 5, 9])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_agent_windows_matches_jax(seed, w, ref):
    rng = np.random.default_rng(seed)
    b, n, p = 4, 9, 10
    cells = np.stack([rng.choice(p * p, n, replace=False) for _ in range(b)])
    xy = np.stack([cells // p, cells % p], -1).astype(np.int32)
    active = rng.random((b, n)) < 0.7
    got = tw.pairwise_agent_windows(torch.as_tensor(xy), torch.as_tensor(active), w)
    want = jax.vmap(lambda c, a: jw.pairwise_agent_windows(c, a, w))(jnp.asarray(xy), jnp.asarray(active))
    assert_trees_equal(want, got)


@pytest.mark.parametrize("r", [1, 2, 5])
def test_target_channel_matches_jax(r, ref):
    rng = np.random.default_rng(r)
    b, n = 3, 7
    agents = rng.integers(0, 30, (b, n, 2)).astype(np.int32)
    targets = rng.integers(0, 30, (b, n, 2)).astype(np.int32)
    jcfg = jgc.GridConfig(size=20, num_agents=n, obs_radius=r).to_static()
    tcfg = tgc.GridConfig(size=20, num_agents=n, obs_radius=r).to_static()
    want = jax.vmap(partial(jobs.target_channel, jcfg))(jnp.asarray(agents), jnp.asarray(targets))
    got = tobs.target_channel(tcfg, torch.as_tensor(agents), torch.as_tensor(targets))
    assert_trees_equal(want, got)


def _static(mod, obs_type, layout, r=2, size=9, n=6):
    cfg = mod.GridConfig(size=size, num_agents=n, obs_radius=r, observation_type=obs_type).to_static()
    kv = {k: getattr(cfg, k) for k in mod.StaticConfig.__slots__}
    kv["obs_layout"] = layout
    return mod.StaticConfig(**kv)


@pytest.mark.parametrize("obs_type,layout", [("default", "grid"), ("default", "packed"),
                                              ("POMAPF", "grid"), ("MAPF", "grid"),
                                              ("MAPF", "packed")])
def test_observe_matches_jax(obs_type, layout, ref):
    rng = np.random.default_rng(11)
    b, n, r, size = 3, 6, 2, 9
    p = size + 2 * r
    grid = np.ones((b, p, p), np.uint8)
    grid[:, r:r + size, r:r + size] = rng.integers(0, 2, (b, size, size))
    cells = np.stack([rng.choice(size * size, 2 * n, replace=False) for _ in range(b)])
    xy = (np.stack([cells // size, cells % size], -1) + r).astype(np.int32)
    agents, targets = xy[:, :n], xy[:, n:]
    active = rng.random((b, n)) < 0.8
    jcfg = _static(jgc, obs_type, layout)
    tcfg = _static(tgc, obs_type, layout)
    want = jax.vmap(partial(jobs.observe, jcfg))(
        jnp.asarray(grid), jnp.asarray(agents), jnp.asarray(targets), jnp.asarray(active))
    got = tobs.observe(tcfg, torch.as_tensor(grid), torch.as_tensor(agents),
                       torch.as_tensor(targets), torch.as_tensor(active))
    assert_trees_equal(want, got)


@pytest.mark.cuda
def test_k1_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    kernel = cuda_windows.extract_windows_packed
    # (128, 74, 128): the recurrent update's batch, every env split over
    # several blocks; (5, 13, 3): grids that start at every byte alignment.
    for w, (b, p, m) in ((3, (8, 20, 5)), (5, (64, 40, 37)), (11, (256, 74, 128)), (13, (16, 50, 9)),
                         (11, (128, 74, 128)), (11, (5, 13, 3))):
        g = torch.Generator().manual_seed(w)
        grid = (torch.rand(b, p, p, generator=g) < 0.3).to(torch.uint8)
        xy = torch.randint(0, p, (b, m, 2), generator=g, dtype=torch.int32)
        want = tw.extract_windows_packed_ref(grid, xy, w)
        for centres in (None, 1, min(5, m)):
            before = kernel.launches
            got = (kernel(grid.cuda(), xy.cuda(), w) if centres is None
                   else cuda_windows._launch_windows(grid.cuda(), xy.cuda(), w, centres))
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            assert torch.equal(got.cpu(), want), (w, b, p, m, centres)
    with pytest.raises(TypeError):
        kernel(grid.cuda().float(), xy.cuda(), 13)
    with pytest.raises(ValueError):
        kernel(grid.cuda(), xy.cuda()[:, ::2], 13)
