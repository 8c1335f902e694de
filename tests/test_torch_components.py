"""K4's plain version and its wrapper on the CPU.

* The plain version, ``ops/components.py``'s flood fill, equals the JAX
  package's ``connected_components`` on every grid family of
  ``component_grids.py``: Bernoulli maps and sidewinder mazes at P = 74,
  config E's braided pool at P = 138, and the hand-made extremes.
* The wrapper, ``ops/cuda_components.py``, returns the plain version for
  a grid on the CPU, and refuses what the kernel does not take.
* ``core.generator.connected_components`` goes through the wrapper and
  counts the plain version's host-synced sweeps.

The kernel itself runs only on a card: ``test_torch_components_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from component_grids import EXTREMES, grids
from pogema_torch.core import generator
from pogema_torch.ops import components, cuda_components
from pogema_tpu.core import generator as jgen

# (family, P) of the CPU cases: each world kind at its cell's side, the
# extremes at a side past one chunk of 32 cells and at D's and E's sides.
CASES = ([("random", 74), ("sidewinder", 74), ("pool", 138)]
         + [(name, p) for name in EXTREMES for p in (1, 2, 37, 74)]
         + [("spiral", 138)])


def _jax_labels(grid):
    return np.asarray(jax.vmap(jgen.connected_components)(jnp.asarray(grid)))


@pytest.mark.parametrize("family,p", CASES)
def test_plain_version_equals_jax(family, p):
    grid = grids(family, 3, p, seed=p)
    got = components.connected_components(torch.as_tensor(grid))
    assert got.dtype == torch.int64 and got.shape == (3, p * p)
    np.testing.assert_array_equal(got.numpy(), _jax_labels(grid))


@pytest.mark.parametrize("family", ["pool", "spiral"])
def test_wrapper_on_the_cpu_returns_the_plain_version(family):
    grid = torch.as_tensor(grids(family, 2, 74, seed=1))
    before = components.connected_components.sweeps
    want = components.connected_components(grid)
    sweeps = components.connected_components.sweeps - before
    got = cuda_components.connected_components(grid)
    assert torch.equal(got, want)
    assert components.connected_components.sweeps - before == 2 * sweeps
    # A bool grid is the same grid.
    assert torch.equal(cuda_components.connected_components(grid.bool()), want)


def test_core_goes_through_the_wrapper_and_counts_sweeps(monkeypatch):
    calls = []
    wrapper = cuda_components.connected_components

    def spy(grid):
        calls.append(grid)
        return wrapper(grid)

    monkeypatch.setattr(cuda_components, "connected_components", spy)
    grid = torch.as_tensor(grids("spiral", 2, 37))
    before, plain_before = generator.connected_components.sweeps, components.connected_components.sweeps
    got = generator.connected_components(grid)
    assert len(calls) == 1
    sweeps = generator.connected_components.sweeps - before
    assert sweeps == components.connected_components.sweeps - plain_before > 2
    np.testing.assert_array_equal(got.numpy(), _jax_labels(grid.numpy()))


def test_an_empty_batch():
    got = cuda_components.connected_components(torch.zeros(0, 5, 5, dtype=torch.uint8))
    assert got.shape == (0, 25) and got.dtype == torch.int64


GOOD = torch.as_tensor(grids("random", 2, 12))
REFUSALS = {
    "dtype int32": (TypeError, GOOD.to(torch.int32)),
    "dtype float": (TypeError, GOOD.to(torch.float32)),
    "device meta": (ValueError, GOOD.to("meta")),
    "not contiguous": (ValueError, GOOD.transpose(1, 2)),
    "not square": (ValueError, GOOD[:, :, :11].contiguous()),
    "not 3-D": (ValueError, GOOD[0]),
    "no cells": (ValueError, torch.zeros(2, 0, 0, dtype=torch.uint8)),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_wrapper_refuses(name):
    error, grid = REFUSALS[name]
    with pytest.raises(error):
        cuda_components.connected_components(grid)
