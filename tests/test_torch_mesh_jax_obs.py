"""Two train steps of the port's 'obs' flavour over gloo meshes of CPU
processes (data = 2, data = 4, data = 2 x model = 2, the last with the
trunk and GRU gates split over 'model') against the JAX package's
unsharded step and its step on the same mesh of virtual devices; the
harness, its tolerances and the reason for one module per flavour are in
``torch_mesh_jax.py``."""

import pytest

from torch_mesh_jax import CASES, REFERENCES, check_against, runs

FLAVOUR = "obs"


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return runs(FLAVOUR, tmp_path_factory)


@pytest.mark.parametrize("reference", REFERENCES)
@pytest.mark.parametrize("case", CASES)
def test_meshed_steps_equal_jax(both, case, reference):
    port, jax_runs = both
    check_against(FLAVOUR, port[case], jax_runs[case, reference], case, reference)
