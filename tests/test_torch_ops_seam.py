"""The kernel seam of ``pogema_torch/ops``: ctypes and the launch live in
``ops/launch.py`` (and ``ops/build.py``), ``ops`` never reaches into
``core``, ``core/collisions.py`` leaves the device choice to K2's wrapper,
and every wrapper refuses the same faults with the same exception types.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collision_cases import scenario
from pogema_torch import GridConfig
from pogema_torch.core import collisions as core_collisions
from pogema_torch.ops import collisions as ops_collisions
from pogema_torch.ops import cuda_collisions, cuda_threefry, cuda_windows
from pogema_tpu.core import collisions as jcol

PACKAGE = Path(__file__).resolve().parents[1] / "pogema_torch"


def _imports(path):
    """(module, level, names) of every import statement of a file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, 0, ()
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level, tuple(a.name for a in node.names)


def test_ctypes_only_in_build_and_launch():
    users = sorted(str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")
                   if any(m.split(".")[0] == "ctypes" and lvl == 0 for m, lvl, _ in _imports(p)))
    assert users == ["ops/build.py", "ops/launch.py"]


def test_ops_imports_nothing_of_core():
    for path in (PACKAGE / "ops").glob("*.py"):
        for module, level, names in _imports(path):
            absolute = level == 0 and module.startswith("pogema_torch.core")
            relative = level == 2 and (module.split(".")[0] == "core"
                                       or (not module and "core" in names))
            assert not (absolute or relative), (path.name, module, level, names)


def test_core_collisions_makes_no_device_test():
    tree = ast.parse((PACKAGE / "core" / "collisions.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr != "is_cuda", ast.unparse(node)
            assert not (node.attr == "type" and isinstance(node.value, ast.Attribute)
                        and node.value.attr == "device"), ast.unparse(node)


def test_core_fixpoint_is_the_plain_modules():
    assert core_collisions.fixpoint is ops_collisions.fixpoint
    assert core_collisions.propose is ops_collisions.propose


def test_priority_on_the_cpu_goes_through_the_wrapper(monkeypatch):
    calls = []
    wrapper = cuda_collisions.resolve_priority

    def spy(*args):
        calls.append(args)
        return wrapper(*args)

    monkeypatch.setattr(cuda_collisions, "resolve_priority", spy)
    grid, xy, active, actions = scenario("crowded", 64, seed=3)
    cfg = GridConfig(num_agents=64, collision_system="priority").to_static()
    passes = core_collisions.fixpoint.passes
    got = core_collisions.resolve_moves(cfg, *map(torch.as_tensor, (grid, xy, active, actions)))
    assert len(calls) == 1
    assert core_collisions.fixpoint.passes > passes
    want = jax.vmap(jcol.resolve_priority)(*map(jnp.asarray, (grid, xy, active, actions)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got != torch.as_tensor(xy)).any())


def _windows_inputs():
    g = torch.Generator().manual_seed(0)
    grid = (torch.rand(2, 10, 10, generator=g) < 0.3).to(torch.uint8)
    xy = torch.randint(0, 10, (2, 4, 2), generator=g, dtype=torch.int32)
    return [grid, xy, xy.clone(), torch.ones(2, 4, dtype=torch.bool)]


# Each wrapper: (a call on its inputs, good inputs, the input to spoil).
WRAPPERS = {
    "K1": (lambda a: cuda_windows.extract_windows_packed(*a, 5), lambda: _windows_inputs()[:2], 1),
    "K1b": (lambda a: cuda_windows.packed_observation_cuda(*a, 5), _windows_inputs, 0),
    "K7": (lambda a: cuda_threefry.bits(a[0], (3,)),
           lambda: [torch.arange(8, dtype=torch.int64).reshape(4, 2)], 0),
    "K2": (lambda a: cuda_collisions.resolve_priority(*a),
           lambda: list(map(torch.as_tensor, scenario("crowded", 8))), 3),
}
FAULTS = {
    "devices_differ": (ValueError, lambda t: t.to("meta")),
    "wrong_dtype": (TypeError, lambda t: t.to(torch.float32)),
    "not_contiguous": (ValueError, lambda t: torch.stack([t, t], -1)[..., 0]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_every_wrapper_refuses_alike(wrapper, fault):
    call, good, spoil = WRAPPERS[wrapper]
    error, make = FAULTS[fault]
    args = good()
    call(args)  # the good inputs pass
    args[spoil] = make(args[spoil])
    with pytest.raises(error):
        call(args)
