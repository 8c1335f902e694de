"""The port never imports JAX nor the JAX package: with ``jax`` and
``pogema_tpu`` made unimportable, every module of ``pogema_torch``
(walked with ``pkgutil``) and ``chip_smoke`` import."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "pogema_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
import pogema_torch
names = ["pogema_torch"] + [m.name for m in pkgutil.walk_packages(pogema_torch.__path__,
                                                                  "pogema_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for name in ("pogema_v0", "Pogema", "PogemaVectorEnv", "GlobalPlannerPolicy", "BatchAStarAgent"):
    getattr(pogema_torch, name)
print(len(names))
"""


def test_every_port_module_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CODE], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    count = int(out.stdout.split()[-1])
    # the package, its subpackages and the rim's modules, at least
    assert count >= 45, count
