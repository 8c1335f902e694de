"""Import guards, the refusals of run.py, and where a run writes."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.BENCH


def _imports(path):
    """Top-level names of every module a source file imports (relative
    imports resolved inside the benchmark's folder are left out)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(folder):
    return [p for p in folder.rglob("*.py") if "__pycache__" not in p.parts]


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["pogema_torch.core", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["jax.numpy", "pogema_tpu", "optax._src"]) == [
        "jax", "optax", "pogema_tpu"]


def _run_sources():
    """Every source a run of the benchmark can load: all but the test
    modules (``tests/test_*.py``), which may hold the reference against
    the JAX package."""
    return [p for p in _sources(BENCH)
            if not (p.parent.name == "tests" and p.name.startswith("test_"))]


@pytest.mark.parametrize("path", _run_sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_of_the_benchmark_imports_the_jax_stack(path):
    assert not set(_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", _sources(BENCH / "reference"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "pogema_torch" not in set(_imports(path))


def test_nothing_forbidden_is_loaded_after_a_cell_is_set_up_and_run():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "from portbench.tests import tiny\n"
            "for name in ('C.random', 'D.serve', 'D.train'):\n"
            "    tiny.run(tiny.cell(name), seconds=0.05)\n"
            "print(json.dumps(harness.forbidden_modules()))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run_py(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "C.random",
                           "--seed", "5", "--seconds", "1", "--trace", "0", *extra],
                          capture_output=True, text=True, cwd=cwd, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_refuses_without_a_card_and_prints_no_result():
    out = _run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # Past the look for a card, set-up needs the program, which is absent.
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench import harness\n"
            "cell = harness.Cell(harness.load_manifest(), 'C.random')\n"
            "harness.measure(harness.Context(cell, 5, 'cpu', False), 0.1, 0.0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and "pogema_torch" in out.stderr


def test_caches_live_at_fixed_paths_inside_the_checkout():
    code = ("import os, runpy, sys\n"
            "sys.argv = ['run.py']\n"
            "runpy.run_path('portbench/run.py', run_name='not_main')\n"
            "print(os.environ['TORCH_EXTENSIONS_DIR']); print(os.environ['TRITON_CACHE_DIR'])\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=60)
    dirs = out.stdout.split()
    assert dirs == [str(ROOT / "build" / "portbench" / "torch_extensions"),
                    str(ROOT / "build" / "portbench" / "triton")]


def test_ranks_keep_out_of_dev_shm_and_log_inside_the_checkout():
    src = (BENCH / "harness.py").read_text()
    assert 'NCCL_SHM_DISABLE="1"' in src
    assert 'ROOT / "build" / "portbench" / "ranks"' in src
