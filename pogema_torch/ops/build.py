"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so`` at the
root of the checkout, compiled for ``sm_90a`` with a plain C entry point
(no PyTorch headers, so a build takes seconds). The hash covers the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. ``build_all`` starts one nvcc per source at once, and
:func:`load` builds every source that is not built yet in one such call,
so a checkout's first run waits for one parallel build, not one per
kernel.

Nothing here runs at import: the tests import every module on machines
without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("collisions", "components", "placement", "policy", "threefry", "windows")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names) -> dict:
    """Compile every named source that is not built yet, all nvcc
    processes at once. Returns ``{name: ptxas report}`` for the sources
    compiled by this call; raises with nvcc's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it, and every
    other source of :data:`SOURCES` not built yet, if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build_all(dict.fromkeys((name, *SOURCES)))
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib
