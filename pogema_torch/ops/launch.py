"""The one seam between the kernel wrappers and their CUDA entry points.

Every hand-written kernel is reached through a plain C function of
``csrc/<source>.cu`` that returns an int and takes the stream as its last
argument: 0, or the CUDA error of the launch. Its wrapper,
``ops/cuda_<name>.py``, refuses with :func:`check` what the kernel does
not take, returns the plain version (``ops/<name>.py``) for CPU tensors,
and launches for CUDA tensors through a :class:`Kernel`.

Nothing here runs at import: the tests import every module on machines
without nvcc.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# Argument types of the entry points.
PTR, I32, I64, U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong


def bind(source: str, entry: str, *argtypes, restype=I32):
    """The C function ``restype entry(argtypes...)`` (an int unless said)
    of ``csrc/<source>.cu``, built first if need be (:func:`build.load`).
    Bind once and keep it."""
    fn = getattr(build.load(source), entry)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


class Kernel:
    """The launch entry ``int entry(argtypes..., cudaStream_t)`` of
    ``csrc/<source>.cu``, called as ``kernel(device, *args)``: bound at
    the first launch, each launch made on ``device`` and its current
    stream, a nonzero code raised as ``RuntimeError``, and each launch
    counted in ``counter.launches`` (set to 0 here)."""

    def __init__(self, source: str, entry: str, argtypes, name: str, counter):
        self.source, self.entry, self.argtypes = source, entry, (*argtypes, PTR)
        self.name, self.counter = name, counter
        self.fn = None
        counter.launches = 0

    def bind(self):
        self.fn = bind(self.source, self.entry, *self.argtypes)
        return self.fn

    def __call__(self, device, *args) -> None:
        fn = self.fn or self.bind()
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc}")
        self.counter.launches += 1


def check(*inputs) -> None:
    """Refuse what no kernel takes. ``inputs``: (name, tensor, allowed
    dtypes) of each tensor argument. All lie on one device, the CPU or a
    CUDA device (``ValueError``); each has an allowed dtype
    (``TypeError``) and is contiguous (``ValueError``)."""
    device = inputs[0][1].device
    for _, t, _ in inputs:
        if t.device != device or device.type not in ("cpu", "cuda"):
            raise ValueError("all inputs must lie on one device, the CPU or a CUDA device, got "
                             + ", ".join(f"{name}: {t.device}" for name, t, _ in inputs))
    for name, t, dtypes in inputs:
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
