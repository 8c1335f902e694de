"""The threefry2x32-20 hash in CUDA for Hopper: K7.

The kernel lives in ``csrc/threefry.cu`` (design and bound in its source
note), is built with nvcc at first use and called through ctypes. It
serves ``core/random.py``'s two hash sites in one launch each:

* :func:`split` (``jax.random.split``) and :func:`bits` (``jax.random.bits``,
  under ``uniform``, ``gumbel``, ``categorical``, ``bernoulli`` and
  ``randint``) hash the flat counters ``offset + j`` of each key's draw;
* :func:`fold_in` hashes the counter words ``(0, data mod 2**32)``: a
  scalar ``data`` is split's counter ``data mod 2**32`` of each key, per-key
  data is the kernel's third layout.

For keys on the CPU each returns its plain version (``ops/threefry.py``);
for CUDA keys it launches the kernel or raises. Either way it first
refuses what the kernel does not take: keys that are not a contiguous
int64 ``[..., 2]``, a negative offset, ``fold_in`` data on another device
or of a shape that does not broadcast to the keys' batch (data that is
not a tensor is made one on the keys' device first). So a caller's fault
shows on the CPU too. ``threefry_cuda.launches`` counts the
launches. Every output holds u32 values in int64, as the plain version's.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .threefry import M32, bits_ref, fold_in_ref, split_ref

# Output layouts of the kernel (csrc/threefry.cu).
SPLIT, BITS, FOLD_IN = 0, 1, 2

_fns: dict = {}


def _lib() -> dict:
    if not _fns:
        fn = build.load("threefry").pogema_threefry
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
            ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["pogema_threefry"] = fn
    return _fns


def _check_keys(keys: torch.Tensor, offset: int = 0) -> None:
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"keys must lie on the CPU or a CUDA device, got {keys.device}")
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {keys.dtype}")
    if keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be [..., 2], got {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if offset < 0:
        raise ValueError(f"offset must be at least 0, got {offset}")


def threefry_cuda(keys: torch.Tensor, out: torch.Tensor, numel: int, layout: int,
                  offset: int = 0, data=None) -> torch.Tensor:
    """One K7 launch into ``out`` on checked CUDA inputs: ``numel``
    counters a key from ``offset`` (``layout`` SPLIT or BITS), or the
    fold-in of ``data`` (int64, one a key; FOLD_IN)."""
    rows = keys.numel() // 2
    if rows * numel == 0:  # nothing to launch (and nothing counted)
        return out
    fn = _lib()["pogema_threefry"]
    with torch.cuda.device(keys.device):
        rc = fn(keys.data_ptr(), None if data is None else data.data_ptr(), out.data_ptr(),
                rows, numel, offset, layout, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"threefry_kernel launch failed: CUDA error {rc}")
    threefry_cuda.launches += 1
    return out


threefry_cuda.launches = 0


def split(keys: torch.Tensor, num: int, offset: int = 0) -> torch.Tensor:
    """``[..., 2]`` -> ``[..., num, 2]``: keys ``[offset, offset + num)``
    of a larger split."""
    _check_keys(keys, offset)
    if keys.device.type == "cpu":
        return split_ref(keys, num, offset)
    out = torch.empty((*keys.shape[:-1], num, 2), dtype=torch.int64, device=keys.device)
    return threefry_cuda(keys, out, num, SPLIT, offset)


def bits(keys: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """``[..., 2]`` -> ``[..., *shape]``: the XOR of the two output words
    of counters ``offset + j``, j the flat index of an element of
    ``shape``."""
    _check_keys(keys, offset)
    shape = tuple(int(d) for d in shape)
    if keys.device.type == "cpu":
        return bits_ref(keys, shape, offset)
    out = torch.empty((*keys.shape[:-1], *shape), dtype=torch.int64, device=keys.device)
    return threefry_cuda(keys, out, math.prod(shape), BITS, offset)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``[..., 2]`` -> ``[..., 2]``: each key folded with ``data``, an int,
    or integers (a tensor on the keys' device, or a sequence) that
    broadcast to the keys' batch ``keys.shape[:-1]``."""
    _check_keys(keys)
    batch = keys.shape[:-1]
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(data, dtype=torch.int64)
        if data.dim() == 0 and keys.device.type == "cuda":
            # The counter words (0, data mod 2**32) are split's counter
            # data mod 2**32: one launch, no copy of data to the card.
            return split(keys, 1, int(data) & M32)[..., 0, :]
        data = data.to(keys.device)
    if data.device != keys.device:
        raise ValueError(f"data must lie on the keys' device {keys.device}, got {data.device}")
    if data.is_floating_point() or data.is_complex() or data.dtype == torch.bool:
        raise TypeError(f"data must be an integer tensor, got {data.dtype}")
    try:
        fits = torch.broadcast_shapes(data.shape, batch) == batch
    except RuntimeError:
        fits = False
    if not fits:
        raise ValueError(f"data of shape {tuple(data.shape)} does not broadcast to the keys' "
                         f"batch {tuple(batch)}")
    if keys.device.type == "cpu":
        return fold_in_ref(keys, data)
    out = torch.empty((*batch, 2), dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64).expand(batch).contiguous()
    return threefry_cuda(keys, out, 1, FOLD_IN, data=data)
