"""4-connected component labels in CUDA for Hopper: K4.

The kernel lives in ``csrc/components.cu`` (design and bound in its source
note), is built with nvcc at first use and launched through
``ops/launch.py``. One launch labels every env of the batch: each free
cell gets the minimum flat index of its 4-connected component, each
obstacle P*P, by union-find in one block an env, with no host sync.

:func:`connected_components` returns the plain version,
``ops.components.connected_components`` (the flood fill of segmented
scans, which syncs the host once a sweep), for a grid on the CPU, and
launches the kernel or raises for a CUDA grid. Either way it first
refuses what the kernel does not take (dtype, shape, contiguity, device),
so a caller's fault shows on the CPU too. ``components_cuda.launches``
counts the launches.
"""

from __future__ import annotations

import torch

from . import components, launch
from .launch import I32, PTR

# The largest side whose labels the kernel keeps in shared memory
# (``csrc/components.cu::pogema_components_smem_side``); above it they
# live in the output rows.
SMEM_SIDE = 236
# Flat cells and the obstacle label P*P must fit in int32.
MAX_SIDE = 46340

_GRID = (torch.uint8, torch.bool)


class _Components(launch.Kernel):
    """K4's launch entry, bound only where the kernel keeps labels in
    shared memory up to the side :data:`SMEM_SIDE` says."""

    def bind(self):
        side = launch.bind("components", "pogema_components_smem_side")()
        if side != SMEM_SIDE:
            raise RuntimeError(f"csrc/components.cu keeps labels in shared memory up to P = "
                               f"{side}, the wrapper expects {SMEM_SIDE}")
        return super().bind()


def components_cuda(padded_grid) -> torch.Tensor:
    """One K4 launch on a checked CUDA grid; returns i64[B, P*P]."""
    b, p, _ = padded_grid.shape
    out = torch.empty((b, p * p), dtype=torch.int64, device=padded_grid.device)
    if b == 0:  # nothing to launch (and nothing counted)
        return out
    _K4(padded_grid.device, padded_grid.data_ptr(), out.data_ptr(), b, p)
    return out


_K4 = _Components("components", "pogema_components", (PTR, PTR, I32, I32), "components_kernel",
                  components_cuda)


def connected_components(padded_grid: torch.Tensor) -> torch.Tensor:
    """K4. padded_grid: u8 or bool [B, P, P], nonzero = obstacle. Returns
    i64[B, P*P]: for free cells the minimum flat index of their
    4-connected component; P*P for obstacles."""
    launch.check(("padded_grid", padded_grid, _GRID))
    if padded_grid.dim() != 3 or padded_grid.shape[1] != padded_grid.shape[2]:
        raise ValueError(f"padded_grid must be [B, P, P], got {tuple(padded_grid.shape)}")
    if not 1 <= padded_grid.shape[1] <= MAX_SIDE:
        raise ValueError(f"the grid's side must be in [1, {MAX_SIDE}], got {padded_grid.shape[1]}")
    if padded_grid.device.type == "cpu":
        return components.connected_components(padded_grid)
    return components_cuda(padded_grid)
