"""Placement of a reset's agents and targets in CUDA for Hopper: K9.

The kernel lives in ``csrc/placement.cu`` (design and bound in its source
note), is built with nvcc at first use and launched through
``ops/launch.py``. One launch places every env of a try: the agents at the
top-N uniforms over eligible cells, then each agent's target, the first
argmax of its draws over the free cells of its component that no earlier
agent took, by one block an env that hashes only each agent's component,
with no host sync.

:func:`place_agents_and_targets` returns the plain version,
``ops.placement.place_agents_and_targets`` (N passes of masked tensor ops),
for tensors on the CPU, and launches the kernel or raises for CUDA
tensors. Either way it first refuses what the kernel does not take (dtype,
shape, contiguity, device, a side or an agent count out of range), so a
caller's fault shows on the CPU too. ``placement_cuda.launches`` counts
the launches.
"""

from __future__ import annotations

import torch

from . import launch, placement
from .launch import I32, I64, PTR

# Flat cells and the obstacle label P*P must fit in int32.
MAX_SIDE = 46340

_INT64 = (torch.int64,)


class _Placement(launch.Kernel):
    """K9's launch entry, bound with its query of the device-memory
    scratch a block needs (0 where the block's arrays fit in shared
    memory)."""

    def bind(self):
        self.scratch_words = launch.bind("placement", "pogema_placement_scratch_words", I32, I32,
                                         restype=I64)
        return super().bind()


def placement_cuda(keys, labels, p: int, n: int):
    """One K9 launch on checked CUDA inputs; returns (agent_cells
    i64[B, N], target_cells i64[B, N], ok bool[B])."""
    b = keys.shape[0]
    dev = keys.device
    agents = torch.empty((b, n), dtype=torch.int64, device=dev)
    targets = torch.empty((b, n), dtype=torch.int64, device=dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:  # nothing to launch (and nothing counted)
        return agents, targets, ok
    if _K9.fn is None:
        _K9.bind()
    words = _K9.scratch_words(p, n)
    scratch = torch.empty(b * words, dtype=torch.int32, device=dev) if words > 0 else None
    _K9(dev, keys.data_ptr(), labels.data_ptr(), agents.data_ptr(), targets.data_ptr(),
        ok.data_ptr(), None if scratch is None else scratch.data_ptr(), b, p, n)
    return agents, targets, ok


_K9 = _Placement("placement", "pogema_placement", (PTR,) * 6 + (I32,) * 3, "placement_kernel",
                 placement_cuda)


def place_agents_and_targets(keys: torch.Tensor, labels: torch.Tensor, p: int, n: int):
    """K9. keys: int64[B, 2] (u32 words); labels: int64[B, P*P], K4's
    component labels (a free cell's component's least flat index, P*P for
    an obstacle); ``n`` agents, 1 <= n <= P*P. Returns (agent_cells
    i64[B, N], target_cells i64[B, N], ok bool[B]), bit-equal to
    ``ops.placement.place_agents_and_targets``."""
    launch.check(("keys", keys, _INT64), ("labels", labels, _INT64))
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be [B, 2], got {tuple(keys.shape)}")
    if not 1 <= p <= MAX_SIDE:
        raise ValueError(f"the grid's side must be in [1, {MAX_SIDE}], got {p}")
    if tuple(labels.shape) != (keys.shape[0], p * p):
        raise ValueError(f"labels must be [B, P*P] = [{keys.shape[0]}, {p * p}], got "
                         f"{tuple(labels.shape)}")
    if not 1 <= n <= p * p:
        raise ValueError(f"the number of agents must be in [1, P*P = {p * p}], got {n}")
    if keys.device.type == "cpu":
        return placement.place_agents_and_targets(keys, labels, p, n)
    return placement_cuda(keys, labels, p, n)
