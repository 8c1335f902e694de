"""Copying what a rim step returns to the host.

``fetch`` copies everything a step hands back to numpy with one
synchronisation: each CUDA tensor goes by a non-blocking copy into pinned
host memory (PyTorch's caching host allocator, so the buffers are reused
once the arrays made from them are dropped), and the host then waits
once for the device's stream. One ``.cpu()`` per field would wait once per
field.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    if isinstance(tree, torch.Tensor):
        return next(it)
    return tree


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: widen on the host, after the (halved) copy.
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def fetch(tree):
    """``tree`` (nested dicts, lists and tuples) with every tensor replaced
    by a numpy array, all copied with one wait for the device. CPU
    tensors are not copied: their arrays share memory with them.

    The arrays of CUDA tensors lie in pinned memory, which the caching
    host allocator keeps page-locked after they are dropped, for reuse. A
    caller that keeps many of them (a rollout's observations, say) should
    keep copies (``np.array(a)``), or it locks that much host RAM for
    the life of the process."""
    leaves = _leaves(tree, [])
    hosts, streams = [], {}
    for t in leaves:
        t = t.detach()
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            streams[t.device] = torch.cuda.current_stream(t.device)
            t = h
        hosts.append(t)
    for s in streams.values():
        s.synchronize()
    return _rebuild(tree, iter([_as_numpy(h) for h in hosts]))


def nbytes(tree) -> int:
    """Bytes of every tensor in ``tree``: what :func:`fetch` copies."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree, []))

