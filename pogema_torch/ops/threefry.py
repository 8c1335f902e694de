"""The threefry2x32-20 hash in plain PyTorch: the plain version of K7.

All arithmetic runs in int64 tensors holding u32 values and is masked
back to 32 bits (PyTorch has no shifts for ``uint32`` on the CPU). The
functions here are what ``ops/cuda_threefry.py`` returns for tensors on
the CPU, and what the card's kernel is held against; ``core/random.py``
builds ``jax.random``'s draws on them, and ``tests/test_torch_random.py``
holds the result against ``jax.random``.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of counter words ``(x0, x1)``
    under key words ``(k0, k1)``; all int64 tensors holding u32 values,
    broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _hash_counters(keys, shape, offset: int):
    """threefry of the flat index (plus ``offset``) of every element of
    ``shape`` under each key: two int64 tensors ``[*batch, *shape]``."""
    batch = keys.shape[:-1]
    numel = 1
    for d in shape:
        numel *= int(d)
    idx = torch.arange(offset, offset + numel, dtype=torch.int64, device=keys.device).reshape(shape)
    view = tuple(batch) + (1,) * len(shape)
    k0 = keys[..., 0].reshape(view)
    k1 = keys[..., 1].reshape(view)
    return threefry2x32(k0, k1, idx >> 32, idx & M32)


def split_ref(keys, num: int, offset: int = 0) -> torch.Tensor:
    """``[..., 2]`` -> ``[..., num, 2]``: keys ``[offset, offset + num)``
    of a larger split."""
    b0, b1 = _hash_counters(keys, (num,), offset)
    return torch.stack([b0, b1], dim=-1)


def bits_ref(keys, shape, offset: int = 0) -> torch.Tensor:
    """``[..., 2]`` -> ``[..., *shape]``: the XOR of the two output words."""
    b0, b1 = _hash_counters(keys, tuple(shape), offset)
    return b0 ^ b1


def fold_in_ref(keys, data) -> torch.Tensor:
    """``[..., 2]`` -> ``[..., 2]``: the hash of the counter words ``(0,
    data mod 2**32)`` under each key, ``data`` an int or an int64 tensor
    that broadcasts to the keys' batch."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & M32
    zero = torch.zeros_like(data)
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], zero, data)
    return torch.stack([b0, b1], dim=-1)
