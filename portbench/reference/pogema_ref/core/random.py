"""Threefry-2x32 counter-based random numbers, bit-equal to ``jax.random``.

The JAX package draws every map, placement and LifeLong goal queue from
``jax.random`` with the threefry2x32 generator, and its state carries the
per-env key that cached auto-reset advances on every finished episode
(``pogema_tpu/core/api.py`` ``_advance_key``). The same stream is
computed here, so resets and the ``key`` leaf are those of JAX.

The layout is that of jax 0.9.0 with ``jax_threefry_partitionable=True``
(the default there): ``split``, ``bits`` and friends hash a 64-bit
counter given as two u32 words ``(hi, lo)`` of the flat element index,
and ``bits`` returns the XOR of the two output words.

Keys are raw key words in int64 tensors ``[..., 2]`` with values in
``[0, 2**32)``: PyTorch has no shifts for ``uint32`` on the CPU, so all
arithmetic runs in int64 and is masked back to 32 bits. Every function
is batched: a key tensor ``[B, 2]`` gives ``[B, *shape]`` draws.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of counter words ``(x0, x1)``
    under key words ``(k0, k1)``; all int64 tensors holding u32 values,
    broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """Raw key words of ``jax.random.key(seed)``: ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def _hash_counters(keys, shape):
    """threefry of the flat index of every element of
    ``shape`` under each key: two int64 tensors ``[*batch, *shape]``."""
    batch = keys.shape[:-1]
    numel = 1
    for d in shape:
        numel *= int(d)
    idx = torch.arange(numel, dtype=torch.int64, device=keys.device).reshape(shape)
    view = tuple(batch) + (1,) * len(shape)
    k0 = keys[..., 0].reshape(view)
    k1 = keys[..., 1].reshape(view)
    return threefry2x32(k0, k1, idx >> 32, idx & _M32)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` -> ``[..., num, 2]``."""
    b0, b1 = _hash_counters(keys, (num,))
    return torch.stack([b0, b1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` with a scalar or per-key integer ``data``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _M32
    zero = torch.zeros_like(data)
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], zero, data)
    return torch.stack([b0, b1], dim=-1)


def bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (u32) as int64 values in ``[0, 2**32)``."""
    b0, b1 = _hash_counters(keys, tuple(shape))
    return b0 ^ b1


def uniform(keys: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in [minval, maxval) as float32: the top 23
    bits become the mantissa of a float f in [1, 2); the draw is
    ``max(minval, (f - 1) * (maxval - minval) + minval)``, exactly ``f - 1``
    for the default range. XLA contracts that product and sum into one
    fused multiply-add (one rounding); the sum is taken here in float64,
    where it is exact for these operands, and rounded to float32 once."""
    mant = (bits(keys, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    fma = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fma)


def gumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (mode 'low') in float32:
    ``-log(-log(uniform(tiny, 1)))``."""
    u = uniform(keys, shape, minval=torch.finfo(torch.float32).tiny, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of f32 ``logits``
    with one key for the whole array: ``argmax(logits + gumbel)`` (first
    index on ties), as int64."""
    return (gumbel(keys, tuple(logits.shape)) + logits).argmax(dim=-1)


def bernoulli(keys: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode 'low'): ``uniform < p`` in float32."""
    u = uniform(keys, shape)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


def _mul32(a, b):
    """(a * b) mod 2**32 for u32 values held in int64 (no overflow)."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _M32


def randint(keys: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` with int32 output. ``minval``/``maxval`` are
    ints or int tensors broadcastable to ``[*batch, *shape]`` (for a
    per-row bound give it the trailing singleton dims). Same biased
    double-word modulus as jax: ``((hi % span) * (2**32 % span) + lo %
    span) % span`` in wrapping u32 arithmetic."""
    dev = keys.device
    shape = tuple(shape)
    minval = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    k = split(keys, 2)
    higher = bits(k[..., 0, :], shape)
    lower = bits(k[..., 1, :], shape)
    span = (maxval - minval) & _M32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = (65536 % span)
    mult = _mul32(mult, mult) % span
    off = (_mul32(higher % span, mult) + lower % span) & _M32
    off = off % span
    return (minval + off).to(torch.int32)
