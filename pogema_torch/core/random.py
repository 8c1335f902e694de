"""Threefry-2x32 counter-based random numbers, bit-equal to ``jax.random``.

The JAX package draws every map, placement and LifeLong goal queue from
``jax.random`` with the threefry2x32 generator, and its state carries the
per-env key that cached auto-reset advances on every finished episode
(``pogema_tpu/core/api.py`` ``_advance_key``). To keep resets and the
``key`` leaf bit-equal to JAX, the port computes the same stream here
instead of using ``torch.Generator``.

The layout is that of jax 0.9.0 with ``jax_threefry_partitionable=True``
(the default there): ``split``, ``bits`` and friends hash a 64-bit
counter given as two u32 words ``(hi, lo)`` of the flat element index,
and ``bits`` returns the XOR of the two output words.

Keys are raw key words in int64 tensors ``[..., 2]`` with values in
``[0, 2**32)``: PyTorch has no shifts for ``uint32`` on the CPU, so all
arithmetic runs in int64 and is masked back to 32 bits. Every function
is batched: a key tensor ``[B, 2]`` gives ``[B, *shape]`` draws. The
hash itself runs in ``ops/cuda_threefry.py``: one launch of the K7
kernel for keys on a card, its plain int64 version (``ops/threefry.py``)
for keys on the CPU.

Because each element hashes its own flat index, any contiguous run of a
draw can be made alone: ``offset`` (in ``split``, ``bits``, ``uniform``,
``gumbel`` and ``categorical``) starts the counters there, so a process
that holds rows ``[lo, hi)`` of a global ``[B, ...]`` draw passes
``offset = lo * (elements per row)`` and gets exactly its rows of the
global draw, as the partitionable threefry gives each shard of a global
``jax.random`` array.
"""

from __future__ import annotations

import torch

from ..ops import cuda_threefry
from ..ops.threefry import M32 as _M32, threefry2x32  # noqa: F401  (the hash, for callers and tests)


def key(seed: int, device="cpu") -> torch.Tensor:
    """Raw key words of ``jax.random.key(seed)``: ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def split(keys: torch.Tensor, num: int = 2, offset: int = 0) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` -> ``[..., num, 2]``; keys
    ``[offset, offset + num)`` of a larger split."""
    return cuda_threefry.split(keys.contiguous(), num, offset)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` with a scalar or per-key integer ``data``."""
    return cuda_threefry.fold_in(keys.contiguous(), data)


def bits(keys: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits`` (u32) as int64 values in ``[0, 2**32)``."""
    return cuda_threefry.bits(keys.contiguous(), shape, offset)


def uniform(keys: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0,
            offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in [minval, maxval) as float32: the top 23
    bits become the mantissa of a float f in [1, 2); the draw is
    ``max(minval, (f - 1) * (maxval - minval) + minval)``, exactly ``f - 1``
    for the default range. XLA contracts that product and sum into one
    fused multiply-add (one rounding); the sum is taken here in float64,
    where it is exact for these operands, and rounded to float32 once."""
    mant = (bits(keys, shape, offset) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    fma = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fma)


def gumbel(keys: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """``jax.random.gumbel`` (mode 'low') in float32:
    ``-log(-log(uniform(tiny, 1)))``."""
    u = uniform(keys, shape, minval=torch.finfo(torch.float32).tiny, maxval=1.0, offset=offset)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of f32 ``logits``
    with one key for the whole array: ``argmax(logits + gumbel)`` (first
    index on ties), as int64. With ``offset`` the noise is that of the
    elements of a larger draw that start there."""
    return (gumbel(keys, tuple(logits.shape), offset) + logits).argmax(dim=-1)


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
