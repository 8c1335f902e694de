"""pogema_torch.core.random against jax.random (threefry2x32, jax 0.9.0
with partitionable threefry): every draw bit-equal, for many seeds,
shapes and batched keys. The hash's wrapper (``ops/cuda_threefry.py``)
on the CPU: the plain path with no launch, counters past 2**32, and the
refusals of what its kernel would not take (the kernel itself is in
``test_torch_threefry.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pogema_torch.core import random as jr
from pogema_torch.ops import cuda_threefry

SEEDS = [0, 1, 7, 42, 2**31 - 1, 2**31 + 5, 2**32 - 1, -3, 123456789]
SHAPES = [(), (1,), (5,), (3, 7), (2, 3, 4), (74 * 74,)]


def kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def keys_of(seed, batch):
    """A JAX key array of ``batch`` keys and the port's [batch, 2]."""
    ks = jax.random.split(jax.random.key(seed), batch)
    return ks, torch.as_tensor(kd(ks))


def test_threefry_known_answer():
    # Random123's known-answer vector for threefry2x32_20, key/counter 0.
    out = jr.threefry2x32(*(torch.zeros((), dtype=torch.int64),) * 4)
    assert (int(out[0]), int(out[1])) == (0x6B200159, 0x99BA4EFE)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k = jax.random.key(seed)
    tk = jr.key(seed)
    np.testing.assert_array_equal(tk.numpy(), kd(k))
    for num in (1, 2, 3, 16):
        np.testing.assert_array_equal(jr.split(tk, num).numpy(), kd(jax.random.split(k, num)))
    for data in (0, 1, 63, 2**31 + 1):
        np.testing.assert_array_equal(jr.fold_in(tk, data).numpy(),
                                      kd(jax.random.fold_in(k, data)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 5, 2**32 - 1])
def test_bits_uniform_bernoulli(seed, shape):
    k, tk = jax.random.key(seed), jr.key(seed)
    np.testing.assert_array_equal(jr.bits(tk, shape).numpy(),
                                  np.asarray(jax.random.bits(k, shape)).astype(np.int64))
    u = jr.uniform(tk, shape)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), np.asarray(jax.random.uniform(k, shape)))
    for p in (0.5, 0.3, 0.05):
        np.testing.assert_array_equal(jr.bernoulli(tk, p, shape).numpy(),
                                      np.asarray(jax.random.bernoulli(k, p, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed):
    k, tk = jax.random.key(seed), jr.key(seed)
    for lo, hi in ((0, 5), (0, 1), (3, 3), (-7, 100), (0, 5476), (0, 2**31 - 1)):
        got = jr.randint(tk, (4, 9), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.randint(k, (4, 9), lo, hi)))
    np.testing.assert_array_equal(jr.randint(tk, (), 0, 17).numpy(),
                                  np.asarray(jax.random.randint(k, (), 0, 17)))
    # Per-row bound, as the LifeLong queue draws it.
    rng = np.random.default_rng(seed & 0xFFFF)
    hi = rng.integers(1, 6000, size=(6,)).astype(np.int32)
    hi[0] = 1
    want = jax.random.randint(k, (6, 11), 0, jnp.asarray(hi)[:, None])
    got = jr.randint(tk, (6, 11), 0, torch.as_tensor(hi)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batched_keys(batch):
    before = cuda_threefry.threefry_cuda.launches
    ks, tks = keys_of(batch, batch)
    np.testing.assert_array_equal(jr.split(tks, 3).numpy(), kd(jax.vmap(lambda k: jax.random.split(k, 3))(ks)))
    np.testing.assert_array_equal(jr.split(tks, 1)[:, 0].numpy(),
                                  kd(jax.vmap(lambda k: jax.random.split(k, 1)[0])(ks)))
    np.testing.assert_array_equal(jr.fold_in(tks, 9).numpy(),
                                  kd(jax.vmap(lambda k: jax.random.fold_in(k, 9))(ks)))
    np.testing.assert_array_equal(
        jr.uniform(tks, (5, 6)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (5, 6)))(ks)))
    np.testing.assert_array_equal(
        jr.bits(tks, (33,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (33,)))(ks)).astype(np.int64))
    hi = np.arange(1, batch * 4 + 1, dtype=np.int32).reshape(batch, 4, 1) * 37
    want = jax.vmap(lambda k, h: jax.random.randint(k, (4, 5), 0, h))(ks, jnp.asarray(hi))
    np.testing.assert_array_equal(jr.randint(tks, (4, 5), 0, torch.as_tensor(hi)).numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(
        jr.randint(tks, (), 0, 11).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 11))(ks)))
    # Per-key fold_in data, as a tensor and as a sequence.
    data = [(i + 7) * 40503 + (2**31 if i % 2 else 0) for i in range(batch)]
    want = kd(jax.vmap(jax.random.fold_in)(ks, jnp.asarray(data, dtype=jnp.uint32)))
    np.testing.assert_array_equal(jr.fold_in(tks, torch.tensor(data)).numpy(), want)
    np.testing.assert_array_equal(jr.fold_in(tks, data).numpy(), want)
    # Keys on the CPU take the plain hash: no kernel launch.
    assert cuda_threefry.threefry_cuda.launches == before


def test_offset_above_2_32():
    # Counters past 2**32 (only the port's offset reaches them) are hashed
    # as the words (hi, lo) = (1, 3 + j).
    _, keys = keys_of(11, 3)
    lo = torch.arange(3, 8, dtype=torch.int64)
    x0, x1 = jr.threefry2x32(keys[:, :1], keys[:, 1:], torch.ones_like(lo), lo)
    assert torch.equal(jr.bits(keys, (5,), 2**32 + 3), x0 ^ x1)
    assert torch.equal(jr.split(keys, 5, 2**32 + 3), torch.stack([x0, x1], dim=-1))


_KEYS = torch.zeros(4, 2, dtype=torch.int64)


@pytest.mark.parametrize("call,error", [
    (lambda: cuda_threefry.bits(_KEYS.int(), (3,)), TypeError),
    (lambda: cuda_threefry.split(_KEYS.float(), 2), TypeError),
    (lambda: cuda_threefry.bits(torch.zeros(4, 3, dtype=torch.int64), (3,)), ValueError),
    (lambda: cuda_threefry.fold_in(torch.zeros(2, dtype=torch.int64)[:1], 0), ValueError),
    (lambda: cuda_threefry.split(torch.zeros((), dtype=torch.int64), 2), ValueError),
    (lambda: cuda_threefry.split(torch.zeros(2, 4, 2, dtype=torch.int64)[:, 1], 2), ValueError),
    (lambda: cuda_threefry.bits(torch.zeros(2, 4, dtype=torch.int64)[:, ::2], (3,)), ValueError),
    (lambda: cuda_threefry.fold_in(_KEYS.t().contiguous().t(), 1), ValueError),
    (lambda: cuda_threefry.bits(_KEYS, (3,), offset=-1), ValueError),
    (lambda: cuda_threefry.fold_in(_KEYS, torch.zeros(4, dtype=torch.int64, device="meta")),
     ValueError),
    (lambda: cuda_threefry.split(_KEYS.to("meta"), 2), ValueError),
    (lambda: cuda_threefry.fold_in(_KEYS, torch.zeros(5, dtype=torch.int64)), ValueError),
    (lambda: cuda_threefry.fold_in(_KEYS, torch.zeros(4, 1, dtype=torch.int64)), ValueError),
    (lambda: cuda_threefry.fold_in(_KEYS, torch.zeros(4)), TypeError),
    (lambda: cuda_threefry.fold_in(_KEYS, [1, 2, 3]), ValueError),
], ids=["bits_int32_keys", "split_float_keys", "keys_of_three_words", "keys_of_one_word",
        "keys_0d", "split_strided_keys", "bits_strided_words", "fold_in_transposed_keys",
        "negative_offset", "data_on_another_device", "keys_on_meta", "data_of_another_batch",
        "data_wider_than_batch", "float_data", "data_sequence_of_another_batch"])
def test_wrapper_refuses_what_the_kernel_does_not_take(call, error):
    before = cuda_threefry.threefry_cuda.launches
    with pytest.raises(error):
        call()
    assert cuda_threefry.threefry_cuda.launches == before

