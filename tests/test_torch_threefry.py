"""K7, the threefry kernel (``ops/cuda_threefry.py``, ``csrc/threefry.cu``),
against its plain version (``ops/threefry.py``) on the card, bit for bit.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one; the wrappers' refusals and their CPU path, which the CPU runs, are in
``test_torch_random.py``. This file imports no JAX, so the card's machine
runs it as it is.
"""

import pytest
import torch

from pogema_torch import GridConfig, PogemaCore
from pogema_torch.core import random as jr
from pogema_torch.ops import cuda_threefry
from pogema_torch.ops.threefry import bits_ref, fold_in_ref, split_ref

BIG = 74 * 74  # a config-D placement draw: one counter per padded cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the threefry kernel has no CPU mode")
    return torch.device("cuda")


def _keys(rows, seed=0):
    return torch.randint(0, 2**32, (rows, 2), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(seed))


def _launched(fn, *args):
    """``fn(*args)`` on the card, synchronised, and the launches it made."""
    before = cuda_threefry.threefry_cuda.launches
    out = fn(*args)
    torch.cuda.synchronize()
    return out, cuda_threefry.threefry_cuda.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("rows,num,offset", [(4096, 1, 0), (4096, 3, 0), (3, 16, 2**32 + 5),
                                             (1, 1024, 7)])
def test_split_on_card(card, rows, num, offset):
    keys = _keys(rows, num)
    got, launches = _launched(cuda_threefry.split, keys.to(card), num, offset)
    assert launches == 1
    assert torch.equal(got.cpu(), split_ref(keys, num, offset))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,shape,offset", [
    (1024, (BIG,), 0), (4096, (BIG,), 0), (4, (BIG,), 2 * BIG), (8, (5, 7), 2**32 - 3),
    (2, (300,), 2**40 + 11), (5, (), 0)], ids=str)
def test_bits_on_card(card, rows, shape, offset):
    keys = _keys(rows, rows)
    got, launches = _launched(cuda_threefry.bits, keys.to(card), shape, offset)
    assert launches == 1
    assert torch.equal(got.cpu(), bits_ref(keys, shape, offset))


@pytest.mark.cuda
def test_fold_in_on_card(card):
    keys = _keys(1024, 3)
    for data in (0, 1, 127, 2**31 + 1, 2**32 + 9, -1):
        got, launches = _launched(cuda_threefry.fold_in, keys.to(card), data)
        assert launches == 1
        assert torch.equal(got.cpu(), fold_in_ref(keys, data)), data
    per_key = torch.arange(-3, 1021, dtype=torch.int64) * 40503
    got, launches = _launched(cuda_threefry.fold_in, keys.to(card), per_key.to(card))
    assert launches == 1
    assert torch.equal(got.cpu(), fold_in_ref(keys, per_key))
    got, launches = _launched(cuda_threefry.fold_in, keys.to(card), per_key.tolist())
    assert launches == 1
    assert torch.equal(got.cpu(), fold_in_ref(keys, per_key))
    column = per_key[:4].reshape(4, 1).to(torch.int32)
    grid_keys = _keys(12, 4).reshape(4, 3, 2)
    got, _ = _launched(cuda_threefry.fold_in, grid_keys.to(card), column.to(card))
    assert torch.equal(got.cpu(), fold_in_ref(grid_keys, column.long()))
    one, _ = _launched(cuda_threefry.fold_in, jr.key(42, card), 9)
    assert torch.equal(one.cpu(), fold_in_ref(jr.key(42), 9))


@pytest.mark.cuda
def test_zero_sizes_and_known_answer_on_card(card):
    keys = _keys(4, 5)
    for fn, args, ref in ((cuda_threefry.bits, ((0, 3),), bits_ref),
                          (cuda_threefry.split, (0,), split_ref)):
        got, launches = _launched(fn, keys.to(card), *args)
        assert launches == 0 and torch.equal(got.cpu(), ref(keys, *args))
    got, launches = _launched(cuda_threefry.bits, keys[:0].to(card), (5,))
    assert launches == 0 and got.shape == (0, 5)
    # Random123's known-answer vector for threefry2x32_20, key and counter
    # 0: the pair is split's key 0, and bits' XOR of it.
    zero = torch.zeros(2, dtype=torch.int64, device=card)
    pair, _ = _launched(cuda_threefry.split, zero, 1)
    assert pair.cpu().tolist() == [[0x6B200159, 0x99BA4EFE]]
    assert cuda_threefry.bits(zero, ()).item() == 0x6B200159 ^ 0x99BA4EFE


@pytest.mark.cuda
def test_random_draws_on_card_equal_cpu(card):
    # The draws whose every step after the hash is exact on both devices.
    # gumbel and categorical take logarithms of the same uniforms, which
    # the card and the CPU round differently in the last bit.
    keys = _keys(6, 6)
    k = keys.to(card)
    tiny = torch.finfo(torch.float32).tiny
    pairs = (
        (jr.uniform(k, (5, 9)), jr.uniform(keys, (5, 9))),
        (jr.uniform(k, (5, 9), -2.0, 3.0), jr.uniform(keys, (5, 9), -2.0, 3.0)),
        (jr.uniform(k, (33,), tiny, 1.0, offset=66), jr.uniform(keys, (33,), tiny, 1.0, offset=66)),
        (jr.bernoulli(k, 0.3, (16, 16)), jr.bernoulli(keys, 0.3, (16, 16))),
        (jr.randint(k, (4, 9), 0, 5476), jr.randint(keys, (4, 9), 0, 5476)),
        (jr.randint(k[0], (), 0, 17), jr.randint(keys[0], (), 0, 17)),
        (jr.split(jr.split(k, 2)[:, 1], 3), jr.split(jr.split(keys, 2)[:, 1], 3)),
    )
    for got, want in pairs:
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_core_cached_autoreset_on_card_equals_cpu(card):
    """A reset and 64 cached ``step_autoreset`` steps on the card equal the
    same run on the CPU, keys included; each step advances the keys with
    exactly one launch."""
    cfg = dict(seed=0, size=16, num_agents=8, obs_radius=3, max_episode_steps=12)
    cores = {dev: PogemaCore(GridConfig(**cfg), num_envs=64, maze=True, device=dev,
                             obs_layout="packed") for dev in ("cpu", card)}
    states = {dev: core.reset(3)[0] for dev, core in cores.items()}
    inits = dict(states)
    gen = torch.Generator().manual_seed(0)
    for step in range(64):
        actions = torch.randint(0, 5, (64, 8), generator=gen, dtype=torch.int32)
        before = cuda_threefry.threefry_cuda.launches
        outs = {dev: core.step_autoreset(states[dev], inits[dev], actions.to(dev))
                for dev, core in cores.items()}
        torch.cuda.synchronize()
        assert cuda_threefry.threefry_cuda.launches - before == 1, step
        states = {dev: out[0] for dev, out in outs.items()}
        want, got = outs["cpu"], outs[card]
        for name, value in want[0].tensors().items():
            assert torch.equal(got[0].tensors()[name].cpu(), value), (step, name)
        assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[3].cpu(), want[3]), step
