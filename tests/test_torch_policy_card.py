"""K8, the served recurrent policy step (``ops/cuda_policy.py``,
``csrc/policy.cu``), against its plain version
(``RecurrentEmbedActorCritic.step_from_obs``) on the card; and its
launches on the paths that run the policy.

- Where the order of the f32 sums cannot matter (integer observations,
  weights and h on power-of-two grids small enough that every partial sum
  is exact, one head weight an output), K8 is bit-equal to the plain
  version: that pins every rounding point.
- With the shipped weights on served states, each step from the plain
  version's own h, K8's h' equals the plain version's in all but
  ``SERVED_H_SHARE`` of the entries: K8 sums again in k order every GRU
  sum near a bf16 rounding boundary, so only the embedding's tensor-core
  sums may round otherwise. From random inputs, h' differs in at most
  ``H_SHARE`` of the entries, by at most ``H_GAP``, and logits and value by
  ``STEP_LOGIT_GAP``; over 128 chained served steps, each path carrying its
  own h, the logits part by at most ``CHAINED_LOGIT_GAP``. Each tolerance
  sits a few times above what an H100 reads (`PERF.md` §6).
- The premise of K8's sums taken again: the plain version's bf16
  ``dense`` sums each GRU product as one f32 fma a k, k in order (cuBLAS
  at the program's rows and at the served check's reference rows). Should
  a cuBLAS or CUDA update pick a GEMM that sums otherwise, this test
  names it; the served check would read it only as flaky logit gaps.
- K8 launches once a served step (128 in a config-D episode), and never
  in the learner's rollout and replay, which run outside inference mode.

Every test needs a CUDA device (marker ``cuda``) and skips without one.
This file imports no JAX, so the card's machine runs it as it is.
"""

import os

import pytest
import torch

from pogema_torch import GridConfig, PogemaCore
from pogema_torch import parallel as tp
from pogema_torch.core import step as step_mod
from pogema_torch.core.obs import packed_observation
from pogema_torch.interop import load_policy
from pogema_torch.models import RecurrentEmbedActorCritic
from pogema_torch.models.embed_actor_critic import dense
from pogema_torch.ops import cuda_policy

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "pogema_torch", "weights")
# Rows of the two served cells (B x N) and ragged counts around a block's
# 128 rows.
CELL_ROWS = {"D": 1024 * 128, "E": 1024 * 256}
# Rows of the served check's reference policy: 8 envs (portbench's serve
# traffic, check_envs) x N.
CHECK_ROWS = {"D": 8 * 128, "E": 8 * 256}
RAGGED_ROWS = (1, 3, 127, 128, 129, 1000)
# The served cells' grids, as chip_smoke.py's CONFIG_D and CONFIG_E.
GRIDS = {"D": dict(size=64, num_agents=128, obs_radius=5, density=0.3, on_target="restart",
                   max_episode_steps=128),
         "E": dict(size=128, num_agents=256, obs_radius=5, density=0.3, on_target="restart",
                   max_episode_steps=128)}
CHECKPOINTS = {"D": "rec128_ft", "E": "maze256"}
# The tolerances (see the module's docstring). Read on an H100: 2.2e-7 of
# 4.0e8 entries at D and 0 of 8.1e8 at E; 1.25e-6 / 4.8e-7 of the entries,
# by 1.56e-2 / 3.9e-3, logits within 6.3e-2 / 4.7e-3; chained 0.133 / 0.
SERVED_H_SHARE = 1e-6
H_SHARE = 1e-5
H_GAP = 0.125
STEP_LOGIT_GAP = 0.25
CHAINED_LOGIT_GAP = 0.5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K8 has no CPU mode")
    return torch.device("cuda")


def _shipped(cell, device):
    return load_policy(os.path.join(WEIGHTS, f"{CHECKPOINTS[cell]}.npz"), device=device)


def _k8(model, obs, h):
    """K8 on the card, synchronised, and the launches it made."""
    before = cuda_policy.policy_cuda.launches
    with torch.inference_mode():
        out = cuda_policy.policy_step(model, obs, h)
    torch.cuda.synchronize()
    return out, cuda_policy.policy_cuda.launches - before


def _plain(model, obs, h):
    with torch.no_grad():
        return model.step_from_obs(obs, h)


def _grid_values(shape, low, high, scale, gen, device):
    return (torch.randint(low, high + 1, shape, generator=gen) * scale).to(device)


def _exact_model(device, seed=0):
    """A 128/128 bf16 model whose sums are exact in f32 in any order:
    the embedding's kernel and bias on a grid of 2^-6 in [-1/16, 1/16],
    the GRU's kernels on 2^-8 in [-1/64, 1/64] and biases on 2^-7, and a
    head that reads one unit an output, times a power of two."""
    gen = torch.Generator().manual_seed(seed)
    model = RecurrentEmbedActorCritic(11, 128, 128, torch.bfloat16).to(device)
    with torch.no_grad():
        model.embed_kernel.copy_(_grid_values(model.embed_kernel.shape, -4, 4, 2 ** -6, gen,
                                              device))
        model.embed_bias.copy_(_grid_values((128,), -4, 4, 2 ** -6, gen, device))
        for layer in model.gru.values():
            layer.weight.copy_(_grid_values(layer.weight.shape, -4, 4, 2 ** -8, gen, device))
            if layer.bias is not None:
                layer.bias.copy_(_grid_values((128,), -64, 64, 2 ** -7, gen, device))
        head = torch.zeros(6, 128)
        units = torch.randperm(128, generator=gen)[:6]
        head[torch.arange(6), units] = 2.0 ** torch.randint(-2, 3, (6,), generator=gen).float()
        model.head_out.weight.copy_(head.to(device))
        model.head_out.bias.copy_(_grid_values((6,), -8, 8, 2 ** -4, gen, device))
    return model


def _exact_inputs(rows, device, seed):
    """Integer observations (counts 0-3) and h on a grid of 2^-7 in [-1, 1]."""
    gen = torch.Generator().manual_seed(seed)
    obs = torch.randint(0, 4, (rows, 363), generator=gen).float()
    obs = torch.where(torch.rand(rows, 363, generator=gen) < 0.6, torch.zeros(()), obs)
    h = torch.randint(-128, 129, (rows, 128), generator=gen) * 2.0 ** -7
    return obs.to(device), h.to(torch.bfloat16).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", RAGGED_ROWS + (CELL_ROWS["D"],))
def test_bit_equal_where_the_order_of_sums_cannot_matter(card, rows):
    model = _exact_model(card)
    obs, h = _exact_inputs(rows, card, seed=rows)
    (new_h, logits, value), launches = _k8(model, obs, h)
    want_h, want_logits, want_value = _plain(model, obs, h)
    assert launches == 1
    assert torch.equal(new_h, want_h)
    assert torch.equal(logits, want_logits) and torch.equal(value, want_value)
    # the gates saw more than saturation: r and z away from 0 and 1
    assert 0.05 < float((new_h != h).float().mean()) and bool(torch.isfinite(logits).all())


def _random_inputs(rows, device, seed):
    """Observations with the packed layout's entries (obstacles and target
    0/1, agent counts 0-2) and h drawn in (-1, 1)."""
    gen = torch.Generator().manual_seed(seed)
    obs = (torch.rand(rows, 363, generator=gen) < 0.3).float()
    obs[:, 121:242] *= torch.randint(1, 3, (rows, 121), generator=gen).float()
    h = (torch.rand(rows, 128, generator=gen) * 2 - 1).to(torch.bfloat16)
    return obs.to(device), h.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELL_ROWS))
@pytest.mark.parametrize("rows", ("cell",) + RAGGED_ROWS)
def test_shipped_weights_one_step(card, cell, rows):
    rows = CELL_ROWS[cell] if rows == "cell" else rows
    model = _shipped(cell, card)
    obs, h = _random_inputs(rows, card, seed=rows + len(cell))
    (new_h, logits, value), launches = _k8(model, obs, h)
    want_h, want_logits, want_value = _plain(model, obs, h)
    assert launches == 1
    share = float((new_h != want_h).float().mean())
    h_gap = float((new_h.float() - want_h.float()).abs().max())
    gap = float(torch.maximum((logits - want_logits).abs().max(), (value - want_value).abs().max()))
    print(f"{cell} rows {rows}: h' differs in {share:.3e} of the elements, by at most "
          f"{h_gap:.3e}; logits and value within {gap:.3e}")
    assert share <= H_SHARE and h_gap <= H_GAP and gap <= STEP_LOGIT_GAP


def _served_core(cell, device):
    return PogemaCore(GridConfig(seed=0, **GRIDS[cell]), num_envs=1024, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELL_ROWS))
def test_served_steps_round_as_the_plain_version(card, cell):
    """16 greedy served steps, K8 and the plain version each from the plain
    version's h: h' equal in all but SERVED_H_SHARE of the entries."""
    core = _served_core(cell, card)
    model = _shipped(cell, card)
    state, _ = core.reset(core.make_key(7), with_obs=False)
    h = model.initial_carry(state.active.shape)
    differ = total = 0
    for _ in range(16):
        obs = packed_observation(model.window, state.obstacles, state.agents_xy,
                                 state.targets_xy, state.active)
        (new_h, _, _), launches = _k8(model, obs, h)
        h, logits, _ = _plain(model, obs, h)
        assert launches == 1
        differ += int((new_h != h).sum())
        total += h.numel()
        state, _ = step_mod.step(core.cfg, state, logits.argmax(-1).to(torch.int32),
                                 with_obs=False)
    print(f"{cell}: served h' differs from the plain version's in {differ} of {total} entries")
    assert differ <= SERVED_H_SHARE * total


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELL_ROWS))
def test_shipped_weights_chained_over_an_episode(card, cell):
    """128 served steps on env states (random moves), each path carrying
    its own h from zero: the largest logit gap over every step."""
    core = _served_core(cell, card)
    model = _shipped(cell, card)
    gen = torch.Generator(device=card).manual_seed(7)
    state, _ = core.reset(core.make_key(3), with_obs=False)
    b, n = state.active.shape
    h_k8 = h_plain = model.initial_carry((b, n))
    gap, launches = 0.0, 0
    for _ in range(GRIDS[cell]["max_episode_steps"]):
        args = (state.obstacles, state.agents_xy, state.targets_xy, state.active)
        with torch.inference_mode():
            before = cuda_policy.policy_cuda.launches
            h_k8, logits, _ = model.step_from_state(*args, h_k8)
            launches += cuda_policy.policy_cuda.launches - before
        h_plain, want, _ = _plain(model, packed_observation(model.window, *args), h_plain)
        gap = max(gap, float((logits - want).abs().max()))
        actions = torch.randint(0, 5, (b, n), device=card, generator=gen, dtype=torch.int32)
        state, _ = step_mod.step(core.cfg, state, actions, with_obs=False)
    print(f"{cell}: largest logit gap over 128 chained steps {gap:.3e}")
    assert launches == 128
    assert gap < CHAINED_LOGIT_GAP


def _k_ordered(x, weight):
    """f32[rows, out]: x bf16[rows, k] times weight bf16[out, k] summed one
    k after another. A product of two bf16 values is exact in f32, so each
    step's rounded f32 add is what an fma of the two operands gives."""
    x, w = x.float(), weight.float().t()
    acc = torch.zeros(x.shape[0], w.shape[1], device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k:k + 1] * w[k]
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ("check", "cell"))
@pytest.mark.parametrize("cell", sorted(CELL_ROWS))
def test_plain_gru_products_sum_in_k_order(card, cell, rows):
    """The plain version's bf16 ``dense`` of each GRU product, shipped
    weights, at the program's and the reference's rows: bit-equal to the
    k-ordered fma sum rounded to bf16 (plus the bias in bf16), and the f32
    sum it rounds bit-equal to that sum."""
    rows = (CELL_ROWS if rows == "cell" else CHECK_ROWS)[cell]
    model = _shipped(cell, card)
    gen = torch.Generator(device=card).manual_seed(rows)
    width = model.hidden
    x = (torch.rand(rows // width, width, width, device=card, generator=gen) * 4 - 1)
    x = torch.relu(x).to(torch.bfloat16)  # e-like: ReLU'd, up to 3
    h = (torch.rand(rows // width, width, width, device=card, generator=gen) * 2 - 1)
    h = h.to(torch.bfloat16)
    with torch.inference_mode():
        for q in cuda_policy.GRU:
            layer = model.gru[q]
            v = x if q[0] == "i" else h
            got = dense(v, layer, torch.bfloat16).reshape(rows, width)
            sum32 = torch.matmul(v.float(), layer.weight.to(torch.bfloat16).float().t())
            want32 = _k_ordered(v.reshape(rows, width), layer.weight.to(torch.bfloat16))
            want = want32.to(torch.bfloat16)
            if layer.bias is not None:
                want = want + layer.bias.to(torch.bfloat16)
            assert torch.equal(sum32.reshape(rows, width), want32), q
            assert torch.equal(got, want), q


@pytest.mark.cuda
def test_launches_once_a_served_step(card):
    core = _served_core("D", card)
    run = tp.make_policy_evaluator(core, _shipped("D", card))
    before = cuda_policy.policy_cuda.launches
    state, _ = run(core.make_key(0))
    torch.cuda.synchronize()
    assert cuda_policy.policy_cuda.launches - before == 128
    assert bool((state.step_count == 128).all())


@pytest.mark.cuda
def test_no_launch_in_the_learner(card):
    """A recurrent train step from the shipped bf16 128/128 weights:
    rollout, bootstrap and replay all take the plain version."""
    grid = dict(GRIDS["D"], size=16, num_agents=8, max_episode_steps=32)
    core = PogemaCore(GridConfig(seed=0, **grid), num_envs=16, auto_reset_mode="regen",
                      device=card)
    model = _shipped("D", card)
    cfg = tp.PPOConfig(rollout_steps=8, epochs=1, minibatches=2)
    ts, tx = tp.init_recurrent_train_state(core, model, None, cfg, core.make_key(1))
    before = cuda_policy.policy_cuda.launches
    ts, stats = tp.make_recurrent_train_step(core, model, cfg, tx)(ts)
    torch.cuda.synchronize()
    assert cuda_policy.policy_cuda.launches == before
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in stats.values())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["obs on the card, h on the cpu", "h f32", "obs width"])
def test_refusals_on_the_card(card, case):
    model = _shipped("D", card)
    obs, h = _random_inputs(8, card, seed=1)
    fault = TypeError if case == "h f32" else ValueError
    if case == "obs on the card, h on the cpu":
        h = h.cpu()
    elif case == "h f32":
        h = h.float()
    else:
        obs = obs[:, :300].contiguous()
    with pytest.raises(fault):
        cuda_policy.policy_step(model, obs, h)


@pytest.mark.cuda
def test_step_from_state_takes_any_h_layout(card):
    """A non-contiguous or misaligned h goes to K8 as a copy, with the same
    result as the contiguous one."""
    core = PogemaCore(GridConfig(seed=0, **dict(GRIDS["D"], size=16, num_agents=8)),
                      num_envs=4, device=card)
    model = _shipped("D", card)
    state, _ = core.reset(core.make_key(2), with_obs=False)
    args = (state.obstacles, state.agents_xy, state.targets_xy, state.active)
    gen = torch.Generator(device=card).manual_seed(3)
    h = (torch.rand(4, 8, 128, device=card, generator=gen) * 2 - 1).to(torch.bfloat16)
    strided = torch.zeros(4, 8, 256, dtype=torch.bfloat16, device=card)[..., ::2]
    strided.copy_(h)
    shifted = torch.zeros(4 * 8 * 128 + 1, dtype=torch.bfloat16, device=card)[1:].view(4, 8, 128)
    shifted.copy_(h)
    with torch.inference_mode():
        before = cuda_policy.policy_cuda.launches
        want = model.step_from_state(*args, h)
        for other in (strided, shifted):
            got = model.step_from_state(*args, other)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert cuda_policy.policy_cuda.launches - before == 3
