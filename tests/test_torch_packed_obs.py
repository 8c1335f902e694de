"""The packed observation of pogema_torch (K1b) against pogema_tpu.

``ops.windows.packed_observation_ref``, the plain version of the
packed-observation kernel, against ``jax.vmap(pogema_tpu.core.obs.observe)``
with ``obs_layout='packed'`` on numpy inputs made from a seed: bit-equal.
The semantics the kernel must keep each have a case (counts of agents that
share a cell, an inactive agent that does not see itself, targets clamped
per axis, zeros outside the grid), and a numpy model of the kernel's own
algorithm (obstacle bytes and occupancy counts in one grid, both read by
the same window addressing) is held to the plain version where the
wrapper's precondition holds. The wrappers' refusals and the choice of
centres per block run without a card; the kernels themselves need one
(marker ``cuda``) and skip without it.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pogema_torch
import pogema_torch.grid_config as tgc
import pogema_tpu.core.obs as jobs
import pogema_tpu.grid_config as jgc
from pogema_torch.core import obs as tobs
from pogema_torch.ops import build, cuda_windows
from pogema_torch.ops import windows as tw

from torch_parity import assert_trees_equal


def _static(mod, n, r, size, layout="packed"):
    cfg = mod.GridConfig(size=size, num_agents=n, obs_radius=r).to_static()
    kv = {k: getattr(cfg, k) for k in mod.StaticConfig.__slots__}
    kv["obs_layout"] = layout
    return mod.StaticConfig(**kv)


def _inputs(seed, b, n, r, size):
    """A bordered grid; agents anywhere inside the padded grid, a quarter of
    them on the padding's outer or inner border rows, some sharing a cell;
    targets up to a grid's width outside the grid; a third inactive."""
    rng = np.random.default_rng(seed)
    p = size + 2 * r
    grid = np.ones((b, p, p), np.uint8)
    grid[:, r:r + size, r:r + size] = rng.integers(0, 2, (b, size, size))
    agents = rng.integers(r, p - r, (b, n, 2)).astype(np.int32)
    edges = np.array([0, r, p - 1 - r, p - 1], np.int32)
    agents = np.where(rng.random((b, n, 2)) < 0.25, edges[rng.integers(0, 4, (b, n, 2))], agents)
    targets = rng.integers(-p, 2 * p, (b, n, 2)).astype(np.int32)
    active = rng.random((b, n)) >= 1 / 3
    return grid, agents.astype(np.int32), targets, active


def _jax_packed(grid, agents, targets, active, r, size):
    cfg = _static(jgc, agents.shape[1], r, size)
    return jax.vmap(partial(jobs.observe, cfg))(
        jnp.asarray(grid), jnp.asarray(agents), jnp.asarray(targets), jnp.asarray(active))


def _ref(grid, agents, targets, active, w):
    return tw.packed_observation_ref(torch.as_tensor(grid), torch.as_tensor(agents),
                                     torch.as_tensor(targets), torch.as_tensor(active), w)


@pytest.mark.parametrize("n", [1, 12, 64])
@pytest.mark.parametrize("w", [3, 5, 11])
def test_packed_observation_ref_matches_jax(w, n):
    r, size = w // 2, 14
    args = _inputs(100 * w + n, 3, n, r, size)
    got = _ref(*args, w)
    assert got.shape == (3, n, 3 * w * w) and got.dtype == torch.float32
    assert_trees_equal(_jax_packed(*args, r, size), got)
    # On CPU tensors the kernel's wrapper is its plain version, and counts no launch.
    before = cuda_windows.packed_observation_cuda.launches
    cpu = cuda_windows.packed_observation_cuda(*(torch.as_tensor(a) for a in args), w)
    assert torch.equal(cpu, got) and cuda_windows.packed_observation_cuda.launches == before


def _blocks(obs, w):
    b, n, _ = obs.shape
    return obs.reshape(b, n, 3, w, w)


def test_agents_block_counts_agents_that_share_a_cell():
    # Three active agents and one inactive on one cell, a fifth next to it.
    w, r, size = 5, 2, 8
    grid = np.zeros((1, size + 2 * r, size + 2 * r), np.uint8)
    agents = np.array([[[5, 5], [5, 5], [5, 5], [5, 5], [5, 6]]], np.int32)
    active = np.array([[True, True, True, False, True]])
    args = (grid, agents, agents.copy(), active)
    got = _ref(*args, w)
    assert_trees_equal(_jax_packed(*args, r, size), got)
    agents_block = _blocks(got, w)[0, :, 1]
    assert agents_block[0, r, r] == 3 and agents_block[0, r, r + 1] == 1  # a count, self included
    assert agents_block[3, r, r] == 3  # the inactive agent sees the others, not itself
    assert agents_block[4, r, r - 1] == 3 and agents_block[4, r, r] == 1


def test_inactive_agent_does_not_see_itself_and_is_seen_by_nobody():
    w, r, size = 3, 1, 6
    grid = np.zeros((1, size + 2 * r, size + 2 * r), np.uint8)
    agents = np.array([[[3, 3], [3, 4]]], np.int32)
    args = (grid, agents, agents.copy(), np.array([[False, True]]))
    got = _ref(*args, w)
    assert_trees_equal(_jax_packed(*args, r, size), got)
    agents_block = _blocks(got, w)[0, :, 1]
    assert agents_block[0].sum() == 1 and agents_block[0, r, r] == 0 and agents_block[0, r, r + 1] == 1
    assert agents_block[1].sum() == 1 and agents_block[1, r, r] == 1 and agents_block[1, r, r - 1] == 0


def test_target_is_clamped_onto_the_border_per_axis():
    w, r, size = 5, 2, 10
    grid = np.zeros((1, size + 2 * r, size + 2 * r), np.uint8)
    agents = np.full((1, 4, 2), 7, np.int32)
    targets = np.array([[[7, 7], [0, 8], [13, -40], [8, 99]]], np.int32)
    args = (grid, agents, targets, np.ones((1, 4), bool))
    got = _ref(*args, w)
    assert_trees_equal(_jax_packed(*args, r, size), got)
    target_block = _blocks(got, w)[0, :, 2]
    assert (target_block.sum(dim=(1, 2)) == 1).all()
    for i, (x, y) in enumerate([(r, r), (0, r + 1), (w - 1, 0), (r + 1, w - 1)]):
        assert target_block[i, x, y] == 1


def test_cells_outside_the_grid_read_zero_in_the_obstacle_block():
    w, r, size = 5, 2, 6
    p = size + 2 * r
    grid = np.ones((1, p, p), np.uint8)
    agents = np.array([[[0, 0], [p - 1, p - 1], [0, p - 1]]], np.int32)
    args = (grid, agents, agents.copy(), np.ones((1, 3), bool))
    got = _ref(*args, w)
    assert_trees_equal(_jax_packed(*args, r, size), got)
    obstacle_block = _blocks(got, w)[0, :, 0]
    assert obstacle_block[0, :r].sum() == 0 and obstacle_block[0, :, :r].sum() == 0
    assert (obstacle_block[0, r:, r:] == 1).all() and (obstacle_block[1, : r + 1, : r + 1] == 1).all()
    assert obstacle_block.sum() == 3 * (r + 1) ** 2


def _occupancy_model(grid, agents, targets, active, w):
    """The kernel's algorithm in numpy: per env one grid of cells, each the
    obstacle byte and a count of the active agents inside the grid; both
    window blocks read it at the same addresses, the target block is one
    lane per agent."""
    b, n, _ = agents.shape
    p, r = grid.shape[-1], w // 2
    out = np.zeros((b, n, 3, w, w), np.float32)
    for e in range(b):
        count = np.zeros((p, p), np.int64)
        for m in range(n):
            x, y = agents[e, m]
            if active[e, m] and 0 <= x < p and 0 <= y < p:
                count[x, y] += 1
        for a in range(n):
            for i in range(w):
                for j in range(w):
                    x, y = agents[e, a, 0] - r + i, agents[e, a, 1] - r + j
                    if 0 <= x < p and 0 <= y < p:
                        out[e, a, 0, i, j] = grid[e, x, y]
                        out[e, a, 1, i, j] = count[x, y]
            tx, ty = np.clip(targets[e, a] - agents[e, a], -r, r) + r
            out[e, a, 2, tx, ty] = 1
    return out.reshape(b, n, 3 * w * w)


@pytest.mark.parametrize("w,n", [(3, 12), (5, 1), (5, 12), (11, 7)])
def test_occupancy_form_equals_pairwise_form_inside_the_grid(w, n):
    # The wrapper's precondition: every agent inside the P x P grid.
    args = _inputs(7 * w + n, 2, n, w // 2, 12)
    p = args[0].shape[-1]
    assert (args[1] >= 0).all() and (args[1] < p).all()
    np.testing.assert_array_equal(_occupancy_model(*args, w), _ref(*args, w).numpy())


def test_occupancy_form_differs_outside_the_grid_as_documented():
    # Two active agents outside the grid, next to each other: the pairwise
    # form shows each to the other, a grid of counts cannot hold them. The
    # wrapper states this as its precondition; env states never get there.
    w, p = 3, 6
    grid = np.zeros((1, p, p), np.uint8)
    agents = np.array([[[-1, 2], [-1, 3]]], np.int32)
    args = (grid, agents, agents.copy(), np.ones((1, 2), bool))
    pairwise = _blocks(_ref(*args, w), w)[0, :, 1]
    counted = _occupancy_model(*args, w).reshape(1, 2, 3, w, w)[0, :, 1]
    assert pairwise[0].sum() == 2 and counted.sum() == 0
    assert "inside" in cuda_windows.packed_observation_cuda.__doc__


@pytest.mark.parametrize("collision_system", ["priority", "block_both", "soft"])
def test_env_states_keep_every_agent_inside_the_padded_border(collision_system):
    gc = pogema_torch.GridConfig(size=8, num_agents=6, obs_radius=2, max_episode_steps=12,
                                 collision_system=collision_system, on_target="restart")
    core = pogema_torch.PogemaCore(gc, num_envs=4, device="cpu", obs_layout="packed",
                                   auto_reset_mode="regen")
    state, _ = core.reset(3)
    init, rng = state, np.random.default_rng(3)
    r, p = core.cfg.obs_radius, state.obstacles.shape[-1]
    for _ in range(30):
        actions = torch.as_tensor(rng.integers(0, 5, (4, 6)), dtype=torch.int32)
        state, obs, res, _, _ = core.step_autoreset(state, init, actions)
        assert (state.agents_xy >= r).all() and (state.agents_xy < p - r).all()
        args = (state.obstacles.numpy(), state.agents_xy.numpy(), state.targets_xy.numpy(),
                state.active.numpy())
        np.testing.assert_array_equal(_occupancy_model(*args, core.cfg.window), obs.numpy())


@pytest.mark.parametrize("n", [1, 6])
def test_packed_observation_is_the_grid_layout_reshaped(n):
    w, r, size = 5, 2, 9
    grid, agents, targets, active = (torch.as_tensor(a) for a in _inputs(n, 3, n, r, size))
    packed = tobs.packed_observation(w, grid, agents, targets, active)
    stacked = tobs.observe(_static(tgc, n, r, size, "grid"), grid, agents, targets, active)
    assert stacked.shape == (3, n, 3, w, w)
    assert torch.equal(packed, stacked.reshape(3, n, 3 * w * w))
    assert torch.equal(packed, tobs.observe(_static(tgc, n, r, size), grid, agents, targets, active))
    # Views of the per-agent tensors are copied by the caller's side of the wrapper.
    wide = torch.stack([agents, agents], dim=1)[:, 1]
    assert not wide.is_contiguous() or n == 1
    assert torch.equal(tobs.packed_observation(w, grid, wide, targets, active), packed)


def _good(b=2, p=10, n=4):
    return [torch.zeros(b, p, p, dtype=torch.uint8), torch.zeros(b, n, 2, dtype=torch.int32),
            torch.zeros(b, n, 2, dtype=torch.int32), torch.ones(b, n, dtype=torch.bool)]


def _bad(index, make):
    args = _good()
    args[index] = make(args[index])
    return args


REFUSED = {
    "grid dtype": (TypeError, _bad(0, lambda t: t.float())),
    "agents dtype": (TypeError, _bad(1, lambda t: t.long())),
    "targets dtype": (TypeError, _bad(2, lambda t: t.float())),
    "active dtype": (TypeError, _bad(3, lambda t: t.to(torch.uint8))),
    "grid not square": (ValueError, _bad(0, lambda t: t[:, :, :9].contiguous())),
    "grid rank": (ValueError, _bad(0, lambda t: t[0])),
    "agents batch": (ValueError, _bad(1, lambda t: t[:1])),
    "targets count": (ValueError, _bad(2, lambda t: t[:, :3].contiguous())),
    "agents last dim": (ValueError, _bad(1, lambda t: torch.zeros(2, 4, 3, dtype=torch.int32))),
    "active shape": (ValueError, _bad(3, lambda t: t[:, :, None])),
    "grid view": (ValueError, _bad(0, lambda t: torch.zeros(2, 10, 20, dtype=torch.uint8)[:, :, ::2])),
    "agents view": (ValueError, _bad(1, lambda t: torch.zeros(2, 4, 4, dtype=torch.int32)[:, :, ::2])),
    "active view": (ValueError, _bad(3, lambda t: torch.ones(4, 2, dtype=torch.bool).t())),
    "agents on another device": (ValueError, _bad(1, lambda t: t.to("meta"))),
    "everything on a device that is neither": (ValueError, [t.to("meta") for t in _good()]),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_packed_observation_wrapper_refuses(case):
    error, args = REFUSED[case]
    with pytest.raises(error):
        cuda_windows.packed_observation_cuda(*args, 5)


@pytest.mark.parametrize("case", [c for c in sorted(REFUSED) if "target" not in c and "active" not in c])
def test_packed_windows_wrapper_refuses(case):
    error, args = REFUSED[case]
    with pytest.raises(error):
        cuda_windows.extract_windows_packed(args[0], args[1], 5)


@pytest.mark.parametrize("w", [0, 4, -3])
def test_wrappers_refuse_even_or_empty_windows(w):
    with pytest.raises(ValueError):
        cuda_windows.packed_observation_cuda(*_good(), w)
    with pytest.raises(ValueError):
        cuda_windows.extract_windows_packed(*_good()[:2], w)


@pytest.mark.parametrize("b,m,k1,k1b", [(4096, 128, 64, 128), (4096, 64, 33, 64), (1024, 128, 33, 64),
                                       (128, 128, 33, 32), (1, 128, 1, 4), (16384, 8, 8, 8)])
def test_centres_per_block_at_the_measured_shapes(b, m, k1, k1b):
    # 132 SMs, a 74 x 74 grid, w = 11: the choices that PERF.md's sweep table names.
    pick = cuda_windows.centres_per_block
    assert pick(b, m, 132, 74 * 74, 4 * 128, cuda_windows.K1_AMORTISE, cuda_windows.K1_FILL) == k1
    assert pick(b, m, 132, 74 * 74, 12 * 121, cuda_windows.K1B_AMORTISE, cuda_windows.K1B_FILL,
                multiple=4) == k1b


@pytest.mark.parametrize("multiple", [1, 4])
def test_centres_per_block_stays_in_range(multiple):
    for b in (1, 2, 7, 100, 5000):
        for m in (1, 2, 3, 4, 5, 12, 37, 64, 1000):
            for grid_bytes, row_bytes in ((169, 108), (5476, 512), (70756, 1452)):
                mc = cuda_windows.centres_per_block(b, m, 132, grid_bytes, row_bytes, 3, 8, multiple)
                assert 1 <= mc <= m
                assert mc % multiple == 0 or mc == m


def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch):
    # The CUDA branch of both wrappers gets its functions from _prepare
    # alone; a build that fails must come out of it as an error.
    def boom(name):
        raise RuntimeError("nvcc failed for windows")

    monkeypatch.setattr(build, "load", boom)
    monkeypatch.setattr(cuda_windows, "_fns", {})
    monkeypatch.setattr(cuda_windows, "_devices", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_windows._prepare(torch.device("cuda", 0))
    assert cuda_windows._devices == {}


def _card_inputs(seed, b, p, n, r):
    g = torch.Generator().manual_seed(seed)
    grid = (torch.rand(b, p, p, generator=g) < 0.3).to(torch.uint8)
    agents = torch.randint(0, p, (b, n, 2), generator=g, dtype=torch.int32)
    targets = torch.randint(-p, 2 * p, (b, n, 2), generator=g, dtype=torch.int32)
    active = torch.rand(b, n, generator=g) >= 1 / 3
    return grid, agents, targets, active


@pytest.mark.cuda
def test_k1b_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1b kernel has no CPU mode")
    kernel = cuda_windows.packed_observation_cuda
    shapes = ((3, (8, 20, 5)), (5, (64, 40, 37)), (11, (256, 74, 64)), (13, (16, 50, 12)),
              (11, (128, 74, 128)), (11, (5, 13, 1)))  # (128, 74, 128): every env split over blocks
    for w, (b, p, n) in shapes:
        args = _card_inputs(w + b, b, p, n, w // 2)
        want = tw.packed_observation_ref(*args, w)
        for centres in (None, 1, min(4, n)):
            before = kernel.launches
            on_card = [a.cuda() for a in args]
            got = (kernel(*on_card, w) if centres is None
                   else cuda_windows._launch_observation(*on_card, w, centres))
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            assert torch.equal(got.cpu(), want), (w, b, p, n, centres)
    with pytest.raises(ValueError):
        kernel(on_card[0], on_card[1], args[2], on_card[3], 11)  # targets left on the CPU
    with pytest.raises(ValueError):
        kernel(on_card[0], torch.stack([on_card[1]] * 2, 1)[:, 0], on_card[2], on_card[3], 11)


@pytest.mark.cuda
def test_k1b_counts_255_256_and_300_agents_on_a_cell_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the counts are the kernel's shared-memory cells")
    grid = torch.zeros(1, 12, 12, dtype=torch.uint8, device="cuda")
    for count in (255, 256, 300):  # the 16-bit cell's most, and the split layout past it
        for cell in ((6, 6), (6, 7)):  # the low and the high half of a shared word
            xy = torch.tensor(cell, dtype=torch.int32, device="cuda").expand(1, count, 2)
            xy = xy.contiguous()
            args = (grid, xy, xy, torch.ones(1, count, dtype=torch.bool, device="cuda"))
            got = cuda_windows.packed_observation_cuda(*args, 3)
            assert torch.equal(got, tw.packed_observation_ref(*args, 3)), (count, cell)
            assert (got[0, :, 9 + 4] == count).all()
    over = torch.zeros(1, cuda_windows.K1B_MAX_AGENTS + 1, 2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="65535 agents"):
        cuda_windows.packed_observation_cuda(grid, over, over, over[..., 0] == 0, 3)


@pytest.mark.parametrize("n,wide", [(1, False), (64, False), (255, False), (256, True),
                                    (300, True), (1024, True)])
def test_k1b_layout_and_shared_memory_by_agent_count(n, wide):
    # Up to 255 agents the 16-bit cell (an 8-bit count above the obstacle
    # byte), as configs C and D always ran; the split layout above it adds
    # the obstacle bytes beside 16-bit counts.
    assert cuda_windows.observation_wide(n) is wide
    smem = cuda_windows.observation_smem_bytes
    packed = 2 * (74 * 74 + 4) + 16 * 65 + 1456  # P = 74, w = 11, 64 agents per block
    assert smem(74, 11, 64, False) == packed == 13456
    assert smem(74, 11, 64, True) == packed + 74 * 74 + 16
    assert smem(138, 11, 256, True) == 38096 + 16 * 257 + 1456 + 19044 + 16 == 62724
    assert smem(13, 3, 4, True) == 352 + 80 + 112 + 169 + 16  # each part rounded to 16 bytes


def test_k1b_fill_follows_shared_memory():
    # Configs C and D keep K1B_FILL blocks per SM; config E's split layout
    # at P = 138 fits three blocks of 256 agents in an SM's 228 KB.
    fill = cuda_windows.observation_fill
    assert fill(74, 11, 64) == fill(74, 11, 128) == cuda_windows.K1B_FILL == 8
    assert fill(138, 11, 256) == 3 and fill(138, 11, 255) == 5
    pick = cuda_windows.centres_per_block
    assert pick(1024, 256, 132, 138 * 138, 12 * 121, cuda_windows.K1B_AMORTISE,
                fill(138, 11, 256), multiple=4) == 256
    assert pick(4, 256, 132, 138 * 138, 12 * 121, cuda_windows.K1B_AMORTISE,
                fill(138, 11, 256), multiple=4) == 4


@pytest.mark.cuda
def test_a_failed_build_raises_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: only CUDA tensors reach the kernels")

    def boom(name):
        raise RuntimeError("nvcc failed for windows")

    monkeypatch.setattr(build, "load", boom)
    monkeypatch.setattr(cuda_windows, "_fns", {})
    monkeypatch.setattr(cuda_windows, "_devices", {})
    args = [a.cuda() for a in _card_inputs(0, 4, 20, 6, 2)]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_windows.packed_observation_cuda(*args, 5)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_windows.extract_windows_packed(args[0], args[1], 5)
