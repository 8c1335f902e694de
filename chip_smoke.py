"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure is reported; any failure exits 1 and prints no
result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``pogema_torch/csrc`` (one nvcc each,
     all at once) into ``build/kernels``;
  3. hold both hand-written kernels bit for bit against their plain
     PyTorch versions: K1, the packed obstacle windows, at config C's
     shapes, at B in (1, 128), at P in (13, 40, 74) (every alignment of an
     env's grid) and w in {3, 5, 11, 13} with centres on the padding
     border; K1b, the whole packed observation, at the shapes of config
     C, config-D serving, the recurrent update and one env (B = 1, N = 64
     and 128), with a third of the agents inactive, agents sharing cells,
     targets far outside the window, N in (1, 12), the same P and w, and
     a view refused, and 255 agents counted on one cell. Each is
     timed beside its memory bound, its plain version and a library
     yardstick, by CUDA events around eager calls and by replaying a CUDA
     graph of some tens of launches (the device time of one launch);
     then k1b_wide: K1b past 255 agents per env (the split layout of
     16-bit counts) bit-equal at N = 256, 300 and 1024 and with 256 and
     300 agents on one cell, and every packed path at N = 256 with its
     launches counted exactly (PogemaCore at 16 x 256 x 128x128, the
     recurrent and 'windows' train steps at 16 x 256, PogemaVectorEnv at
     8 x 256, each against the CPU), then K1b timed at config E's
     serving shape; then k7: the threefry kernel K7 bit-equal to its plain
     version at the cached select's split of 4096 keys and the
     placement's bits at [1024, 74*74] and [4096, 74*74] (offsets 0 and
     above 2**32, fold_in of a scalar and per key), and timed at the
     select's and the placement's shapes beside its bound and the plain
     version; then k2: the 'priority' collision kernel K2 bit-equal to its
     plain version (the fixpoint of ``ops/collisions.py``) at the shapes
     of C.random, D.serve and E.serve, crowded, at one warp a block and
     past shared memory, and timed at the three cells' shapes beside its
     bound and the fixpoint; then k8: the served recurrent policy step
     K8 timed alone at D.serve's and E.serve's rows (131,072 with
     rec128_ft and 262,144 with maze256) beside its bound and the plain
     version (its checks are ``tests/test_torch_policy_card.py``'s); then
     k4: the component labels' kernel K4 bit-equal to its plain version
     (the flood fill of ``ops/components.py``) at D.serve's and E.serve's
     grids, and timed alone at the two cells' shapes beside its byte
     bound and the plain version; then k9: the placement kernel K9
     bit-equal to its plain version (the loop over the agents of
     ``ops/placement.py``) at C.regen's, D.serve's and E.serve's worlds,
     timed alone at the three shapes beside its bound (the hashes the
     semantics cannot skip) and the plain version, and launched once in
     C.regen's ending step (one placement try);
  4. every collision system x on_target, cached and regen auto-reset: a
     small reset and 64 ``step_autoreset`` steps on the card must equal
     the same run on the CPU bit for bit (the CPU run is held against
     the JAX package by the tests);
  5. the main path: config C (4096 envs x 64 agents, 64x64 mazes, obs
     radius 5, priority collisions, 'finish', cached auto-reset, packed
     observations) reset on the card, then 768 ``step_autoreset`` steps
     with actions from a CUDA generator, with its invariants checked and
     the kernels' launches counted (K1b twice per step, K1 never, K7 and
     K2 once per step, no fixpoint pass; the benchmark's cell ``C.random``
     times such steps); then ``pomapf``, the same
     config with ``observation_type='POMAPF'`` for 64 steps, the
     full-width path that launches K1 (once per step);
  6. policy: the shipped ``.ckpt_rec128_ft`` weights (committed as
     ``pogema_torch/weights/rec128_ft.npz``) in bf16 on 64 config-D
     states: K1 and K1b bit-equal at M = N = 128, logits and values within
     POLICY_TOL of the same module on the CPU, greedy actions equal where
     the CPU's top-2 margin exceeds twice that;
  7. serve, the evaluation path at full width: ``make_policy_evaluator``
     on config D (1024 envs x 128 agents, LifeLong 64x64, r=5) with those
     weights, 3 greedy episodes (the benchmark's cell ``D.serve`` times
     such episodes), K1b, K2 and K8 launched exactly once per step, K7 10
     times an episode and 3 times per placement try, K4 and K9 once per
     placement try and no flood-fill sweep, invariants and metrics
     checked;
     then serve_e, config E (1024 envs x 256 agents, 128x128 worlds of
     the mixed random + maze pool, packed) served with the shipped
     ``.ckpt_maze256`` weights (``weights/maze256.npz``) in bf16: a
     warm-up and 2 greedy episodes, K1b, K2 and K8 once per step, K4 and
     K9 once per placement try and no sweep (their timing is
     the benchmark's cell ``E.serve``), the policy card vs CPU at B = 2,
     and the eval ladder's config-E leg (PPO and random through
     ``toolbox.evaluate``, K1 steps + 1 times each);
  8. serve_agree: both evaluators (policy, f32 model; planner) on the
     card and on the CPU with the same keys must agree bit for bit (the
     policy may first differ only at a near-tie, which is printed);
  9. planner: ``evaluate_planner`` at config-C shapes with 1024 envs:
     the fields' time and sweeps, fields against the CPU, the episode;
 10. rim_agree: the host rim on the card against the rim on the CPU, bit
     for bit: a ``pogema_v0`` episode (16x16, 8 agents) for each on_target
     x observation type, and 16 steps of ``PogemaVectorEnv`` (packed and
     grid, cached and regen);
 11. rim_env: ``pogema_v0`` at 64x64 with 64 agents, r=5, one 'finish'
     and one 'restart' episode of random actions (K1 launched exactly once
     per step and once per reset): ms per step, split into the actions'
     upload, the core step and the host copy; then ``toolbox.PPOPolicy``
     with the shipped weights on one config-D env for 128 steps, ms per
     act, against the CPU;
 12. rim_vector: ``PogemaVectorEnv`` at config C's widths with 1024 envs,
     64 steps packed (K1b 129 launches), 64 steps grid (K1 65: a cached
     step's two observation sets share one launch) and 16 steps POMAPF,
     episodes cut so that every env ends inside the window: bytes copied
     to the host and terminal rows (the rim's counters); observations and
     terminal observations of a sample of envs against the plain
     observation (the benchmark's cell ``rim.vector`` times this path);
 13. rim_toolbox: ``toolbox.evaluate`` with A* and the planner on a
     registry map and on random 32x32 maps, card == CPU;
 14. train_agree: two PPO train steps of each flavour (observation-based,
     fused 'windows', fused 'pre', recurrent) at a small f32 size on the
     card and on the CPU from the same numpy state: integer state and key
     bit-equal (or first differing at a near-tie of a sampled action,
     which is printed), stats, first-minibatch gradients and parameters
     within the tolerances stated at TRAIN_*_TOL; K1 and K1b against their
     plain versions at the update's shapes, from non-contiguous callers;
 15. train, the training path at full width: three recurrent PPO train
     steps on config D (1024 envs x 128 agents, regen auto-reset) from the
     shipped weights in bf16: stats, the split of each step's seconds,
     peak memory, K1b launched exactly 64 + 1 + 2*8*64 times per step
     and K8 never (the learner runs outside inference mode);
 16. train_ff: three fused train steps at 1024 envs x 8 agents, 16x16
     (embed/hidden 256, 'auto' picks 'pre': no kernel launch, the grid
     convolutions counted), then one step with obstacle_path='windows'
     (K1b 64 + 1 + 2*4 times);
 17. mesh_one: the multi-device learner (``pogema_torch.parallel.mesh``)
     on a mesh of one NCCL rank: two train steps of each flavour at the
     train_agree size with the mesh against ``mesh=None``, integer state
     and key equal, floats within TRAIN_*_TOL;
 18. mesh_gloo: four ranks on the card over gloo with CUDA tensors
     (``chip_smoke.py --mesh-worker``, started with torchrun's
     environment), meshes data = 4 and data 2 x model 2: the same small
     agreement for every flavour, then one config-D recurrent train step
     (rec128_ft bf16, T = 64, 2 x 8 minibatches) against the one-process
     step from the same state: each rank's initial rows, the share of
     rollout actions that agree, the stats and their largest difference,
     K1b launches per rank (exact: the rollout, the bootstrap and each
     replayed step of a minibatch share the rank holds) and their sum,
     seconds by part, bytes all-reduced and all-gathered per step; then
     ``dryrun_multichip(4)``;
 19. mesh_nccl: the cases of mesh_gloo over NCCL, one rank per card, on
     min(4, cards) cards; on one card it prints "not run (1 card)";
then k1_shapes (both kernels timed at the serving and the update shape
and for one env of 64 and of 128 agents, and at three shapes for 16 to
128 centres per block), one JSON line listing the kernels and, last, the
ok line.

    python3 chip_smoke.py --fixed-units C.random 2613000120 128

runs a benchmark cell's set-up and then its first units on one seed and
prints the collision fixpoint's passes over them with digests of what
they left, so two checkouts compare that counter over the same units
(``fixed_units``).

Needs one CUDA device; exits non-zero without one, and outside a
checkout of the repository.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper white paper).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# threefry2x32-20 of one counter: 20 rounds of add, rotate and xor and 5
# key injections (csrc/threefry.cu).
K7_OPS_PER_COUNTER = 80
# The same hash counted instruction by instruction where its key is fixed
# over a loop, as in K9's: 20 rounds of add, rotate and xor, 10 key adds,
# the counter's key add and the closing xor. The card issues at most one
# warp instruction a clock in each of an SM's 4 partitions, whatever the
# pipe: K9 at E.serve hashed faster than K7's 80 operations on the INT32
# lanes alone would allow, so those lanes are not its limit.
K9_OPS_PER_HASH = 72
INSTRUCTIONS_PER_S = 132 * 4 * 32 * 1.98e9

CONFIG_C = dict(size=64, num_agents=64, obs_radius=5, max_episode_steps=128,
                collision_system="priority", on_target="finish")
NUM_ENVS_C = 4096
MAIN_STEPS = 768

# Config D (README): LifeLong 64x64, 128 agents, r=5, served with the
# shipped .ckpt_rec128_ft weights.
CONFIG_D = dict(size=64, num_agents=128, obs_radius=5, density=0.3, on_target="restart",
                max_episode_steps=128)
NUM_ENVS_D = 1024
SERVE_EPISODES = 3
WEIGHTS = os.path.join(ROOT, "pogema_torch", "weights", "rec128_ft.npz")
# Card against cpu for the bf16 policy, |diff| / max(1, |cpu|): the card
# sums its f32 GEMMs in another order and its exp and tanh differ from the
# cpu's in the last f32 bits, so a bf16 rounding may land one ulp (2^-8)
# apart and carry through the GRU and the head. The cpu tests hold the
# port to flax by the same bound.
POLICY_TOL = 1e-2
# Config E (BASELINE.md row E): LifeLong 128x128 worlds drawn from the
# mixed random + braided-maze pool (maps.mixed_pool), 256 agents, r=5,
# served with the shipped .ckpt_maze256 weights (committed as
# weights/maze256.npz); depth cut from 8192 envs to 1024.
CONFIG_E = dict(size=128, num_agents=256, obs_radius=5, density=0.3, on_target="restart",
                max_episode_steps=128)
NUM_ENVS_E = 1024
WEIGHTS_E = os.path.join(ROOT, "pogema_torch", "weights", "maze256.npz")
# The config-E leg of examples/eval_ladder.py: one seed, its world drawn
# from the pool as the ladder draws it.
LADDER_SEED = 1001
# The planner at config-C shapes with a quarter of config C's envs.
PLANNER_ENVS = 1024
# The host rim: one pogema_v0 env the size of config C's worlds (64x64, 64
# agents, r=5, 128 steps), and PogemaVectorEnv at config C's widths with a
# quarter of its envs (1024 x 64 agents), its episodes cut to end inside
# the timed window.
RIM_ENV = dict(size=64, num_agents=64, obs_radius=5, density=0.3, max_episode_steps=128, seed=0)
RIM_VECTOR_ENVS = 1024

# Training at full width: the README's config-D fine-tune and its first
# learner command.
TRAIN_D_PPO = dict(rollout_steps=64, epochs=2, minibatches=8, lr=1.5e-4, entropy_coef=0.003)
TRAIN_FF_GRID = dict(size=16, num_agents=8, obs_radius=5, density=0.3, on_target="restart",
                     max_episode_steps=128)
TRAIN_FF_PPO = dict(rollout_steps=64, epochs=2, minibatches=4)
TRAIN_STEPS = 3
# episode_avg_throughput (goals per step per env) of the second config-D
# train step, the one in which every episode ends. Greedy serving of the
# same weights gives 1.78-1.90; the rollout samples its actions, and one
# PPO update at lr 1.5e-4 lies between. Measured 1.87 on an H100: the
# shipped policy's entropy is 0.3, so sampling costs it little.
TRAIN_D_THROUGHPUT = (1.2, 2.0)
# train_agree, card against cpu, f32 model. Same ops on both devices, but
# the card sums its GEMMs, convolutions and reductions in another order,
# its exp/log/tanh differ in the last bits, and the backward passes of the
# row gathers add with float atomics in no fixed order. Stats: absolute,
# relative where the value exceeds 1. Gradients and Adam's first moment:
# relative to the largest gradient entry. Parameters: absolutely within
# 2 * lr * (Adam steps taken), the most that sign flips of ill-conditioned
# first Adam steps (about -lr * sign(g), so where |g| is near eps noise
# decides the sign) could move a weight, and 99% of all entries within
# TRAIN_PARAM_TOL. Measured on an H100: stats 1.5e-7, gradients 4.4e-7,
# parameters 3.3e-7 at most.
TRAIN_STATS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-5
TRAIN_PARAM_TOL = 1e-5


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, launches=20, replays=5):
    """Device time of one call of ``fn``, free of the host's enqueue rate:
    ``launches`` calls are captured into one CUDA graph, which is replayed
    between two events. Every call's result is kept until the reading is
    done, so each call writes memory of its own, as calls of a real step
    do, and a small output cannot stay in the L2 cache from one call to
    the next."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph, keep = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(launches):
            keep.append(fn())
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (launches * replays)
    del graph, keep
    return ms


def random_windows_inputs(b, p, m, r, device, seed, border=False):
    """u8 grid [B, P, P] and i32 centres [B, M, 2]; with ``border`` the
    centres also sit on the padding's outer and inner border rows."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    grid = (torch.rand(b, p, p, generator=g) < 0.3).to(torch.uint8)
    xy = torch.randint(r, p - r, (b, m, 2), generator=g, dtype=torch.int32)
    if border:
        edges = torch.tensor([0, r, p - 1 - r, p - 1], dtype=torch.int32)
        pick = torch.randint(0, 4, (b, m, 2), generator=g)
        xy = torch.where(torch.rand(b, m, 2, generator=g) < 0.5, edges[pick], xy)
    return grid.to(device), xy.to(device)


def random_obs_inputs(b, p, n, r, device, seed, border=False):
    """Inputs of the packed observation: the grid and centres of
    :func:`random_windows_inputs` (agents may share a cell: the agents
    block counts), targets anywhere from a grid's width outside the grid
    to inside the window (most are clamped onto the border), and a third
    of the agents inactive."""
    import torch

    grid, axy = random_windows_inputs(b, p, n, r, device, seed, border)
    g = torch.Generator(device="cpu").manual_seed(seed + 1000)
    txy = torch.randint(-p, 2 * p, (b, n, 2), generator=g, dtype=torch.int32)
    near = axy.cpu() + torch.randint(-r, r + 1, (b, n, 2), generator=g, dtype=torch.int32)
    txy = torch.where(torch.rand(b, n, 1, generator=g) < 0.25, near, txy)
    active = torch.rand(b, n, generator=g) >= 1 / 3
    return grid, axy, txy.to(device), active.to(device)


def _kernels():
    from pogema_torch.ops import cuda_windows

    return cuda_windows.extract_windows_packed, cuda_windows.packed_observation_cuda


def _expect_refused(fn, what):
    try:
        fn()
    except ValueError:
        return
    raise AssertionError(f"{what} was not refused")


def phase_k1(device, b, p, n, r):
    """Phase 3, K1. Returns the kernel record (without ``launches``)."""
    import torch

    from pogema_torch.ops.windows import extract_windows_packed_ref, packed_lanes

    from pogema_torch.ops.cuda_windows import _launch_windows

    kernel, _ = _kernels()
    saved = kernel.launches
    # Config C's shapes: a reset (M = N) and a cached step (M = 2N); one
    # env, and the recurrent update's batch, which splits every env over
    # several blocks.
    for bb, m in ((b, n), (b, 2 * n), (1, n), (1, 2 * n), (128, 2 * n)):
        grid, xy = random_windows_inputs(bb, p, m, r, device, seed=m + bb)
        got, ref = kernel(grid, xy, 2 * r + 1), extract_windows_packed_ref(grid, xy, 2 * r + 1)
        if not torch.equal(got, ref):
            raise AssertionError(f"K1 differs from its plain version at B={bb} M={m}: "
                                 f"max |diff| {(got - ref).abs().max().item()}")
    # Grids whose rows of an env start at every alignment (13 * 13 and
    # 40 * 40 and 74 * 74 bytes per env), centres on the borders.
    for pp, w in ((40, 3), (40, 5), (40, 11), (40, 13), (13, 3), (13, 11), (13, 13), (74, 11)):
        grid, xy = random_windows_inputs(64, pp, 37, w // 2, device, seed=w + pp, border=True)
        ref = extract_windows_packed_ref(grid, xy, w)
        for centres in (None, 1, 5, 37):
            got = kernel(grid, xy, w) if centres is None else _launch_windows(grid, xy, w, centres)
            if got.shape != (64, 37, packed_lanes(w)) or not torch.equal(got, ref):
                raise AssertionError(f"K1 differs from its plain version at P={pp} w={w} "
                                     f"centres per block {centres} (border cases)")
    print(f"K1 bit-equal to its plain version: P={p}, (B, M) in ({b}, {n}), ({b}, {2 * n}), "
          f"(1, {n}), (1, {2 * n}), (128, {2 * n}); P in (13, 40, 74) x w in (3, 5, 11, 13) "
          f"with border "
          f"centres and 1, 5, 37 or the wrapper's centres per block", flush=True)

    t = time_k1(device, b, p, 2 * n, r)
    kernel.launches = saved
    return {"name": "packed_windows", "route": "cuda", "source": "pogema_torch/csrc/windows.cu",
            "replaces": "pogema_tpu/ops/pallas_windows.py:71", **t}


def phase_k1b(device, b, p, n, r):
    """Phase 3, K1b. Returns the kernel record (without ``launches``)."""
    import torch

    from pogema_torch.ops.cuda_windows import (K1B_MAX_AGENTS, K1B_NARROW_AGENTS,
                                               _launch_observation)
    from pogema_torch.ops.windows import packed_observation_ref

    _, kernel = _kernels()
    saved = kernel.launches
    w = 2 * r + 1
    # The three shapes of the table: config C, config-D serving, the
    # recurrent update's minibatch.
    pd, nd = CONFIG_D["size"] + 2 * CONFIG_D["obs_radius"], CONFIG_D["num_agents"]
    for bb, pp, nn in ((b, p, n), (NUM_ENVS_D, pd, nd),
                       (NUM_ENVS_D // TRAIN_D_PPO["minibatches"], pd, nd),
                       (1, p, n), (1, pd, nd)):  # the rim's single env
        args = random_obs_inputs(bb, pp, nn, r, device, seed=bb + nn)
        got = kernel(*args, w)
        # The plain version of a large batch goes through [B, N, N] tensors: in slices.
        for lo in range(0, bb, 512):
            ref = packed_observation_ref(*(a[lo:lo + 512] for a in args), w)
            if not torch.equal(got[lo:lo + 512], ref):
                raise AssertionError(f"K1b differs from its plain version at B={bb} N={nn} "
                                     f"(envs {lo}..): max |diff| "
                                     f"{(got[lo:lo + 512] - ref).abs().max().item()}")
    for pp, nn, ww in ((40, 37, 3), (40, 37, 5), (40, 37, 11), (40, 37, 13), (13, 12, 3),
                       (13, 12, 11), (13, 1, 13), (74, 1, 11), (74, 12, 11), (40, 10, 5),
                       (40, 36, 13)):
        args = random_obs_inputs(64, pp, nn, ww // 2, device, seed=ww + pp + nn, border=True)
        ref = packed_observation_ref(*args, ww)
        for centres in {None, 1, min(4, nn), nn}:
            got = kernel(*args, ww) if centres is None else _launch_observation(*args, ww, centres)
            if got.shape != (64, nn, 3 * ww * ww) or not torch.equal(got, ref):
                raise AssertionError(f"K1b differs from its plain version at P={pp} N={nn} "
                                     f"w={ww} agents per block {centres} (border cases)")
    grid, axy, txy, active = random_obs_inputs(8, 40, 12, 3, device, seed=5)
    wide = torch.stack([axy, axy], dim=1)[:, 1]  # same values, a view with gaps
    if wide.is_contiguous():
        raise AssertionError("the test's view is contiguous")
    _expect_refused(lambda: kernel(grid, wide, txy, active, 7), "a non-contiguous agents_xy")
    _expect_refused(lambda: kernel(grid, axy, txy, active.t().contiguous().t(), 7),
                    "a non-contiguous active")
    # Up to 255 agents per env a cell's count has 8 bits: that many, all
    # active on one cell (odd and even cells: both halves of a shared
    # word); more in phase k1b_wide. More than 16-bit counts hold is refused.
    _check_one_cell(grid[:2], (K1B_NARROW_AGENTS,))
    over = torch.zeros(1, K1B_MAX_AGENTS + 1, 2, dtype=torch.int32, device=device)
    _expect_refused(lambda: kernel(grid[:1], over, over, over[..., 0] == 0, 7),
                    f"{K1B_MAX_AGENTS + 1} agents per env")
    print(f"K1b bit-equal to its plain version: config C (B={b} N={n}), config-D serving "
          f"(B={NUM_ENVS_D} N={nd}), the recurrent update (B={NUM_ENVS_D // 8} N={nd}), one "
          f"env (B=1 N={n} and {nd}), all with a third of the agents inactive, agents sharing "
          f"cells and far targets; P in (13, 40, 74) x N in (1, 10, 12, 36, 37) x w in (3, 5, "
          f"11, 13) with border centres and 1, 4, N or the wrapper's agents per block; "
          f"{K1B_NARROW_AGENTS} agents counted on one cell; non-contiguous inputs and "
          f"{K1B_MAX_AGENTS + 1} agents refused", flush=True)

    t = time_k1b(device, b, p, n, r)
    kernel.launches = saved
    return {"name": "packed_observation", "route": "cuda", "source": "pogema_torch/csrc/windows.cu",
            "replaces": "none (no TPU kernel): pogema_tpu/core/obs.py:42 observe, "
                        "obs_layout='packed', composed of ops/windows.py:191 and core/obs.py:26",
            **t}


def _check_one_cell(grid, counts, w=7):
    """K1b with ``count`` agents per env, all active on one cell, for each
    count, on an even and an odd cell (the two halves of a shared word in
    either layout): bit-equal to the plain version, the centre of the
    agents block reading the count."""
    import torch

    from pogema_torch.ops.windows import packed_observation_ref

    _, kernel = _kernels()
    b, r = grid.shape[0], w // 2
    for count in counts:
        for cell in ((20, 20), (20, 21)):
            many = torch.tensor(cell, dtype=torch.int32, device=grid.device).expand(b, count, 2)
            args = (grid, many.contiguous(), many.contiguous(),
                    torch.ones(b, count, dtype=torch.bool, device=grid.device))
            got = kernel(*args, w)
            if got[:, :, w * w + r * w + r].min().item() != count or not torch.equal(
                    got, packed_observation_ref(*args, w)):
                raise AssertionError(f"K1b miscounts {count} agents on cell {cell}")


def _time_kernel(label, kernel, run, plain, library, nbytes, launches):
    """One kernel at one shape beside its byte bound, its plain version
    and its library yardstick: {max_abs_err, ms (CUDA events around
    eager calls), device_ms (CUDA-graph replay), plain_ms, bound_ms,
    bound_by, library_ms, library_device_ms}. ``plain`` returns the plain
    version's result, or the largest difference from ``out`` when it
    compares in slices. The launches made here are not left in the count."""
    import torch

    saved = kernel.launches
    out = run()
    err = plain(out)
    if not torch.equal(library(), out):
        raise AssertionError(f"the library yardstick disagrees with {label}")
    ms = cuda_time_ms(run)
    device_ms = graph_time_ms(run, launches)
    plain_ms = cuda_time_ms(lambda: plain(None), iters=3, warmup=1)
    library_ms = cuda_time_ms(library)
    library_device_ms = graph_time_ms(library, launches)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    kernel.launches = saved
    print(f"{label}: {device_ms:.4f} ms device time by graph replay ({bound_ms / device_ms:.2f} "
          f"of its bound, {bound_ms:.4f} ms by {nbytes} bytes), {ms:.4f} ms by events; plain "
          f"{plain_ms:.4f} ms; library {library_device_ms:.4f} ms by graph replay, "
          f"{library_ms:.4f} ms by events", flush=True)
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
            "library_device_ms": library_device_ms}


def _graph_launches(out_bytes):
    """Launches per graph: enough that the outputs kept alive exceed the
    50 MB L2 cache several times, within 8 GB."""
    return int(max(10, min(40, 8e9 // out_bytes)))


def time_k1(device, b, p, m, r):
    """K1 at one shape; the library yardstick is one ``torch.gather``
    from the float grid (plus a zero cell for the padding lanes) by an
    index built outside the timed call."""
    import torch

    from pogema_torch.ops.windows import extract_windows_packed_ref, packed_lanes

    kernel, _ = _kernels()
    w = 2 * r + 1
    lanes = packed_lanes(w)
    grid, xy = random_windows_inputs(b, p, m, r, device, seed=7)
    gflat = torch.cat([grid.reshape(b, p * p).float(), torch.zeros(b, 1, device=device)], 1)
    k = torch.arange(lanes, device=device)
    rr = (xy[..., 0:1].long() - r + k // w).clamp(0, p - 1)
    cc = (xy[..., 1:2].long() - r + k % w).clamp(0, p - 1)
    idx = torch.where(k < w * w, rr * p + cc, p * p).reshape(b, m * lanes)
    del rr, cc

    def plain(out):
        ref = extract_windows_packed_ref(grid, xy, w)
        return None if out is None else (out - ref).abs().max().item()

    nbytes = b * p * p + b * m * 2 * 4 + b * m * lanes * 4
    return _time_kernel(f"K1 at B={b} P={p} M={m} w={w}", kernel, lambda: kernel(grid, xy, w),
                        plain, lambda: torch.gather(gflat, 1, idx).reshape(b, m, lanes),
                        nbytes, _graph_launches(b * m * lanes * 4))


def time_k1b(device, b, p, n, r):
    """K1b at one shape. The library yardstick is the shortest sequence of
    PyTorch calls found that gives the same tensor: ``zero_`` and
    ``scatter_add_`` build the occupancy counts beside the float
    obstacles, a zero and a one in one source row per env, and one
    ``torch.gather`` reads every output element from it; the indices of
    both and the float copies of the inputs are built outside the timed
    calls."""
    import torch

    from pogema_torch.ops.windows import packed_observation_ref

    _, kernel = _kernels()
    w = 2 * r + 1
    ww, pp = w * w, p * p
    grid, axy, txy, active = random_obs_inputs(b, p, n, r, device, seed=11)
    src = torch.cat([grid.reshape(b, pp).float(), torch.zeros(b, pp + 1, device=device),
                     torch.ones(b, 1, device=device)], 1)  # obstacles | counts | 0 | 1
    zero_cell, one_cell = 2 * pp, 2 * pp + 1
    cells = pp + axy[..., 0].long() * p + axy[..., 1].long()  # [B, N] into the counts
    active_f = active.float()
    k = torch.arange(ww, device=device)
    rows = axy[..., 0:1].long() - r + k // w  # [B, N, ww]
    cols = axy[..., 1:2].long() - r + k % w
    inside = (rows >= 0) & (rows < p) & (cols >= 0) & (cols < p)
    cell = rows * p + cols
    rel = (txy.long() - axy.long()).clamp(-r, r) + r
    idx = torch.cat([torch.where(inside, cell, zero_cell), torch.where(inside, cell + pp, zero_cell),
                     torch.where(k == (rel[..., 0:1] * w + rel[..., 1:2]), one_cell, zero_cell)],
                    dim=-1).reshape(b, n * 3 * ww)
    del rows, cols, inside, cell

    def library():
        src[:, pp:2 * pp].zero_()
        src.scatter_add_(1, cells, active_f)
        return torch.gather(src, 1, idx).reshape(b, n, 3 * ww)

    def plain(out):
        worst = 0.0
        for lo in range(0, b, 512):  # the plain version goes through [B, N, N] tensors
            ref = packed_observation_ref(grid[lo:lo + 512], axy[lo:lo + 512], txy[lo:lo + 512],
                                         active[lo:lo + 512], w)
            if out is not None:
                worst = max(worst, (out[lo:lo + 512] - ref).abs().max().item())
        return worst

    nbytes = b * pp + 2 * b * n * 2 * 4 + b * n + b * n * 3 * ww * 4
    return _time_kernel(f"K1b at B={b} P={p} N={n} w={w}", kernel,
                        lambda: kernel(grid, axy, txy, active, w), plain, library, nbytes,
                        _graph_launches(b * n * 3 * ww * 4))


def phase_k7(device):
    """K7, the threefry kernel, bit-equal to its plain version on the card:
    the cached select's split of 4096 keys into 1 and 3, the placement's
    bits at [1024, P*P] and [4096, P*P] (P = 74) from offset 0 and from
    above 2**32, fold_in of a scalar and of per-key data, one launch each.
    Then timed at the select's and the placement's shapes by CUDA events
    and by graph replay, beside its bound and the plain version's times.
    Returns the kernel record."""
    import torch

    from pogema_torch.ops import cuda_threefry as k7
    from pogema_torch.ops.threefry import bits_ref, fold_in_ref, split_ref

    big = (CONFIG_D["size"] + 2 * CONFIG_D["obs_radius"]) ** 2
    g = torch.Generator().manual_seed(7)
    keys = {rows: torch.randint(0, 2**32, (rows, 2), dtype=torch.int64, generator=g).to(device)
            for rows in (1024, 4096)}
    data = torch.randint(-2**40, 2**40, (1024,), dtype=torch.int64, generator=g).to(device)
    cases = {
        "split [4096, 2] -> 1": (lambda: k7.split(keys[4096], 1), lambda: split_ref(keys[4096], 1)),
        "split [4096, 2] -> 3": (lambda: k7.split(keys[4096], 3), lambda: split_ref(keys[4096], 3)),
        "bits [1024, P*P]": (lambda: k7.bits(keys[1024], (big,)), lambda: bits_ref(keys[1024], (big,))),
        "bits [4096, P*P]": (lambda: k7.bits(keys[4096], (big,)), lambda: bits_ref(keys[4096], (big,))),
        "bits [1024, P*P] from 2**32 - 77": (lambda: k7.bits(keys[1024], (big,), 2**32 - 77),
                                             lambda: bits_ref(keys[1024], (big,), 2**32 - 77)),
        "fold_in [1024, 2] of 127": (lambda: k7.fold_in(keys[1024], 127),
                                     lambda: fold_in_ref(keys[1024], 127)),
        "fold_in [1024, 2] per key": (lambda: k7.fold_in(keys[1024], data),
                                      lambda: fold_in_ref(keys[1024], data)),
    }
    for label, (run, plain) in cases.items():
        before = k7.threefry_cuda.launches
        got = run()
        torch.cuda.synchronize()
        if k7.threefry_cuda.launches != before + 1:
            raise AssertionError(f"K7 at {label} launched {k7.threefry_cuda.launches - before} "
                                 f"times, expected 1")
        if not torch.equal(got, plain()):
            raise AssertionError(f"K7 differs from its plain version at {label}")
    print(f"K7 bit-equal to its plain version at {len(cases)} shapes", flush=True)

    saved = k7.threefry_cuda.launches
    record = {"kernel": "K7 threefry"}
    for label, rows, numel, run, plain, out_bytes in (
            ("select", 4096, 1, cases["split [4096, 2] -> 1"][0], cases["split [4096, 2] -> 1"][1],
             16),
            ("placement", 1024, big, cases["bits [1024, P*P]"][0], cases["bits [1024, P*P]"][1],
             8)):
        counters = rows * numel
        nbytes = 16 * rows + out_bytes * counters
        alu_ms = K7_OPS_PER_COUNTER * counters / INT32_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        launches = _graph_launches(out_bytes * counters)
        rec = {"shape": [rows, numel], "bound_ms": max(alu_ms, bytes_ms),
               "bound_by": "int32 ALU" if alu_ms >= bytes_ms else "bytes",
               "device_ms": graph_time_ms(run, launches), "ms": cuda_time_ms(run),
               "plain_device_ms": graph_time_ms(plain, 4, replays=3),
               "plain_ms": cuda_time_ms(plain, iters=5, warmup=2)}
        record[label] = rec
        print(f"K7 at the {label}'s [{rows}, {numel}]: {rec['device_ms']:.4f} ms device time by "
              f"graph replay ({rec['bound_ms'] / rec['device_ms']:.2f} of its bound, "
              f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}: {alu_ms:.4f} ms for "
              f"{K7_OPS_PER_COUNTER} int32 operations a counter at {INT32_OPS_PER_S:.4g} a second, "
              f"{bytes_ms:.4f} ms for {nbytes} bytes), {rec['ms']:.4f} ms by events; plain "
              f"{rec['plain_device_ms']:.4f} ms by graph replay, {rec['plain_ms']:.4f} ms by "
              f"events", flush=True)
    k7.threefry_cuda.launches = saved
    return record


def random_priority_inputs(b, n, p, device, seed, density=0.3, inactive=0.1):
    """Inputs of the 'priority' rule at a cell's shapes: a border of
    obstacles and ``density`` walls inside, N agents on distinct free
    cells (the N best of random scores), a share of them inactive, actions
    in [-1, 6) (values outside [0, 5) stay)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    grid = torch.ones(b, p, p, dtype=torch.uint8)
    grid[:, 1:-1, 1:-1] = (torch.rand(b, p - 2, p - 2, generator=g) < density).to(torch.uint8)
    scores = torch.rand(b, p * p, generator=g).masked_fill(grid.reshape(b, -1) != 0, -1.0)
    cells = scores.topk(n, dim=1).indices
    xy = torch.stack([cells // p, cells % p], -1).to(torch.int32)
    active = torch.rand(b, n, generator=g) >= inactive
    actions = torch.randint(-1, 6, (b, n), generator=g, dtype=torch.int32)
    return tuple(t.to(device) for t in (grid, xy, active, actions))


def phase_k2(device):
    """K2, the 'priority' collision kernel, bit-equal to its plain version
    (the fixpoint of ``ops/collisions.py``) on the card, one launch each:
    at the shapes of C.random (4096 x 64, P = 74, int32 and int64
    actions), D.serve (1024 x 128, P = 74) and E.serve (1024 x 256,
    P = 138), crowded (1024 x 256 on 20 x 20 grids), one warp a block
    (2 x 2000) and past shared memory (2 x 6500). Then timed at the three
    cells' shapes by graph replay and by CUDA events, beside its bound and
    the plain fixpoint's time (host syncs included). Returns the kernel
    record."""
    import torch

    from pogema_torch.ops import collisions as plain
    from pogema_torch.ops import cuda_collisions as k2

    p_cd = CONFIG_C["size"] + 2 * CONFIG_C["obs_radius"]
    p_e = CONFIG_E["size"] + 2 * CONFIG_E["obs_radius"]
    shapes = {"C.random": (NUM_ENVS_C, CONFIG_C["num_agents"], p_cd),
              "D.serve": (NUM_ENVS_D, CONFIG_D["num_agents"], p_cd),
              "E.serve": (NUM_ENVS_E, CONFIG_E["num_agents"], p_e)}
    cases = {name: random_priority_inputs(*shape, device, seed=i)
             for i, (name, shape) in enumerate(shapes.items())}
    grid, xy, active, actions = cases["C.random"]
    cases["C.random int64 actions"] = (grid, xy, active, actions.long())
    cases["crowded 1024 x 256 on 20 x 20"] = random_priority_inputs(1024, 256, 20, device, 5,
                                                                    density=0.05)
    cases["one warp a block, 2 x 2000"] = random_priority_inputs(2, 2000, 60, device, 6, 0.1)
    cases["scratch, 2 x 6500"] = random_priority_inputs(2, 6500, 100, device, 7, 0.1)
    for label, args in cases.items():
        before = k2.collisions_cuda.launches
        got = k2.resolve_priority(*args)
        torch.cuda.synchronize()
        if k2.collisions_cuda.launches != before + 1:
            raise AssertionError(f"K2 at {label} launched {k2.collisions_cuda.launches - before} "
                                 f"times, expected 1")
        if not torch.equal(got, plain.resolve_priority(*args)):
            raise AssertionError(f"K2 differs from its plain version at {label}")
        if not ((got != args[1]).any() and (got == args[1]).all(-1).any()):
            raise AssertionError(f"at {label} no agent moved or every agent moved")
    print(f"K2 bit-equal to its plain version at {len(cases)} shapes", flush=True)

    saved = k2.collisions_cuda.launches
    record = {"kernel": "K2 priority collisions"}
    for label, (b, n, p) in shapes.items():
        args = cases[label]
        a_bytes = args[3].element_size()
        nbytes = b * (n * (8 + 1 + a_bytes + 8) + min(32 * n, p * p))
        rec = {"shape": [b, n, p], "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "device_ms": graph_time_ms(lambda: k2.resolve_priority(*args),
                                          _graph_launches(b * n * 8)),
               "ms": cuda_time_ms(lambda: k2.resolve_priority(*args)),
               "fixpoint_ms": cuda_time_ms(lambda: plain.resolve_priority(*args), iters=10)}
        record[label] = rec
        print(f"K2 at {label}'s [{b}, {n}], P = {p}: {rec['device_ms']:.4f} ms device time by graph "
              f"replay ({rec['bound_ms'] / rec['device_ms']:.2f} of its bound, "
              f"{rec['bound_ms']:.4f} ms by {nbytes} bytes), {rec['ms']:.4f} ms by events; the "
              f"fixpoint {rec['fixpoint_ms']:.4f} ms by events, host syncs included", flush=True)
    k2.collisions_cuda.launches = saved
    return record


def phase_k8(device):
    """K8, the served recurrent policy step, at the served cells' rows:
    D.serve's 1024 x 128 with rec128_ft and E.serve's 1024 x 256 with
    maze256, on packed observations of 0/1 entries (a third of them 1) and
    h drawn in (-1, 1). First held to the plain version
    (``step_from_obs``) on the same inputs, with the card tests'
    tolerances (``tests/test_torch_policy_card.py``: h' entries that
    differ, the largest h' gap, the largest logit or value gap); then
    timed by graph replay and by CUDA events, beside its byte bound (the
    observation read once, h read and written, logits and value written)
    and the plain version's time by events. Its registers and spills are
    the build's ptxas lines. Returns the kernel record."""
    import torch

    from pogema_torch.interop import load_policy
    from pogema_torch.ops import cuda_policy

    h_share, h_gap, logit_gap = 1e-5, 0.125, 0.25  # H_SHARE, H_GAP, STEP_LOGIT_GAP
    saved = cuda_policy.policy_cuda.launches
    record = {"kernel": "K8 recurrent policy step"}
    for label, (b, n, weights) in {"D.serve": (NUM_ENVS_D, CONFIG_D["num_agents"], WEIGHTS),
                                   "E.serve": (NUM_ENVS_E, CONFIG_E["num_agents"], WEIGHTS_E)
                                   }.items():
        model = load_policy(weights, device=device)
        k, width = 3 * model.window ** 2, model.hidden
        gen = torch.Generator(device=device).manual_seed(b + n)
        obs = (torch.rand(b, n, k, device=device, generator=gen) < 1 / 3).float()
        h = (torch.rand(b, n, width, device=device, generator=gen) * 2 - 1).to(torch.bfloat16)
        out_bytes = b * n * (2 * width + 4 * 6)
        nbytes = b * n * 4 * k + b * n * 2 * width + out_bytes

        def run():
            with torch.inference_mode():
                return cuda_policy.policy_step(model, obs, h)

        def plain():
            with torch.no_grad():
                return model.step_from_obs(obs, h)

        got, want = run(), plain()
        gaps = {"h_share": float((got[0] != want[0]).float().mean()),
                "h_gap": float((got[0].float() - want[0].float()).abs().max()),
                "logit_gap": max(float((a - w).abs().max()) for a, w in zip(got[1:], want[1:]))}
        print(f"K8 at {label}'s [{b}, {n}] against the plain version: h' differs in "
              f"{gaps['h_share']:.3e} of the entries, by at most {gaps['h_gap']:.3e}; logits "
              f"and value within {gaps['logit_gap']:.3e}", flush=True)
        if gaps["h_share"] > h_share or gaps["h_gap"] > h_gap or gaps["logit_gap"] > logit_gap:
            raise RuntimeError(f"K8 at {label} parts from the plain version: {gaps} against "
                               f"{h_share}, {h_gap}, {logit_gap}")
        rec = {"shape": [b, n, k], "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "flop_bound_ms": 291_072 * b * n / 989e12 * 1e3,
               "device_ms": graph_time_ms(run, _graph_launches(out_bytes)),
               "ms": cuda_time_ms(run), "plain_ms": cuda_time_ms(plain, iters=10), **gaps}
        record[label] = rec
        print(f"K8 at {label}'s [{b}, {n}]: {rec['device_ms']:.4f} ms device time by graph "
              f"replay ({rec['bound_ms'] / rec['device_ms']:.2f} of its bound, "
              f"{rec['bound_ms']:.4f} ms by {nbytes} bytes; {rec['flop_bound_ms']:.4f} ms by "
              f"FLOPs), {rec['ms']:.4f} ms by events; the plain version {rec['plain_ms']:.4f} "
              f"ms by events", flush=True)
    cuda_policy.policy_cuda.launches = saved
    return record


def phase_k4(device):
    """K4, the component labels of the reset, bit-equal to its plain
    version (the flood fill of ``ops/components.py``, run on the card) at
    D.serve's shape (1024 Bernoulli(0.3) maps of 64 x 64 in their border,
    P = 74) and E.serve's (1024 worlds of config E's braided pool,
    P = 138), one launch each (``tests/test_torch_components_card.py``
    holds the other grid families); then timed at the two cells' shapes
    by graph replay and by CUDA events, beside its byte bound (the grids
    read and the i64 labels written once) and the plain version's time by
    events, host syncs included. Its registers, spills and shared memory
    are the build's ptxas lines. Returns the kernel record."""
    import numpy as np
    import torch

    from pogema_torch.maps import mixed_pool
    from pogema_torch.ops import components, cuda_components

    r = CONFIG_D["obs_radius"]
    rng = np.random.default_rng(4)
    d_inner = rng.random((NUM_ENVS_D, CONFIG_D["size"], CONFIG_D["size"])) < CONFIG_D["density"]
    pool = mixed_pool(CONFIG_E["size"], k=8, braid=0.15)
    e_inner = pool[rng.integers(0, len(pool), NUM_ENVS_E)]

    def padded(inner):
        return torch.nn.functional.pad(torch.as_tensor(inner, dtype=torch.uint8).to(device),
                                       (r, r, r, r), value=1)

    cases = {"D.serve": padded(d_inner), "E.serve": padded(e_inner)}
    saved = cuda_components.components_cuda.launches
    for label, grid in cases.items():
        before = cuda_components.components_cuda.launches
        got = cuda_components.connected_components(grid)
        torch.cuda.synchronize()
        if cuda_components.components_cuda.launches != before + 1:
            raise AssertionError(f"K4 at {label} launched "
                                 f"{cuda_components.components_cuda.launches - before} times, "
                                 f"expected 1")
        sweeps = components.connected_components.sweeps
        want = components.connected_components(grid)
        sweeps = components.connected_components.sweeps - sweeps
        if not torch.equal(got, want):
            raise AssertionError(f"K4 differs from its plain version at {label}")
        print(f"K4 bit-equal to its plain version at {label} ({sweeps} sweeps of the plain "
              f"version)", flush=True)

    record = {"kernel": "K4 component labels"}
    for label, grid in cases.items():
        b, p, _ = grid.shape
        nbytes = b * p * p * 9

        def run():
            return cuda_components.connected_components(grid)

        rec = {"shape": [b, p], "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "device_ms": graph_time_ms(run, _graph_launches(b * p * p * 8)),
               "ms": cuda_time_ms(run),
               "plain_ms": cuda_time_ms(lambda: components.connected_components(grid), iters=3,
                                        warmup=1)}
        record[label] = rec
        print(f"K4 at {label}'s [{b}, {p}, {p}]: {rec['device_ms']:.4f} ms device time by graph "
              f"replay ({rec['bound_ms'] / rec['device_ms']:.2f} of its bound, "
              f"{rec['bound_ms']:.4f} ms by {nbytes} bytes), {rec['ms']:.4f} ms by events; the "
              f"plain version {rec['plain_ms']:.4f} ms by events, host syncs included",
              flush=True)
    cuda_components.components_cuda.launches = saved
    return record


def _k9_cases(device):
    """The worlds and keys of phase k9: each cell's labels (K4 on worlds
    made on the card as the cell's resets make them), side, agent count
    and placement keys."""
    import numpy as np
    import torch

    from pogema_torch import GridConfig
    from pogema_torch.core import generator
    from pogema_torch.maps import mixed_pool

    rng = np.random.default_rng(9)

    def keys(b):
        return torch.as_tensor(rng.integers(0, 2**32, (b, 2)), dtype=torch.int64).to(device)

    cases = {}
    for label, kw, b in (("C.regen", CONFIG_C, NUM_ENVS_C), ("D.serve", CONFIG_D, NUM_ENVS_D),
                         ("E.serve", CONFIG_E, NUM_ENVS_E)):
        cfg = GridConfig(**kw).to_static()
        if label == "C.regen":
            grid = generator.sidewinder_maze(cfg, keys(b))
        elif label == "D.serve":
            grid = generator.bernoulli_obstacles(cfg, keys(b))
        else:
            pool = torch.as_tensor(mixed_pool(cfg.size, k=8, braid=0.15)).to(device)
            grid = pool[torch.as_tensor(rng.integers(0, len(pool), b)).to(device)]
        labels = generator.connected_components(generator.pad_grid(cfg, grid))
        cases[label] = (keys(b), labels, cfg.padded_size, cfg.num_agents)
    return cases


def _k9_hashes(labels, agents, p):
    """The hashes placement cannot skip: one a cell for the agents' keys
    (the eligible cells; the others have no draw) and, for each agent,
    one a cell of its component but its own."""
    import torch

    from pogema_torch.ops.placement import multi_cell_component

    b, big = labels.shape
    sizes = torch.zeros(b, big + 1, dtype=torch.int64, device=labels.device)
    sizes.scatter_add_(1, labels, torch.ones_like(labels))
    comp = labels.gather(1, agents)
    own = (sizes.gather(1, comp) - 1).masked_fill(comp == big, 0)
    return int(multi_cell_component(labels, p).sum()) + int(own.sum())


def phase_k9(device):
    """K9, the placement of a reset's agents and targets, bit-equal to its
    plain version (the loop over the agents of ``ops/placement.py``, run
    on the card) at C.regen's (4096 sidewinder mazes of 64 x 64, 64
    agents), D.serve's (1024 Bernoulli(0.3) maps of 64 x 64, 128 agents)
    and E.serve's shapes (1024 worlds of config E's pool, 128 x 128, 256
    agents), one launch each (``tests/test_torch_placement_card.py``
    holds the other grids and sizes); then timed at the three shapes by
    graph replay and by CUDA events beside its bound (the hashes the
    semantics cannot skip, counted from the worlds, at K9_OPS_PER_HASH
    instructions a hash and the card's issue rate) and the plain version's
    time by events. Then K9's
    launches in C.regen's ending step: one per placement try. Its
    registers, spills and shared memory are the build's ptxas lines.
    Returns the kernel record."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core import generator
    from pogema_torch.ops import cuda_placement, placement

    cases = _k9_cases(device)
    k9 = cuda_placement.placement_cuda
    saved = k9.launches
    record = {"kernel": "K9 placement"}
    for label, (keys, labels, p, n) in cases.items():
        before = k9.launches
        got = cuda_placement.place_agents_and_targets(keys, labels, p, n)
        torch.cuda.synchronize()
        if k9.launches != before + 1:
            raise AssertionError(f"K9 at {label} launched {k9.launches - before} times, "
                                 f"expected 1")
        want = placement.place_agents_and_targets(keys, labels, p, n)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K9 differs from its plain version at {label}")
        if not bool(got[2].all()):
            raise AssertionError(f"K9 at {label} placed {int(got[2].sum())} of {len(got[2])} envs")
        print(f"K9 bit-equal to its plain version at {label}", flush=True)

        def run():
            return cuda_placement.place_agents_and_targets(keys, labels, p, n)

        hashes = _k9_hashes(labels, got[0], p)
        b = keys.shape[0]
        rec = {"shape": [b, p, n], "hashes": hashes,
               "bound_ms": K9_OPS_PER_HASH * hashes / INSTRUCTIONS_PER_S * 1e3,
               "bound_by": "instruction issue", "device_ms": graph_time_ms(run, 10, replays=3),
               "ms": cuda_time_ms(run, iters=10),
               "plain_ms": cuda_time_ms(lambda: placement.place_agents_and_targets(
                   keys, labels, p, n), iters=3, warmup=1)}
        record[label] = rec
        print(f"K9 at {label}'s [{b}, {p}, {p}] x {n} agents: {rec['device_ms']:.4f} ms device "
              f"time by graph replay ({rec['bound_ms'] / rec['device_ms']:.2f} of its bound, "
              f"{rec['bound_ms']:.4f} ms for {hashes} hashes at {K9_OPS_PER_HASH} instructions "
              f"a hash and {INSTRUCTIONS_PER_S:.4g} a second), {rec['ms']:.4f} ms by events; the "
              f"plain version "
              f"{rec['plain_ms']:.4f} ms by events", flush=True)

    # C.regen's ending step: every env regenerated, one K9 launch a try.
    core = PogemaCore(GridConfig(seed=0, **CONFIG_C), num_envs=NUM_ENVS_C, maze=True,
                      device=device, auto_reset_mode="regen", obs_layout="packed")
    gen = torch.Generator(device=device).manual_seed(9)
    state, _ = core.reset(0)
    init = state
    for _ in range(CONFIG_C["max_episode_steps"]):
        actions = torch.randint(0, 5, (NUM_ENVS_C, CONFIG_C["num_agents"]), device=device,
                                generator=gen, dtype=torch.int32)
        before, tries = k9.launches, generator.generate_env.tries
        state, _, _, done, _ = core.step_autoreset(state, init, actions)
    launches, tries = k9.launches - before, generator.generate_env.tries - tries
    if not bool(done.all()) or launches != tries or tries < 1:
        raise AssertionError(f"C.regen's ending step launched K9 {launches} times in {tries} "
                             f"placement tries, {int(done.sum())} envs ending; expected one a try")
    record["launches_by_path"] = {"regen_ending_step": launches}
    print(f"K9 in C.regen's ending step: {launches} launch(es) in {tries} placement tries",
          flush=True)
    k9.launches = saved
    return record


def _states_equal(a, b):
    from pogema_torch.interop import state_to_numpy
    import numpy as np

    x, y = state_to_numpy(a), state_to_numpy(b)
    return set(x) == set(y) and all(np.array_equal(x[k], y[k]) for k in x)


def _tree_equal(a, b):
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    return torch.equal(a.cpu(), b.cpu())


def phase_devices_agree(device, steps=64):
    """Phase 4: the port on ``device`` against the port on the CPU."""
    import numpy as np
    import torch

    from pogema_torch import GridConfig, PogemaCore

    runs = 0
    for cs in ("priority", "block_both", "soft"):
        for ot in ("finish", "nothing", "restart"):
            for mode in ("cached", "regen"):
                maze = runs % 2 == 0
                gc = GridConfig(size=16, num_agents=12, obs_radius=3, max_episode_steps=24,
                                collision_system=cs, on_target=ot)
                cores = [PogemaCore(gc, num_envs=8, auto_reset_mode=mode, maze=maze,
                                    device=d, obs_layout="packed") for d in ("cpu", device)]
                (s_cpu, o_cpu), (s_dev, o_dev) = (c.reset(runs) for c in cores)
                if not (_states_equal(s_cpu, s_dev) and _tree_equal(o_cpu, o_dev)):
                    raise AssertionError(f"{device} reset differs from cpu: {cs}/{ot}/{mode}")
                init = (s_cpu, s_dev)
                rng = np.random.default_rng(runs)
                for t in range(steps):
                    a = torch.as_tensor(rng.integers(0, 5, (8, 12)), dtype=torch.int32)
                    out_cpu = cores[0].step_autoreset(s_cpu, init[0], a)
                    out_dev = cores[1].step_autoreset(s_dev, init[1], a.to(device))
                    s_cpu, s_dev = out_cpu[0], out_dev[0]
                    same = (_states_equal(s_cpu, s_dev) and _tree_equal(out_cpu[1], out_dev[1])
                            and _tree_equal(out_cpu[2].observations, out_dev[2].observations)
                            and _tree_equal(out_cpu[2].rewards, out_dev[2].rewards)
                            and _tree_equal(out_cpu[3], out_dev[3])
                            and _tree_equal(out_cpu[4], out_dev[4]))
                    if not same:
                        raise AssertionError(f"{device} differs from cpu: {cs}/{ot}/{mode} "
                                             f"maze={maze} at step {t}")
                runs += 1
    print(f"{device} bit-equal to cpu: {runs} runs x {steps} steps "
          f"(3 collision systems x 3 on_target x cached/regen)", flush=True)


def check_state_invariants(state):
    """No active agent on an obstacle or sharing a cell."""
    import torch

    b, n, _ = state.agents_xy.shape
    p = state.obstacles.shape[-1]
    cells = state.agents_xy[..., 0].long() * p + state.agents_xy[..., 1].long()
    on_obstacle = state.obstacles.reshape(b, -1).gather(1, cells).bool() & state.active
    if on_obstacle.any():
        raise AssertionError(f"{int(on_obstacle.sum())} active agents on obstacles")
    tagged = torch.where(state.active, cells, -1 - torch.arange(n, device=cells.device))
    srt = tagged.sort(dim=1).values
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError("two active agents share a cell")
    return cells


def check_invariants(state, obs, cfg, sample=64):
    """The state invariants, and the packed observations of a sample of
    envs equal the plain version's."""
    import torch

    from pogema_torch.ops.windows import packed_observation_ref

    b, n, _ = state.agents_xy.shape
    cells = check_state_invariants(state)
    ww = cfg.window ** 2
    idx = torch.linspace(0, b - 1, sample, device=cells.device).long()
    ref = packed_observation_ref(state.obstacles[idx], state.agents_xy[idx], state.targets_xy[idx],
                                 state.active[idx], cfg.window)
    if not torch.equal(obs[idx], ref):
        raise AssertionError("the observations differ from the plain packed observation")
    if obs.shape != (b, n, 3 * ww) or not torch.isfinite(obs).all():
        raise AssertionError(f"observations of shape {tuple(obs.shape)} or not finite")


def phase_main(device):
    """Phase 5. Returns ((K1 launches, K1b launches), summary dict)."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core import collisions
    from pogema_torch.ops.cuda_collisions import collisions_cuda
    from pogema_torch.ops.cuda_threefry import threefry_cuda

    k1, kernel = _kernels()
    core = PogemaCore(GridConfig(seed=0, **CONFIG_C), num_envs=NUM_ENVS_C, maze=True,
                      device=device, obs_layout="packed")
    k7_start, k2_start = threefry_cuda.launches, collisions_cuda.launches
    gen = torch.Generator(device=device).manual_seed(0)
    b, n = NUM_ENVS_C, CONFIG_C["num_agents"]

    k1.launches = kernel.launches = 0
    collisions.fixpoint.passes = 0
    state, obs = core.reset(0)
    if kernel.launches != 1:
        raise AssertionError(f"reset launched K1b {kernel.launches} times, expected 1")
    check_invariants(state, obs, core.cfg)
    init = state
    k7_reset = threefry_cuda.launches - k7_start
    k7_start = threefry_cuda.launches
    done_envs = 0
    for t in range(MAIN_STEPS):
        actions = torch.randint(0, 5, (b, n), device=device, generator=gen, dtype=torch.int32)
        state, obs, res, done, _ = core.step_autoreset(state, init, actions)
        done_envs += done
        if (t + 1) % 256 == 0:
            check_invariants(state, obs, core.cfg)
    launches = (k1.launches, kernel.launches)
    passes = collisions.fixpoint.passes
    # K2 resolves each step's moves in one launch, with no fixpoint pass.
    k2_steps = collisions_cuda.launches - k2_start
    if k2_steps != MAIN_STEPS or passes != 0:
        raise AssertionError(f"K2 launched {k2_steps} times over {MAIN_STEPS} steps, expected "
                             f"one a step, and the fixpoint made {passes} passes, expected 0")
    # The cached select advances every env's key with one K7 split a step.
    k7_steps = threefry_cuda.launches - k7_start
    if k7_steps != MAIN_STEPS:
        raise AssertionError(f"K7 launched {k7_steps} times over {MAIN_STEPS} steps, expected "
                             f"one a step")
    # The pre-reset and the post-reset observation of a step are one K1b
    # launch each; the packed layout does not go through K1.
    if launches != (0, 1 + 2 * MAIN_STEPS):
        raise AssertionError(f"(K1, K1b) launched {launches} times over reset + {MAIN_STEPS} "
                             f"steps, expected (0, {1 + 2 * MAIN_STEPS})")
    finished = int(done_envs.sum())
    if finished == 0:
        raise AssertionError("no env finished an episode: auto-reset never fired")
    summary = {"steps": MAIN_STEPS, "episodes_finished": finished,
               "k2_launches_per_step": k2_steps / MAIN_STEPS,
               "k1_launches": launches[0], "k1b_launches": launches[1],
               "k7_launches_reset": k7_reset, "k7_launches_per_step": k7_steps / MAIN_STEPS}
    print("main path (config C, cached, packed obs): " + json.dumps(summary), flush=True)
    return launches, summary


def _rel_err(got, want):
    """max |got - want| / max(1, |want|), on the CPU in f32."""
    got, want = got.float().cpu(), want.float().cpu()
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def _top2_margin(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def phase_policy(device, b=64, steps=3):
    """The shipped .ckpt_rec128_ft weights (from the committed .npz) in
    bf16 on 64 config-D states: K1 and K1b bit-equal to their plain
    versions at M = N = 128, and the card's logits and values against the same module
    on the CPU over ``steps`` chained GRU steps."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core import step as step_mod
    from pogema_torch.ops import cuda_windows
    from pogema_torch.ops.windows import extract_windows_packed_ref, packed_observation_ref

    n = CONFIG_D["num_agents"]
    core = PogemaCore(GridConfig(seed=0, **CONFIG_D), num_envs=b, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    state, _ = core.reset(3, with_obs=False)
    states = []
    for _ in range(steps):  # random moves between the states the policy sees
        for _ in range(4):
            a = torch.randint(0, 5, (b, n), device=device, generator=gen, dtype=torch.int32)
            state, _ = step_mod.step(core.cfg, state, a, with_obs=False)
        states.append(state)
    w = core.cfg.window
    got = cuda_windows.extract_windows_packed(state.obstacles, state.agents_xy, w)
    if not torch.equal(got, extract_windows_packed_ref(state.obstacles, state.agents_xy, w)):
        raise AssertionError("K1 differs from its plain version on config-D states (M = N = 128)")
    obs_args = (state.obstacles, state.agents_xy, state.targets_xy, state.active)
    if not torch.equal(cuda_windows.packed_observation_cuda(*obs_args, w),
                       packed_observation_ref(*obs_args, w)):
        raise AssertionError("K1b differs from its plain version on config-D states (N = 128)")
    errs, decided, flips = _policy_vs_cpu(device, WEIGHTS, states)
    print(f"policy (rec128_ft, bf16, B={b} N={n}): K1 and K1b bit-equal at M=N={n}; card vs cpu "
          f"max |diff|/max(1,|cpu|) per step {errs} (tolerance {POLICY_TOL}); greedy actions "
          f"differ at {flips} of {decided} agents with a cpu top-2 margin > {2 * POLICY_TOL}; "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    if max(errs) > POLICY_TOL or flips:
        raise AssertionError("the card's policy outputs differ from the cpu's beyond the tolerance")


def _policy_vs_cpu(device, weights, states):
    """The policy of ``weights`` in bf16 on the card and on the CPU over
    the chained GRU steps of ``states``: (max |diff| / max(1, |cpu|) of
    logits and values per step, agents whose cpu top-2 margin exceeds
    2 * POLICY_TOL, greedy actions that differ among them)."""
    import torch

    from pogema_torch.interop import load_policy

    b, n, _ = states[0].agents_xy.shape
    card, host = load_policy(weights, device=device), load_policy(weights, device="cpu")
    h_dev, h_cpu = card.initial_carry((b, n)), host.initial_carry((b, n))
    errs, decided, flips = [], 0, 0
    with torch.no_grad():
        for st in states:
            args = (st.obstacles, st.agents_xy, st.targets_xy, st.active)
            h_dev, l_dev, v_dev = card.step_from_state(*args, h_dev)
            h_cpu, l_cpu, v_cpu = host.step_from_state(*(a.cpu() for a in args), h_cpu)
            errs.append(max(_rel_err(l_dev, l_cpu), _rel_err(v_dev, v_cpu)))
            mask = _top2_margin(l_cpu) > 2 * POLICY_TOL
            decided += int(mask.sum())
            flips += int((l_dev.argmax(-1).cpu() != l_cpu.argmax(-1))[mask].sum())
    if not all(torch.isfinite(t).all() for t in (l_dev, v_dev, h_dev)):
        raise AssertionError("non-finite policy outputs on the card")
    return errs, decided, flips


def _check_k4(label, launches, tries, sweeps):
    """K4 once per placement try of a reset on the card, and no sweep of
    the plain flood fill. Returns the launches."""
    if launches != tries or tries < 1:
        raise AssertionError(f"{label} launched K4 {launches} times in {tries} placement tries, "
                             f"expected one a try")
    if sweeps != 0:
        raise AssertionError(f"{label} made {sweeps} flood-fill sweeps on the card, expected 0")
    return launches


def _check_k9(label, launches, tries):
    """K9 once per placement try of a reset on the card. Returns the
    launches."""
    if launches != tries or tries < 1:
        raise AssertionError(f"{label} launched K9 {launches} times in {tries} placement tries, "
                             f"expected one a try")
    return launches


def phase_serve(device):
    """This slice's path at full width: make_policy_evaluator on config D
    (1024 envs x 128 agents, 64x64, r=5, LifeLong) with the shipped
    rec128_ft weights in bf16, 3 greedy episodes (each with its reset;
    the benchmark's cell ``D.serve`` times such episodes) with their
    launches counted. Returns ((K1, K1b) launches, summary)."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core import collisions, generator
    from pogema_torch.interop import load_policy
    from pogema_torch.ops.cuda_collisions import collisions_cuda
    from pogema_torch.ops.cuda_components import components_cuda
    from pogema_torch.ops.cuda_placement import placement_cuda
    from pogema_torch.ops.cuda_policy import policy_cuda
    from pogema_torch.ops.cuda_threefry import threefry_cuda
    from pogema_torch.parallel import make_policy_evaluator

    k1, kernel = _kernels()
    b, n, steps = NUM_ENVS_D, CONFIG_D["num_agents"], CONFIG_D["max_episode_steps"]
    core = PogemaCore(GridConfig(seed=0, **CONFIG_D), num_envs=b, device=device)
    model = load_policy(WEIGHTS, device=device)
    run = make_policy_evaluator(core, model)

    # K7 launches of an episode: the reset's split of the key into B env
    # keys and of those into state, generator and queue keys, the action
    # stream's fold_in, the goal queue's split and two randints (a split
    # and two bits each), and per placement try the try's split, the
    # attempt's split and the map's Bernoulli draw (K9 hashes the
    # placement's draws itself).
    k7_fixed, k7_per_try = 2 + 1 + 7, 3
    throughput, k7_episodes, k2_episodes, k8_episodes, k4_episodes = [], [], [], [], []
    k9_episodes = []
    k1.launches = kernel.launches = 0
    collisions.fixpoint.passes = 0
    for ep in range(SERVE_EPISODES):
        before, k7_before, k2_before, k8_before = (kernel.launches, threefry_cuda.launches,
                                                   collisions_cuda.launches, policy_cuda.launches)
        k4_before, tries, sweeps = (components_cuda.launches, generator.generate_env.tries,
                                    generator.connected_components.sweeps)
        k9_before = placement_cuda.launches
        state, metrics = run(core.make_key(ep))
        k4_episodes.append(_check_k4(f"episode {ep}", components_cuda.launches - k4_before,
                                     generator.generate_env.tries - tries,
                                     generator.connected_components.sweeps - sweeps))
        k9_episodes.append(_check_k9(f"episode {ep}", placement_cuda.launches - k9_before,
                                     generator.generate_env.tries - tries))
        k8_episodes.append(policy_cuda.launches - k8_before)
        if k8_episodes[-1] != steps:
            raise AssertionError(f"episode {ep} launched K8 {k8_episodes[-1]} times, expected "
                                 f"{steps} (one per policy step)")
        if kernel.launches - before != steps:
            raise AssertionError(f"episode {ep} launched K1b {kernel.launches - before} times, "
                                 f"expected {steps} (one per policy step)")
        k2_episodes.append(collisions_cuda.launches - k2_before)
        if k2_episodes[-1] != steps:
            raise AssertionError(f"episode {ep} launched K2 {k2_episodes[-1]} times, expected "
                                 f"{steps} (one per env step)")
        k7_episodes.append(threefry_cuda.launches - k7_before)
        tries, rest = divmod(k7_episodes[-1] - k7_fixed, k7_per_try)
        if tries < 1 or rest != 0:
            raise AssertionError(f"episode {ep} launched K7 {k7_episodes[-1]} times, expected "
                                 f"{k7_fixed} + {k7_per_try} per placement try")
        check_state_invariants(state)
        thr = metrics["avg_throughput"]
        if thr.shape != (b,) or not torch.isfinite(thr).all() or not (state.step_count == steps).all():
            raise AssertionError("bad metrics or episode length at the end of a serving episode")
        throughput.append(float(thr.mean()))
    launches, passes = (k1.launches, kernel.launches), collisions.fixpoint.passes
    if k1.launches != 0:
        raise AssertionError(f"serving launched K1 {k1.launches} times, expected 0")
    if passes != 0:
        raise AssertionError(f"serving made {passes} fixpoint passes, expected 0 (K2)")
    summary = {"avg_throughput": throughput, "k1_launches": launches[0],
               "k1b_launches": launches[1],
               "k1b_launches_per_episode": launches[1] / SERVE_EPISODES,
               "k7_launches_per_episode": k7_episodes, "k2_launches_per_episode": k2_episodes,
               "k8_launches_per_episode": k8_episodes, "k4_launches_per_episode": k4_episodes,
               "k9_launches_per_episode": k9_episodes}
    print("serve (config D, 1024 x 128, rec128_ft bf16, greedy): " + json.dumps(summary), flush=True)
    return launches, summary


def _first_divergence(cores, models, seed):
    """The greedy policy loop of the evaluator stepped on the cpu and the
    card in lockstep: (step, smallest cpu top-2 margin among the agents
    whose actions differ) at the first step they differ."""
    import torch

    from pogema_torch.core import step as step_mod
    from pogema_torch.core.api import select_state

    devs = list(cores)
    cfg = cores[devs[0]].cfg
    st = {d: cores[d].reset(cores[d].make_key(seed), with_obs=False)[0] for d in devs}
    h = {d: models[d].initial_carry((cores[d].num_envs, cfg.num_agents)) for d in devs}
    with torch.no_grad():
        for t in range(cfg.max_episode_steps):
            logits = {}
            for d in devs:
                s = st[d]
                h[d], logits[d], _ = models[d].step_from_state(s.obstacles, s.agents_xy,
                                                               s.targets_xy, s.active, h[d])
            acts = {d: logits[d].argmax(-1).to(torch.int32) for d in devs}
            differ = acts[devs[0]].cpu() != acts[devs[1]].cpu()
            if differ.any():
                return t, float(_top2_margin(logits["cpu"].cpu())[differ].min())
            for d in devs:
                done = step_mod.episode_done(cfg, st[d])
                new, _ = step_mod.step(cfg, st[d], acts[d], with_obs=False)
                st[d] = select_state(done, st[d], new)
    return None, None


def phase_serve_agree(device):
    """Both evaluators with the same keys on the card and on the cpu, f32
    model, 16x16, 12 agents, r=3, 8 envs: the planner's final state and
    metrics bit-equal; the policy's bit-equal or diverging first at a
    near-tie (cpu top-2 margin < 1e-5)."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core.planner import make_planner_evaluator
    from pogema_torch.models import init_recurrent_params
    from pogema_torch.parallel import make_policy_evaluator

    model, _ = init_recurrent_params(torch.Generator().manual_seed(0), 7, embed=64, hidden=64,
                                     dtype=torch.float32)
    devs = ("cpu", device)
    models = {"cpu": model.eval(), device: copy.deepcopy(model).to(device).eval()}
    report = []
    for ot in ("finish", "restart"):
        gc = GridConfig(size=16, num_agents=12, obs_radius=3, max_episode_steps=24, on_target=ot)
        cores = {d: PogemaCore(gc, num_envs=8, device=d) for d in devs}
        runs = {"policy": {d: make_policy_evaluator(cores[d], models[d]) for d in devs}}
        if ot != "restart":
            runs["planner"] = {d: make_planner_evaluator(cores[d]) for d in devs}
        for name, run in runs.items():
            for seed in (0, 1):
                (s_cpu, m_cpu), (s_dev, m_dev) = (run[d](cores[d].make_key(seed)) for d in devs)
                if _states_equal(s_cpu, s_dev) and _tree_equal(m_cpu, m_dev):
                    report.append(f"{name}/{ot}/{seed}: bit-equal")
                    continue
                if name == "planner":
                    raise AssertionError(f"planner on {device} differs from cpu: {ot} seed {seed}")
                t, margin = _first_divergence(cores, models, seed)
                report.append(f"{name}/{ot}/{seed}: first differs at step {t}, margin {margin}")
                if t is None or margin >= 1e-5:
                    raise AssertionError(f"policy on {device} differs from cpu beyond a near-tie: "
                                         f"{ot} seed {seed}, step {t}, margin {margin}")
    print("serve_agree (card vs cpu, same keys): " + "; ".join(report), flush=True)


def phase_planner(device):
    """evaluate_planner at config-C shapes (64x64 mazes, 64 agents, r=5,
    'finish'), PLANNER_ENVS envs instead of config C's 4096: the fields'
    time and sweeps, a sample of fields against the cpu, the episode."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core import planner

    core = PogemaCore(GridConfig(seed=0, **CONFIG_C), num_envs=PLANNER_ENVS, maze=True,
                      device=device)
    state, _ = core.reset(core.make_key(0), with_obs=False)
    planner.distance_fields.sweeps = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist = planner.distance_fields(state.obstacles, state.targets_xy)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    sweeps = planner.distance_fields.sweeps
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ref = planner.distance_fields(state.obstacles[:4].cpu(), state.targets_xy[:4].cpu())
    if not torch.equal(dist[:4].cpu(), ref):
        raise AssertionError("distance fields on the card differ from the cpu's")
    del dist
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = planner.evaluate_planner(core, 0)
    torch.cuda.synchronize()
    episode_s = time.perf_counter() - t0
    check_state_invariants(state)
    if not all(torch.isfinite(v).all() for v in metrics.values()):
        raise AssertionError("non-finite planner metrics")
    summary = {"envs": PLANNER_ENVS, "plan_s": plan_s, "sweeps": sweeps,
               "plan_peak_gib": peak_gb, "episode_s": episode_s,
               "ISR": float(metrics["ISR"].mean()), "CSR": float(metrics["CSR"].mean()),
               "mean_ep_length": float(metrics["ep_length"].mean())}
    print("planner (config-C shapes, reduced batch): " + json.dumps(summary), flush=True)
    return summary


# -- config E: K1b past 255 agents ------------------------------------------


def _wide_train_setup(flavour, device, seed):
    """(core, model, config, init, make) of a state-based train step at
    N = 256: 16 envs x 256 agents on config E's 128x128 random worlds,
    regen, T = 8, 2 epochs x 2 minibatches, f32 model of width 32, weights
    from ``seed``; 'fused_windows' builds its loss input with K1b."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch import parallel as tp
    from pogema_torch.models import init_embed_params, init_recurrent_params

    core = PogemaCore(GridConfig(seed=0, **CONFIG_E), num_envs=16, auto_reset_mode="regen",
                      device=device)
    gen, w = torch.Generator().manual_seed(seed), 2 * CONFIG_E["obs_radius"] + 1
    if flavour == "recurrent":
        cfg = tp.PPOConfig(rollout_steps=8, epochs=2, minibatches=2)
        model, _ = init_recurrent_params(gen, w, embed=32, hidden=32, dtype=torch.float32)
        return core, model, cfg, tp.init_recurrent_train_state, tp.make_recurrent_train_step
    cfg = tp.PPOConfig(rollout_steps=8, epochs=2, minibatches=2, obstacle_path="windows")
    model, _ = init_embed_params(gen, w, embed=32, hidden=32, dtype=torch.float32)
    return core, model, cfg, tp.init_fused_train_state, tp.make_fused_train_step


def phase_k1b_wide(device):
    """K1b past 255 agents per env (the split layout of 16-bit counts):
    bit-equal to its plain version at (B, N, P, w) = (4, 256, 138, 11),
    (2, 300, 40, 7) and (1, 1024, 13, 3) with 1, 4, N or the wrapper's
    agents per block, and 255, 256 and 300 agents counted on one cell; the
    shared memory the wrapper reckons equal to the kernel's; then every
    card path that builds the packed observation at N = 256, each with its
    launches counted exactly: ``PogemaCore`` packed ``step_autoreset`` at
    16 x 256 x 128x128 for 8 steps (card == cpu), two recurrent and two
    fused 'windows' train steps at 16 x 256 (card vs cpu within
    TRAIN_*_TOL), ``PogemaVectorEnv`` packed at 8 x 256 (card == cpu).
    Then K1b timed at config E's serving shape (B = 1024, N = 256, P =
    138) and by agents per block there. Returns ({path: (K1, K1b)
    launches}, K1b's config-E record, its by-agents-per-block dict)."""
    import numpy as np
    import torch

    from pogema_torch import GridConfig, PogemaCore, PogemaVectorEnv
    from pogema_torch.maps import mixed_pool
    from pogema_torch.ops import cuda_windows as cw
    from pogema_torch.ops.windows import packed_observation_ref

    k1, kernel = _kernels()
    fns = cw._prepare(torch.device(device))[0]
    for pp, ww, nn in ((138, 11, 256), (40, 7, 300), (13, 3, 1024), (74, 11, 64), (138, 11, 128)):
        for mc in (1, 4, nn):
            wide = cw.observation_wide(nn)
            if cw.observation_smem_bytes(pp, ww, mc, wide) != fns["pogema_packed_observation_smem"](
                    pp, ww, mc, int(wide)):
                raise AssertionError(f"the wrapper's shared memory differs from the kernel's at "
                                     f"P={pp} w={ww} mc={mc} wide={wide}")
    saved = kernel.launches
    for bb, nn, pp, ww in ((4, 256, 138, 11), (2, 300, 40, 7), (1, 1024, 13, 3)):
        args = random_obs_inputs(bb, pp, nn, ww // 2, device, seed=bb + nn, border=True)
        ref = packed_observation_ref(*args, ww)
        for centres in {None, 1, 4, nn}:
            got = (kernel(*args, ww) if centres is None
                   else cw._launch_observation(*args, ww, centres))
            if got.shape != (bb, nn, 3 * ww * ww) or not torch.equal(got, ref):
                raise AssertionError(f"K1b differs from its plain version at B={bb} N={nn} "
                                     f"P={pp} w={ww} agents per block {centres}")
    grid, *_ = random_obs_inputs(2, 40, 4, 3, device, seed=9)
    _check_one_cell(grid, (cw.K1B_NARROW_AGENTS, 256, 300))
    kernel.launches = saved
    print("K1b bit-equal to its plain version past 255 agents: (B, N, P, w) = (4, 256, 138, "
          "11), (2, 300, 40, 7), (1, 1024, 13, 3) with border centres and 1, 4, N or the "
          "wrapper's agents per block; 255, 256 and 300 agents counted on one cell (odd and "
          "even); shared memory as the wrapper reckons it", flush=True)

    launches = {}
    # PogemaCore, packed, cached auto-reset: K1b once for the reset and
    # twice per step.
    pool = mixed_pool(CONFIG_E["size"])
    gc = GridConfig(seed=0, **CONFIG_E)
    cores = [PogemaCore(gc, num_envs=16, map_bank=pool, device=d, obs_layout="packed")
             for d in ("cpu", device)]
    k1.launches = kernel.launches = 0
    (s_cpu, o_cpu), (s_dev, o_dev) = (c.reset(0) for c in cores)
    if not (_states_equal(s_cpu, s_dev) and _tree_equal(o_cpu, o_dev)):
        raise AssertionError("config-E reset on the card differs from the cpu's")
    init, rng = (s_cpu, s_dev), np.random.default_rng(0)
    for t in range(8):
        a = torch.as_tensor(rng.integers(0, 5, (16, CONFIG_E["num_agents"])), dtype=torch.int32)
        out_cpu = cores[0].step_autoreset(s_cpu, init[0], a)
        out_dev = cores[1].step_autoreset(s_dev, init[1], a.to(device))
        s_cpu, s_dev = out_cpu[0], out_dev[0]
        if not (_states_equal(s_cpu, s_dev) and _tree_equal(out_cpu[1], out_dev[1])
                and _tree_equal(out_cpu[2].rewards, out_dev[2].rewards)
                and _tree_equal(out_cpu[3], out_dev[3]) and _tree_equal(out_cpu[4], out_dev[4])):
            raise AssertionError(f"config-E packed step_autoreset on the card differs from the "
                                 f"cpu's at step {t}")
    launches["core_packed"] = (k1.launches, kernel.launches)
    if launches["core_packed"] != (0, 17):
        raise AssertionError(f"PogemaCore packed at N=256: (K1, K1b) launched "
                             f"{launches['core_packed']} times, expected (0, 17)")
    check_state_invariants(s_dev)
    del cores, s_cpu, s_dev, init, out_cpu, out_dev

    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    report = []
    try:
        for flavour, per_step in (("recurrent", 8 + 1 + 2 * 2 * 8), ("fused_windows", 8 + 1 + 2 * 2)):
            k1.launches = kernel.launches = 0
            report += _train_agree(flavour, device, _wide_train_setup, expect_k1b=per_step)
            launches[f"train_{flavour}"] = (k1.launches, kernel.launches)
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
        print("k1b_wide train steps at 16 x 256 (card vs cpu):\n  " + "\n  ".join(report),
              flush=True)

    gcv = GridConfig(seed=2, **dict(CONFIG_E, max_episode_steps=4))
    envs = [PogemaVectorEnv(gcv, num_vec_envs=8, obs_layout="packed", map_bank=pool, device=d)
            for d in ("cpu", device)]
    k1.launches = kernel.launches = 0
    if not _host_equal(*(e.reset() for e in envs)):
        raise AssertionError("PogemaVectorEnv packed at N=256: reset on the card differs")
    rng = np.random.default_rng(1)
    for t in range(8):
        a = rng.integers(0, 5, size=envs[0].num_envs)
        outs = [e.step(a) for e in envs]
        if not _host_equal(*outs):
            raise AssertionError(f"PogemaVectorEnv packed at N=256 differs from cpu at step {t}")
    launches["vector_packed"] = (k1.launches, kernel.launches)
    if launches["vector_packed"] != (0, 17):
        raise AssertionError(f"PogemaVectorEnv packed at N=256: (K1, K1b) launched "
                             f"{launches['vector_packed']} times, expected (0, 17)")
    del envs, outs
    print("k1b_wide paths at N=256, (K1, K1b) launches: " + json.dumps(launches), flush=True)

    r = CONFIG_E["obs_radius"]
    p, n, w = CONFIG_E["size"] + 2 * r, CONFIG_E["num_agents"], 2 * r + 1
    rec = dict(B=NUM_ENVS_E, N=n, P=p, **time_k1b(device, NUM_ENVS_E, p, n, r))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pick = cw.centres_per_block(NUM_ENVS_E, n, sms, p * p, 12 * w * w, cw.K1B_AMORTISE,
                                cw.observation_fill(p, w, n), multiple=4)
    args = random_obs_inputs(NUM_ENVS_E, p, n, r, device, seed=11)
    saved = kernel.launches
    reps = _graph_launches(NUM_ENVS_E * n * 12 * w * w)
    times = {mc: graph_time_ms(lambda: cw._launch_observation(*args, w, mc), reps)
             for mc in sorted({32, 64, 128, 256, pick})}
    kernel.launches = saved
    print(f"K1b config E (B={NUM_ENVS_E}) device ms by agents per block, wrapper picks {pick} "
          f"(fill {cw.observation_fill(p, w, n)} blocks per SM): "
          + ", ".join(f"{mc}: {t:.4f}" for mc, t in times.items()), flush=True)
    return launches, rec, {"wrapper_picks": pick, "device_ms": times}


def phase_serve_e(device):
    """Config-E serving: ``make_policy_evaluator`` on ``PogemaCore`` of
    config E (NUM_ENVS_E envs x 256 agents, 128x128 worlds from the mixed
    pool, packed observations) with the shipped maze256 weights in bf16,
    greedy: one warm-up episode, then 2 episodes with K1b launched
    exactly once per policy step, the state invariants and finite metrics
    (the benchmark's cell ``E.serve`` times such episodes). Then the
    policy card vs cpu at B = 2 over 16 chained steps, and
    ``toolbox.evaluate`` on one pool world (the config-E leg of
    examples/eval_ladder.py) with PPO and random, K1 launched exactly
    steps + 1 times each. Returns ({path: (K1, K1b) launches}, summary)."""
    import numpy as np
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core import generator
    from pogema_torch.core import step as step_mod
    from pogema_torch.interop import load_policy
    from pogema_torch.maps import mixed_pool
    from pogema_torch.ops.cuda_collisions import collisions_cuda
    from pogema_torch.ops.cuda_components import components_cuda
    from pogema_torch.ops.cuda_placement import placement_cuda
    from pogema_torch.ops.cuda_policy import policy_cuda
    from pogema_torch.parallel import make_policy_evaluator
    from pogema_torch.toolbox import evaluate

    k1, kernel = _kernels()
    b, n, steps = NUM_ENVS_E, CONFIG_E["num_agents"], CONFIG_E["max_episode_steps"]
    pool = mixed_pool(CONFIG_E["size"], braid=0.15)
    core = PogemaCore(GridConfig(seed=0, **CONFIG_E), num_envs=b, map_bank=pool, device=device,
                      obs_layout="packed")
    model = load_policy(WEIGHTS_E, device=device)
    run = make_policy_evaluator(core, model)
    run(core.make_key(100))

    launches, throughput, k8_episodes, k4_episodes, k9_episodes = {}, [], [], [], []
    k1.launches = kernel.launches = 0
    for ep in range(2):
        before, k2_before, k8_before = (kernel.launches, collisions_cuda.launches,
                                        policy_cuda.launches)
        k4_before, tries, sweeps = (components_cuda.launches, generator.generate_env.tries,
                                    generator.connected_components.sweeps)
        k9_before = placement_cuda.launches
        state, metrics = run(core.make_key(ep))
        k4_episodes.append(_check_k4(f"config-E episode {ep}",
                                     components_cuda.launches - k4_before,
                                     generator.generate_env.tries - tries,
                                     generator.connected_components.sweeps - sweeps))
        k9_episodes.append(_check_k9(f"config-E episode {ep}",
                                     placement_cuda.launches - k9_before,
                                     generator.generate_env.tries - tries))
        k8_episodes.append(policy_cuda.launches - k8_before)
        if k8_episodes[-1] != steps:
            raise AssertionError(f"config-E episode {ep} launched K8 {k8_episodes[-1]} times, "
                                 f"expected {steps}")
        if kernel.launches - before != steps:
            raise AssertionError(f"config-E episode {ep} launched K1b {kernel.launches - before} "
                                 f"times, expected {steps}")
        if collisions_cuda.launches - k2_before != steps:
            raise AssertionError(f"config-E episode {ep} launched K2 "
                                 f"{collisions_cuda.launches - k2_before} times, expected {steps}")
        check_state_invariants(state)
        thr = metrics["avg_throughput"]
        if (thr.shape != (b,) or not all(torch.isfinite(v).all() for v in metrics.values())
                or not (state.step_count == steps).all()):
            raise AssertionError("bad metrics or episode length at the end of a config-E episode")
        throughput.append(float(thr.mean()))
    launches["serve_e"] = (k1.launches, kernel.launches)
    if k1.launches != 0:
        raise AssertionError(f"config-E serving launched K1 {k1.launches} times, expected 0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    core.reset(core.make_key(9), with_obs=False)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    del core, run, state, metrics

    # The policy card vs cpu at B = 2: 16 chained steps, four random moves
    # between the states it sees.
    small = PogemaCore(GridConfig(seed=0, **CONFIG_E), num_envs=2, map_bank=pool, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    st, _ = small.reset(small.make_key(5), with_obs=False)
    states = []
    for _ in range(16):
        for _ in range(4):
            a = torch.randint(0, 5, (2, n), device=device, generator=gen, dtype=torch.int32)
            st, _ = step_mod.step(small.cfg, st, a, with_obs=False)
        states.append(st)
    errs, decided, flips = _policy_vs_cpu(device, WEIGHTS_E, states)
    if max(errs) > POLICY_TOL or flips or not decided:
        raise AssertionError(f"config-E policy card vs cpu: max error {max(errs)}, greedy flips "
                             f"{flips} of {decided} decided agents")

    # The config-E leg of examples/eval_ladder.py on the card: one world of
    # the pool, drawn by the seed as the ladder draws it.
    idx = int(np.random.default_rng(LADDER_SEED).integers(len(pool)))
    env = dict(size=CONFIG_E["size"], density=CONFIG_E["density"], num_agents=n,
               obs_radius=CONFIG_E["obs_radius"], on_target="restart", max_episode_steps=steps,
               map=pool[idx].tolist())
    ladder = {}
    for algo, akw in (("PPO", {"checkpoint": WEIGHTS_E}), ("random", None)):
        k1.launches = kernel.launches = 0
        t0 = time.perf_counter()
        m = evaluate(env, algo=algo, seeds=[LADDER_SEED], algo_kwargs=akw, device=device)["env"]
        launches[f"ladder_{algo}"] = (k1.launches, kernel.launches)
        if launches[f"ladder_{algo}"] != (steps + 1, 0):
            raise AssertionError(f"eval_ladder {algo} at config E: (K1, K1b) launched "
                                 f"{launches[f'ladder_{algo}']} times, expected ({steps + 1}, 0)")
        if not np.isfinite(m["avg_throughput"]):
            raise AssertionError(f"eval_ladder {algo}: avg_throughput {m['avg_throughput']}")
        ladder[algo] = {"seconds": time.perf_counter() - t0,
                        "avg_throughput": m["avg_throughput"]}
    summary = {"envs": b, "agents": n, "reset_s": reset_s, "avg_throughput": throughput,
               "k1b_launches": launches["serve_e"][1], "k8_launches_per_episode": k8_episodes,
               "k4_launches_per_episode": k4_episodes, "k9_launches_per_episode": k9_episodes,
               "policy_b2_max_rel_err": max(errs), "policy_b2_decided": decided,
               "policy_b2_flips": flips, "ladder_world": idx, "ladder": ladder}
    print(f"serve_e (config E, {b} x {n}, maze256 bf16, greedy): " + json.dumps(summary),
          flush=True)
    return launches, summary


# -- training ----------------------------------------------------------------


def _sync_clock():
    """A phase_hook for the train steps and the dict it fills: seconds of
    each part on the host clock, the device drained at every boundary."""
    import torch

    seconds, last = {}, [None]

    def start():
        torch.cuda.synchronize()
        last[0] = time.perf_counter()

    def hook(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = now - last[0]
        last[0] = now

    return start, hook, seconds


def _small_train_setup(flavour, device, seed):
    """(core, model, config, make_step) of one train-step flavour at the
    train_agree size: 8 envs x 4 agents, 8x8, r=2, T=8, 2 epochs x 2
    minibatches, f32 model of width 32, weights from ``seed``."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch import parallel as tp
    from pogema_torch.models import init_embed_params, init_params, init_recurrent_params

    gc = GridConfig(seed=0, size=8, density=0.2, num_agents=4, obs_radius=2,
                    max_episode_steps=16, on_target="restart")
    gen = torch.Generator().manual_seed(seed)
    path = {"fused_windows": "windows", "fused_pre": "pre"}.get(flavour, "auto")
    cfg = tp.PPOConfig(rollout_steps=8, epochs=2, minibatches=2, obstacle_path=path)
    if flavour == "obs":
        core = PogemaCore(gc, num_envs=8, device=device)
        model, _ = init_params(gen, 5, hidden=32, channels=4, dtype=torch.float32)
        return core, model, cfg, tp.init_train_state, tp.make_train_step
    core = PogemaCore(gc, num_envs=8, auto_reset_mode="regen", device=device)
    if flavour == "recurrent":
        model, _ = init_recurrent_params(gen, 5, embed=32, hidden=32, dtype=torch.float32)
        return core, model, cfg, tp.init_recurrent_train_state, tp.make_recurrent_train_step
    model, _ = init_embed_params(gen, 5, embed=32, hidden=32, dtype=torch.float32)
    return core, model, cfg, tp.init_fused_train_state, tp.make_fused_train_step


def _replay_rollout(flavour, core, model, ts, n):
    """The rollout that a train step would make from ``ts``, again, with
    the logits kept: (actions [n, B, N], list of n logits)."""
    from pogema_torch.parallel import learner
    from pogema_torch.parallel import rollout as roll

    kept = []

    def keep(out):
        kept.append(out[-2])
        return out

    learner.load_params(model, ts.params)
    if flavour == "obs":
        fn = roll.make_rollout_fn(core, lambda o: keep(model(o)), n)
        traj = fn(ts.env_state, ts.initial_env_state, ts.obs, ts.key)[3]
    elif flavour == "recurrent":
        fn = roll.make_recurrent_rollout_fn(core, lambda *a: keep(model.step_from_state(*a)), n)
        traj = fn(ts.env_state, ts.initial_env_state, ts.h, ts.key)[3]
    else:
        pre = flavour == "fused_pre"
        apply = model.from_state_pre if pre else model.from_state
        fn = roll.make_state_rollout_fn(core, lambda *a: keep(apply(*a)), n,
                                        make_ctx=model.grid_embed if pre else None)
        traj = fn(ts.env_state, ts.initial_env_state, ts.key)[2]
    return traj.actions, kept


def _first_sampling_divergence(flavour, cores, models, states, n):
    """(step, margin) at the first rollout step whose sampled actions
    differ between the cpu (index 0) and the card (index 1), the margin
    being the smallest gap between the cpu's two largest Gumbel-perturbed
    logits among the agents that differ: a near-tie there is the only
    divergence that a device may cause. (None, None) when the first
    rollouts agree."""
    from pogema_torch.core import random as jr

    acts_c, logits_c = _replay_rollout(flavour, cores[0], models[0], states[0], n)
    acts_d, _ = _replay_rollout(flavour, cores[1], models[1], states[1], n)
    key = states[0].key
    for t in range(n):
        key, k_act = jr.split(key)
        differ = acts_c[t] != acts_d[t].cpu()
        if differ.any():
            noisy = logits_c[t] + jr.gumbel(k_act, tuple(logits_c[t].shape))
            return t, float(_top2_margin(noisy)[differ].min())
    return None, None


def check_k1_update_shapes(device):
    """K1 and K1b against their plain versions at the shapes the updates
    give them."""
    import torch

    from pogema_torch.ops.windows import extract_windows_packed_ref, packed_observation_ref

    kernel, k1b = _kernels()
    # The update hands the kernels slices of mixed or env-major tensors: the
    # wrappers refuse a view, and the callers' contiguous copies give the
    # plain version's result. Recurrent replay at config D (B = 128, M = 128),
    # the fused 'windows' loss of train_ff (B = 16384, M = 8).
    for b, p, m, r in ((128, 74, 128, 5), (16384, 26, 8, 5)):
        grid, _ = random_windows_inputs(b, p, m, r, device, seed=b)
        g = torch.Generator().manual_seed(b)
        xy_all = torch.randint(r, p - r, (b, 4, m, 2), generator=g, dtype=torch.int32).to(device)
        view = xy_all[:, 2]  # a time slice of an env-major [B, T, M, 2] tensor
        try:
            kernel(grid, view, 2 * r + 1)
        except ValueError:
            pass
        else:
            raise AssertionError("K1's wrapper took a non-contiguous xy")
        grid_view = torch.stack([grid, grid], dim=1)[:, 1]  # a minibatch column of mixed grids
        got = kernel(grid_view.contiguous(), view.contiguous(), 2 * r + 1)
        if not torch.equal(got, extract_windows_packed_ref(grid_view, view, 2 * r + 1)):
            raise AssertionError(f"K1 differs from its plain version at B={b} M={m}")
        txy_all = torch.randint(0, p, (b, 4, m, 2), generator=g, dtype=torch.int32).to(device)
        active_all = (torch.rand(b, 4, m, generator=g) < 0.7).to(device)
        views = (grid_view, view, txy_all[:, 1], active_all[:, 3])
        for i in range(4):
            mixed = tuple(v if j == i else v.contiguous() for j, v in enumerate(views))
            _expect_refused(lambda: k1b(*mixed, 2 * r + 1), f"K1b input {i} as a view")
        copies = tuple(v.contiguous() for v in views)
        got = k1b(*copies, 2 * r + 1)
        for lo in range(0, b, 1024):
            ref = packed_observation_ref(*(c[lo:lo + 1024] for c in copies), 2 * r + 1)
            if not torch.equal(got[lo:lo + 1024], ref):
                raise AssertionError(f"K1b differs from its plain version at B={b} N={m}")
    print("K1 and K1b bit-equal to their plain versions at the update's shapes (B=128 M=128 "
          "P=74; B=16384 M=8 P=26) from contiguous copies of views; each view itself is refused",
          flush=True)


def _train_agree(flavour, device, setup, expect_k1b=None):
    """Two train steps of ``flavour`` on the card and on the cpu from the
    same numpy state, for the first of seeds 0-2 whose trajectories agree
    (f32 model; ``setup(flavour, device, seed)`` gives core, model, config
    and the step's init and make). Integer state and key bit-equal, or
    first differing at a near-tie of a sampled action; stats, first-
    minibatch gradients and parameters within TRAIN_*_TOL. With
    ``expect_k1b`` the card's (K1, K1b) launches over both steps must be
    exactly (0, 2 * expect_k1b). Returns the report lines."""
    import numpy as np
    import torch

    from pogema_torch.interop import train_state_from_numpy, train_state_to_numpy

    k1, k1b = _kernels()
    report = []
    for seed in (0, 1, 2):
        core_c, model_c, cfg, init, make = setup(flavour, "cpu", seed)
        core_d, model_d = setup(flavour, device, seed)[:2]
        ts_c, tx = init(core_c, model_c, None, cfg, core_c.make_key(seed + 1))
        arrays = train_state_to_numpy(ts_c)
        ts_d = train_state_from_numpy(arrays, device, torch.float32)
        grads = {"cpu": [], device: []}
        steps = {d: make(c, m, cfg, tx, grad_hook=lambda e, i, loss, g, d=d:
                         grads[d].append({k: v.detach().cpu() for k, v in g.items()}))
                 for d, c, m in (("cpu", core_c, model_c), (device, core_d, model_d))}
        before = (k1.launches, k1b.launches)
        starts, stats = [], []
        for _ in range(2):
            starts.append((ts_c, ts_d))
            ts_c, st_c = steps["cpu"](ts_c)
            ts_d, st_d = steps[device](ts_d)
            stats.append((st_c, st_d))
        used = (k1.launches - before[0], k1b.launches - before[1])
        # The observation-based step reads the env's 'grid' layout
        # (K1); the state-based ones build the packed observation
        # (K1b); 'pre' convolves the grids instead.
        want = {"obs": (True, False), "fused_pre": (False, False)}.get(flavour, (False, True))
        if device != "cpu" and (used[0] > 0, used[1] > 0) != want:
            raise AssertionError(f"{flavour}: (K1, K1b) launched {used} times on the card")
        if expect_k1b is not None and used != (0, 2 * expect_k1b):
            raise AssertionError(f"{flavour}: (K1, K1b) launched {used} times over two train "
                                 f"steps, expected (0, {2 * expect_k1b})")
        same = (_states_equal(ts_c.env_state, ts_d.env_state)
                and torch.equal(ts_c.key, ts_d.key.cpu()))
        if not same:
            for i, pair in enumerate(starts):
                t, margin = _first_sampling_divergence(
                    flavour, (core_c, core_d), (model_c, model_d), pair, cfg.rollout_steps)
                if t is not None:
                    break
            report.append(f"{flavour}/seed {seed}: first differs in train step {i} at "
                          f"rollout step {t}, perturbed-logit margin {margin}")
            if t is not None and margin >= 1e-5:
                raise AssertionError(f"{flavour} on {device} differs from cpu beyond a "
                                     f"near-tie: step {t}, margin {margin}")
            if t is None:
                raise AssertionError(f"{flavour} on {device}: integer state differs from "
                                     f"cpu after equal rollouts")
            continue
        worst_stat = 0.0
        for st_c, st_d in stats:
            for k in st_c:
                a, b_ = float(st_c[k]), float(st_d[k])
                if not np.isfinite(b_):
                    raise AssertionError(f"{flavour}: stat {k} on {device} is {b_}")
                worst_stat = max(worst_stat, abs(a - b_) / max(1.0, abs(a)))
        g_c, g_d = grads["cpu"][0], grads[device][0]
        scale = max(float(v.abs().max()) for v in g_c.values())
        worst_grad = max(float((g_c[k] - g_d[k]).abs().max()) for k in g_c) / scale
        worst_mu = max(float((ts_c.opt_state["mu"][k] - ts_d.opt_state["mu"][k].cpu())
                             .abs().max()) for k in g_c) / scale
        diffs = torch.cat([(ts_c.params[k] - ts_d.params[k].cpu()).abs().flatten()
                           for k in ts_c.params])
        adam_steps = 2 * cfg.epochs * cfg.minibatches
        share = float((diffs <= TRAIN_PARAM_TOL).float().mean())
        report.append(f"{flavour}/seed {seed}: integer state and key bit-equal, "
                      f"(K1, K1b) launched {used} times; stats {worst_stat:.2e}, first-minibatch "
                      f"gradients {worst_grad:.2e}, Adam mu {worst_mu:.2e} (of the largest "
                      f"gradient entry), parameters max {float(diffs.max()):.2e}, "
                      f"{share:.4f} within {TRAIN_PARAM_TOL}")
        if (worst_stat > TRAIN_STATS_TOL or worst_grad > TRAIN_GRAD_TOL
                or worst_mu > TRAIN_GRAD_TOL or share < 0.99
                or float(diffs.max()) > 2 * cfg.lr * adam_steps):
            raise AssertionError(f"{flavour} on {device} differs from cpu beyond the "
                                 f"tolerance: {report[-1]}")
        return report
    raise AssertionError(f"{flavour}: no seed gave equal trajectories: {report}")


def phase_train_agree(device):
    """Two train steps of each flavour on the card and on the cpu from
    the same numpy state (f32 model, small size), after K1 at the
    update's shapes."""
    import torch

    if device != "cpu":
        check_k1_update_shapes(device)
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions in f32, as on the cpu
    report = []
    try:
        for flavour in ("obs", "fused_windows", "fused_pre", "recurrent"):
            report += _train_agree(flavour, device, _small_train_setup)
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
        print("train_agree (card vs cpu, f32, two train steps; tolerances: stats "
              f"{TRAIN_STATS_TOL}, gradients {TRAIN_GRAD_TOL}, parameters 99% within "
              f"{TRAIN_PARAM_TOL}):\n  " + "\n  ".join(report), flush=True)


def _run_train_steps(label, core, model, cfg, init, make, key_seed, steps, expect_k1b,
                     expect_finished, device):
    """``steps`` train steps with the per-step prints and checks shared by
    the training phases: finite stats, entropy in (0, ln 5), the expected
    episodes finished and K1b launches (and no K1 launch: the state-based
    learners build packed observations), finite gradients, changed and
    finite parameters that the module also holds, the state invariants.
    Returns ((K1, K1b) launches, list of per-step dicts)."""
    import math

    import torch

    from pogema_torch.models import EmbedActorCritic
    from pogema_torch.ops.cuda_policy import policy_cuda

    k1, kernel = _kernels()
    start, hook, seconds = _sync_clock()
    finite = [torch.ones((), dtype=torch.bool, device=device)]

    def grad_hook(epoch, i, loss, grads):
        for g in grads.values():
            finite[0] = finite[0] & torch.isfinite(g).all()

    ts, tx = init(core, model, None, cfg, core.make_key(key_seed))
    step = make(core, model, cfg, tx, grad_hook=grad_hook, phase_hook=hook)
    k1.launches = kernel.launches = 0
    out = []
    for i in range(steps):
        before, convs, k8 = kernel.launches, EmbedActorCritic.grid_embed.calls, policy_cuda.launches
        old = ts.params
        torch.cuda.reset_peak_memory_stats()
        start()
        ts, stats = step(ts)
        torch.cuda.synchronize()
        total = sum(seconds.values())
        host = {k: float(v) for k, v in stats.items()}
        rec = {"step": i, "stats": host, "seconds": dict(seconds), "seconds_total": total,
               "env_steps_per_s": core.num_envs * cfg.rollout_steps / total,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "k1_launches": k1.launches, "k1b_launches": kernel.launches - before,
               "grid_convs": EmbedActorCritic.grid_embed.calls - convs,
               "k8_launches": policy_cuda.launches - k8}
        print(f"{label} step {i}: " + json.dumps(rec), flush=True)
        out.append(rec)
        if not all(math.isfinite(v) for v in host.values()):
            raise AssertionError(f"{label} step {i}: non-finite stats {host}")
        if not 0.0 < host["entropy"] < math.log(5):
            raise AssertionError(f"{label} step {i}: entropy {host['entropy']} outside (0, ln 5)")
        if host["episodes_finished"] != expect_finished[i]:
            raise AssertionError(f"{label} step {i}: {host['episodes_finished']} episodes "
                                 f"finished, expected {expect_finished[i]}")
        if rec["k1b_launches"] != expect_k1b or k1.launches != 0:
            raise AssertionError(f"{label} step {i}: K1b launched {rec['k1b_launches']} times, "
                                 f"expected {expect_k1b}; K1 {k1.launches} times, expected 0")
        if rec["k8_launches"] != 0:
            raise AssertionError(f"{label} step {i}: K8 launched {rec['k8_launches']} times, "
                                 "expected 0 (the learner runs outside inference mode)")
        if not bool(finite[0]):
            raise AssertionError(f"{label} step {i}: a gradient is not finite")
        if not any(not torch.equal(old[k], ts.params[k]) for k in old):
            raise AssertionError(f"{label} step {i}: the parameters did not change")
        if not all(torch.isfinite(v).all() for v in ts.params.values()):
            raise AssertionError(f"{label} step {i}: a parameter is not finite")
        check_state_invariants(ts.env_state)
        own = dict(model.named_parameters())
        if not all(torch.equal(own[k], ts.params[k]) for k in own):
            raise AssertionError(f"{label}: the module does not hold the new parameters")
    return (k1.launches, kernel.launches), out


def phase_train(device):
    """The training path at full width: recurrent PPO on config D (1024
    envs x 128 agents, 64x64, r=5, LifeLong, regen auto-reset) from the
    shipped rec128_ft weights in bf16, three train steps of T = 64, 2
    epochs x 8 minibatches. Every episode ends in the second step (step
    128), where regen makes every map anew."""
    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch import parallel as tp
    from pogema_torch.interop import load_policy

    core = PogemaCore(GridConfig(seed=0, **CONFIG_D), num_envs=NUM_ENVS_D,
                      auto_reset_mode="regen", device=device)
    model = load_policy(WEIGHTS, device=device)
    cfg = tp.PPOConfig(**TRAIN_D_PPO)
    t, e, m = cfg.rollout_steps, cfg.epochs, cfg.minibatches
    launches, recs = _run_train_steps(
        "train (config D, rec128_ft bf16)", core, model, cfg, tp.init_recurrent_train_state,
        tp.make_recurrent_train_step, 1, TRAIN_STEPS, t + 1 + e * m * t,
        [0.0, float(NUM_ENVS_D), 0.0], device)
    thr = recs[1]["stats"]["episode_avg_throughput"]
    lo, hi = TRAIN_D_THROUGHPUT
    if not lo <= thr <= hi:
        raise AssertionError(f"episode_avg_throughput of the second step {thr} outside the "
                             f"predicted range [{lo}, {hi}]")
    best = min(recs, key=lambda r: r["seconds_total"])
    summary = {"seconds_per_step": [r["seconds_total"] for r in recs], "best_split_s": best["seconds"],
               "env_steps_per_s_best": best["env_steps_per_s"],
               "peak_gib": max(r["peak_gib"] for r in recs),
               "k1b_launches_per_step": launches[1] / TRAIN_STEPS,
               "k8_launches_per_step": [r["k8_launches"] for r in recs],
               "episode_avg_throughput_step1": thr}
    print("train summary: " + json.dumps(summary), flush=True)
    return launches, summary


def phase_train_ff(device):
    """The feedforward fused learner at 1024 envs x 8 agents, 16x16, r=5,
    embed/hidden 256, T = 64, 2 epochs x 4 minibatches, random bf16 init:
    three steps with obstacle_path='auto' (picks 'pre': no kernel launch,
    two grid convolutions per rollout and one per loss), then one step
    with 'windows' (K1b once per rollout step, once for the bootstrap,
    once per loss). Returns (((K1, K1b) launches 'pre', (K1, K1b) launches
    'windows'), summary)."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch import parallel as tp
    from pogema_torch.models import init_embed_params

    out, launches = {}, {}
    for path, steps in (("auto", TRAIN_STEPS), ("windows", 1)):
        core = PogemaCore(GridConfig(seed=0, **TRAIN_FF_GRID), num_envs=1024,
                          auto_reset_mode="regen", device=device)
        model, _ = init_embed_params(torch.Generator().manual_seed(0), core.cfg.window,
                                     embed=256, hidden=256)
        cfg = tp.PPOConfig(obstacle_path=path, **TRAIN_FF_PPO)
        t, e, m = cfg.rollout_steps, cfg.epochs, cfg.minibatches
        expect_k1b = 0 if path == "auto" else t + 1 + e * m
        launches[path], recs = _run_train_steps(
            f"train_ff ({path})", core, model, cfg, tp.init_fused_train_state,
            tp.make_fused_train_step, 1, steps, expect_k1b, [0.0, 1024.0, 0.0], device)
        convs = [r["grid_convs"] for r in recs]
        want_convs = 2 + e * m if path == "auto" else 0
        if any(c != want_convs for c in convs):
            raise AssertionError(f"train_ff ({path}): {convs} grid convolutions per step, "
                                 f"expected {want_convs}")
        best = min(recs, key=lambda r: r["seconds_total"])
        out[path] = {"seconds_per_step": [r["seconds_total"] for r in recs],
                     "best_split_s": best["seconds"], "env_steps_per_s_best": best["env_steps_per_s"],
                     "peak_gib": max(r["peak_gib"] for r in recs), "grid_convs_per_step": convs[0],
                     "k1b_launches_per_step": launches[path][1] / steps}
    print("train_ff summary: " + json.dumps(out), flush=True)
    return (launches["auto"], launches["windows"]), out


def phase_k1_shapes(device):
    """K1 and K1b beside their bounds, plain versions and library
    yardsticks at the config-D serving shape, at the recurrent update's
    shape and for one env (B = 1) of 64 and of 128 agents, and K1 for one
    config-E env (B = 1, M = 256, P = 138; config C's are in the kernel
    records themselves, K1b's at config E in phase k1b_wide);
    then the device time of both at all three shapes for 16 to 128
    centres per block, beside the number the wrapper picks (the table that
    ``ops/cuda_windows.py::centres_per_block`` was read off). Returns
    (K1's dict, K1b's dict), each with ``by_centres_per_block``."""
    import torch

    from pogema_torch.ops import cuda_windows as cw

    r, w = CONFIG_D["obs_radius"], 2 * CONFIG_D["obs_radius"] + 1
    p, n = CONFIG_D["size"] + 2 * r, CONFIG_D["num_agents"]
    small = NUM_ENVS_D // TRAIN_D_PPO["minibatches"]
    out = ({}, {})
    for name, b in (("serve_config_d", NUM_ENVS_D), ("train_update_config_d", small)):
        out[0][name] = dict(B=b, M=n, P=p, **time_k1(device, b, p, n, r))
        out[1][name] = dict(B=b, N=n, P=p, **time_k1b(device, b, p, n, r))
    # One env (the rim's Pogema) with config C's and config D's agent counts.
    for m in (CONFIG_C["num_agents"], n):
        out[0][f"one_env_n{m}"] = dict(B=1, M=m, P=p, **time_k1(device, 1, p, m, r))
        out[1][f"one_env_n{m}"] = dict(B=1, N=m, P=p, **time_k1b(device, 1, p, m, r))
    # One config-E env (the eval ladder's PPO leg): K1 at P = 138, M = 256.
    pe, ne = CONFIG_E["size"] + 2 * r, CONFIG_E["num_agents"]
    out[0]["one_env_config_e"] = dict(B=1, M=ne, P=pe, **time_k1(device, 1, pe, ne, r))

    k1, k1b = _kernels()
    saved = k1.launches, k1b.launches
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sweep = ({}, {})
    nc = CONFIG_C["num_agents"]
    for name, b, m, nn in (("config_c", NUM_ENVS_C, 2 * nc, nc), ("serve_config_d", NUM_ENVS_D, n, n),
                           ("train_update_config_d", small, n, n)):
        grid, xy = random_windows_inputs(b, p, m, r, device, seed=7)
        args = random_obs_inputs(b, p, nn, r, device, seed=11)
        picks = (cw.centres_per_block(b, m, sms, p * p, 4 * 128, cw.K1_AMORTISE, cw.K1_FILL),
                 cw.centres_per_block(b, nn, sms, p * p, 12 * w * w, cw.K1B_AMORTISE,
                                      cw.observation_fill(p, w, nn), multiple=4))
        runs = (lambda mc: cw._launch_windows(grid, xy, w, mc),
                lambda mc: cw._launch_observation(*args, w, mc))
        for i, (most, row_bytes) in enumerate(((m, 4 * 128), (nn, 12 * w * w))):
            launches = _graph_launches(b * most * row_bytes)
            times = {mc: graph_time_ms(lambda: runs[i](mc), launches)
                     for mc in sorted({16, 32, 64, 128, picks[i]}) if mc <= most}
            sweep[i][name] = {"wrapper_picks": picks[i], "device_ms": times}
            print(f"{('K1', 'K1b')[i]} {name} (B={b}) device ms by centres per block, wrapper "
                  f"picks {picks[i]}: " + ", ".join(f"{mc}: {t:.4f}" for mc, t in times.items()),
                  flush=True)
    k1.launches, k1b.launches = saved
    for i in (0, 1):
        out[i]["by_centres_per_block"] = sweep[i]
    return out


def phase_pomapf(device, steps=64):
    """K1 on a full-width path: config C with ``observation_type='POMAPF'``
    (the dict of per-agent obstacle and agent windows plus own and target
    coordinates), a reset and ``steps`` cached ``step_autoreset`` steps.
    The obstacle windows of the pre-reset and the post-reset observation
    of a step share one K1 launch. Returns ((K1, K1b) launches, summary)."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.ops.windows import extract_windows, pairwise_agent_windows

    k1, k1b = _kernels()
    core = PogemaCore(GridConfig(seed=0, observation_type="POMAPF", **CONFIG_C),
                      num_envs=NUM_ENVS_C, maze=True, device=device)
    b, n, w, r = NUM_ENVS_C, CONFIG_C["num_agents"], core.cfg.window, core.cfg.obs_radius
    gen = torch.Generator(device=device).manual_seed(4)

    def check(state, obs):
        check_state_invariants(state)
        if set(obs) != {"obstacles", "agents", "xy", "target_xy"}:
            raise AssertionError(f"POMAPF observation keys {sorted(obs)}")
        if obs["obstacles"].shape != (b, n, w, w) or obs["agents"].shape != (b, n, w, w):
            raise AssertionError("POMAPF windows of a wrong shape")
        if not (torch.equal(obs["xy"], state.agents_xy - r)
                and torch.equal(obs["target_xy"], state.targets_xy - r)):
            raise AssertionError("POMAPF coordinates are not the unpadded state's")
        idx = torch.linspace(0, b - 1, 64, device=device).long()
        if not torch.equal(obs["obstacles"][idx],
                           extract_windows(state.obstacles[idx], state.agents_xy[idx], w)):
            raise AssertionError("POMAPF obstacle windows differ from the plain windows")
        if not torch.equal(obs["agents"][idx],
                           pairwise_agent_windows(state.agents_xy[idx], state.active[idx], w)):
            raise AssertionError("POMAPF agent windows differ from the plain version")
        # An active agent stands alone at the centre of its own windows, on a free cell.
        if (not (obs["agents"][:, :, r, r][state.active] == 1).all()
                or obs["obstacles"][:, :, r, r][state.active].any()):
            raise AssertionError("POMAPF windows are not centred on the agents")

    k1.launches = k1b.launches = 0
    state, obs = core.reset(0)
    check(state, obs)
    init = state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        actions = torch.randint(0, 5, (b, n), device=device, generator=gen, dtype=torch.int32)
        state, obs, res, _, _ = core.step_autoreset(state, init, actions)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    check(state, obs)
    launches = (k1.launches, k1b.launches)
    if launches != (1 + steps, 0):
        raise AssertionError(f"(K1, K1b) launched {launches} times over reset + {steps} POMAPF "
                             f"steps, expected ({1 + steps}, 0)")
    summary = {"steps": steps, "ms_per_step": ms, "k1_launches": launches[0],
               "k1b_launches": launches[1]}
    print("pomapf (config C, cached, POMAPF dict observations): " + json.dumps(summary), flush=True)
    return launches, summary


# -- the host rim ------------------------------------------------------------


def _host_equal(a, b) -> bool:
    """Bit-equal host values of the rim: numpy arrays (dtype and shape
    too), lists, tuples, dicts, Python scalars."""
    import numpy as np

    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_host_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_host_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _median_ms(seconds):
    return float(sorted(seconds)[len(seconds) // 2] * 1e3)


def _replay_parts(core, key, actions, final_state, as_array, auto_reset):
    """An episode of ``core`` from ``key`` again, through the parts of a
    rim step, each on the host clock with the device drained at its end:
    the actions' upload (as ``PogemaCore`` makes it), the core step, and
    the host copy of what the step returns (``fetch``). The replay must end
    in ``final_state``, the state of the timed run. Returns ({part: median
    ms}, the last step's copied tree)."""
    import torch

    from pogema_torch.utils.host import fetch

    state, _ = core.reset(key)
    init = state
    secs = {"upload_ms_median": [], "core_step_ms_median": [], "host_copy_ms_median": []}
    for a in actions:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acts = torch.as_tensor(as_array(a), device=core.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if auto_reset:
            state, obs, res, done, mets = core.step_autoreset(state, init, acts)
        else:
            state, res, done, mets = core.step(state, acts)
            obs = res.observations
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tree = (obs, res.rewards, res.terminated, res.truncated, done, mets)
        fetch(tree)
        t3 = time.perf_counter()
        for k, dt in zip(secs, (t1 - t0, t2 - t1, t3 - t2)):
            secs[k].append(dt)
    if not _states_equal(state, final_state):
        raise AssertionError("the replay through the parts of a step left another state")
    return {k: _median_ms(v) for k, v in secs.items()}, tree


def phase_rim_agree(device):
    """``pogema_v0`` on the card against ``pogema_v0`` on the CPU, the same
    actions (A* on the CPU env's observations, a quarter of them replaced
    by random moves, so that agents reach goals and collide): one seeded
    episode of 16x16, 8 agents, r=3, up to 64 steps for each on_target x
    observation type; then 16 steps of ``PogemaVectorEnv``
    (packed and grid, cached and regen; 8 envs whose episodes end every 8
    steps). Every output (observations, rewards, flags, infos, metrics,
    final observations) bit-equal."""
    import numpy as np

    from pogema_torch import BatchAStarAgent, GridConfig, PogemaVectorEnv, pogema_v0

    report = []
    for ot in ("finish", "nothing", "restart"):
        for obs_type in ("default", "POMAPF", "MAPF"):
            gc = GridConfig(seed=len(report), size=16, num_agents=8, obs_radius=3,
                            max_episode_steps=64, on_target=ot, observation_type=obs_type)
            envs = [pogema_v0(gc, device=d) for d in ("cpu", device)]
            outs = [e.reset() for e in envs]
            if not _host_equal(*outs):
                raise AssertionError(f"pogema_v0 reset on {device} differs from cpu: "
                                     f"{ot}/{obs_type}")
            rng, astar = np.random.default_rng(len(report)), BatchAStarAgent()
            for t in range(64):
                a = [int(r) if rng.random() < 0.25 else p
                     for p, r in zip(astar.act(outs[0][0]), rng.integers(0, 5, size=8))]
                outs = [e.step(a) for e in envs]
                if not _host_equal(*outs):
                    raise AssertionError(f"pogema_v0 on {device} differs from cpu: {ot}/{obs_type} "
                                         f"step {t}")
                if all(x or y for x, y in zip(outs[0][2], outs[0][3])):
                    break
            report.append(f"{ot}/{obs_type} {t + 1} steps {outs[0][4][0]['metrics']}")
    for layout in ("packed", "grid"):
        for mode in ("cached", "regen"):
            gc = GridConfig(seed=3, size=16, num_agents=8, obs_radius=3, max_episode_steps=8)
            envs = [PogemaVectorEnv(gc, num_vec_envs=8, obs_layout=layout, auto_reset_mode=mode,
                                    device=d) for d in ("cpu", device)]
            if not _host_equal(*(e.reset() for e in envs)):
                raise AssertionError(f"PogemaVectorEnv reset on {device} differs: {layout}/{mode}")
            rng, ended = np.random.default_rng(5), 0
            for t in range(16):
                a = rng.integers(0, 5, size=envs[0].num_envs)
                outs = [e.step(a) for e in envs]
                if not _host_equal(*outs):
                    raise AssertionError(f"PogemaVectorEnv on {device} differs from cpu: "
                                         f"{layout}/{mode} step {t}")
                ended += int(outs[0][4].get("_final_obs", np.zeros(1, bool)).sum())
            if ended != 2 * envs[0].num_envs:
                raise AssertionError(f"{ended} agent slots ended, expected {2 * envs[0].num_envs}")
            report.append(f"vector {layout}/{mode} 16 steps")
    print("rim_agree (card vs cpu, bit for bit): " + "; ".join(report), flush=True)


def phase_rim_env(device):
    """The single env at full width: ``pogema_v0`` of RIM_ENV (64x64, 64
    agents, r=5, 'default' observations in the grid layout), 'finish' and
    'restart', one whole episode each with random actions: K1 launched
    exactly once per step and once for the reset, K1b never. Per step, the
    median host-clock ms of ``env.step``; then, outside the counted run,
    the same episode again through the parts of a step (the actions'
    upload, the core step synchronised, the host copy of its results),
    which must end in the env's own final state.
    Then ``PPOPolicy`` from the committed rec128_ft.npz in bf16 on one env
    of config D's shape for its 128 steps: ms per ``act``, the episode's
    avg_throughput, and over the first 16 steps the card's logits against
    the same policy on the CPU given the same observations (POLICY_TOL;
    greedy actions equal where the CPU's top-2 margin exceeds twice it).
    Returns ((K1, K1b) launches of the two random episodes, summary)."""
    import numpy as np
    import torch

    from pogema_torch import GridConfig, pogema_v0
    from pogema_torch.toolbox import PPOPolicy
    from pogema_torch.utils.host import nbytes

    k1, k1b = _kernels()
    n = RIM_ENV["num_agents"]
    summary, total = {}, [0, 0]
    for ot in ("finish", "restart"):
        env = pogema_v0(GridConfig(on_target=ot, **RIM_ENV), device=device)
        rng = np.random.default_rng(0)
        k1.launches = k1b.launches = 0
        env.reset()
        step_s, actions = [], []
        while True:
            actions.append(rng.integers(0, 5, size=n).tolist())
            t0 = time.perf_counter()
            _, _, term, trunc, infos = env.step(actions[-1])
            step_s.append(time.perf_counter() - t0)
            if all(x or y for x, y in zip(term, trunc)):
                break
        launches = (k1.launches, k1b.launches)
        if launches != (len(step_s) + 1, 0):
            raise AssertionError(f"rim_env {ot}: (K1, K1b) launched {launches} times over a reset "
                                 f"and {len(step_s)} steps, expected ({len(step_s) + 1}, 0)")
        total = [total[0] + launches[0], total[1] + launches[1]]
        check_state_invariants(env._state)
        parts, tree = _replay_parts(env._core, env._core.make_key(RIM_ENV["seed"]), actions,
                                    env._state, lambda a: np.asarray(a, np.int32)[None, :],
                                    auto_reset=False)
        summary[ot] = {"steps": len(step_s), "ms_per_step_median": _median_ms(step_s), **parts,
                       "bytes_per_step": nbytes(tree), "k1_launches": launches[0],
                       "k1b_launches": launches[1], "metrics": infos[0]["metrics"]}

    env = pogema_v0(GridConfig(seed=0, **CONFIG_D), device=device)
    card, host = PPOPolicy(WEIGHTS, device=device), PPOPolicy(WEIGHTS, device="cpu")
    k1.launches = k1b.launches = 0
    obs, _ = env.reset()
    act_s, errs, decided, flips = [], [], 0, 0
    for t in range(CONFIG_D["max_episode_steps"]):
        if t < 16:
            logits, ref = card.logits(obs), host.logits(obs)
            acts = logits.argmax(-1).tolist()
            errs.append(float((np.abs(logits - ref) / np.maximum(1.0, np.abs(ref))).max()))
            top2 = np.sort(ref, axis=-1)[:, -2:]
            mask = top2[:, 1] - top2[:, 0] > 2 * POLICY_TOL
            decided += int(mask.sum())
            flips += int((logits.argmax(-1) != ref.argmax(-1))[mask].sum())
        else:
            t0 = time.perf_counter()
            acts = card.act(obs)
            act_s.append(time.perf_counter() - t0)
        obs, _, term, trunc, infos = env.step(acts)
    thr = infos[0]["metrics"]["avg_throughput"]
    if not all(trunc) or not np.isfinite(thr) or thr <= 0:
        raise AssertionError(f"PPO episode: truncated {all(trunc)}, avg_throughput {thr}")
    if (k1.launches, k1b.launches) != (CONFIG_D["max_episode_steps"] + 1, 0):
        raise AssertionError(f"PPO episode: (K1, K1b) launched {(k1.launches, k1b.launches)} times")
    summary["ppo_config_d_one_env"] = {
        "ms_per_act_median": _median_ms(act_s), "avg_throughput": thr,
        "max_rel_err_first_16": max(errs), "greedy_decided": decided, "greedy_flips": flips,
        "k1_launches": k1.launches}
    print("rim_env (pogema_v0 at 64x64, 64 agents; PPOPolicy on one config-D env): "
          + json.dumps(summary), flush=True)
    if max(errs) > POLICY_TOL or flips or not decided:
        raise AssertionError("the card's PPOPolicy differs from the cpu's beyond the tolerance")
    return tuple(total), summary


def _check_obs_sample(label, what, got, cfg, state, idx):
    """``got`` (the flat host observations of every env) against the plain
    observation on the CPU of the envs ``idx`` of ``state``."""
    import numpy as np
    import torch

    from pogema_torch.core import step as step_mod

    sample = state.replace(**{f: v[idx].cpu() for f, v in state.tensors().items()})
    ref = step_mod.observe_state(cfg, sample)
    n = cfg.num_agents
    rows = (idx[:, None].cpu() * n + torch.arange(n)).flatten().numpy()
    leaves = got.items() if isinstance(got, dict) else [(None, got)]
    for k, v in leaves:
        want = (ref if k is None else ref[k]).reshape((len(rows),) + v.shape[1:]).numpy()
        if not np.array_equal(v[rows], want.astype(v.dtype)):
            raise AssertionError(f"rim_vector {label}: {what} {k} differ from the plain ones")


def phase_rim_vector(device):
    """``PogemaVectorEnv`` at config C's widths (64x64 mazes, 64 agents,
    r=5, 'finish') with RIM_VECTOR_ENVS envs and cached auto-reset: a reset
    and 64 steps with the packed layout (K1b twice per step and once for
    the reset, K1 never), with the grid layout (K1 once per step, shared by
    the two observation sets of a cached step, and once for the reset),
    and 16 steps of POMAPF (K1 likewise). Episodes are cut to 48 steps (12
    for POMAPF), so that every env ends inside the window: that step also
    copies the terminal observations (``final_obs``) to the host. For
    each: the bytes copied to the host (``fetch.bytes``) and the terminal
    rows copied (``PogemaVectorEnv._final_obs.rows``). The returned
    observations of the last step and the terminal observations of the
    ending step are held, for a sample of envs, against the plain
    observation on the CPU. The benchmark's cell ``rim.vector`` times
    this path at config C's 4096 envs. Returns ({label: (K1, K1b)
    launches}, summary)."""
    import numpy as np
    import torch

    from pogema_torch import GridConfig, PogemaVectorEnv
    from pogema_torch.core import step as step_mod
    from pogema_torch.utils import host

    k1, k1b = _kernels()
    b = RIM_VECTOR_ENVS
    launches, summary = {}, {}
    for label, layout, obs_type, steps, ep in (("packed", "packed", "default", 64, 48),
                                               ("grid", "grid", "default", 64, 48),
                                               ("pomapf", "grid", "POMAPF", 16, 12)):
        gc = GridConfig(seed=0, observation_type=obs_type,
                        **dict(CONFIG_C, max_episode_steps=ep))
        env = PogemaVectorEnv(gc, num_vec_envs=b, obs_layout=layout, maze=True, device=device)
        rng = np.random.default_rng(0)
        acts = [rng.integers(0, 5, size=env.num_envs) for _ in range(steps)]
        k1.launches = k1b.launches = 0
        env.reset()
        copied, rows = host.fetch.bytes, PogemaVectorEnv._final_obs.rows
        for t, a in enumerate(acts):
            if t == ep - 1:
                before_end = env._state
            obs, rew, term, trunc, infos = env.step(a)
            if t == ep - 1:
                end_infos = infos
        got = (k1.launches, k1b.launches)
        want = (0, 1 + 2 * steps) if layout == "packed" else (1 + steps, 0)
        if got != want:
            raise AssertionError(f"rim_vector {label}: (K1, K1b) launched {got} times, "
                                 f"expected {want}")
        if PogemaVectorEnv._final_obs.rows - rows != b:
            raise AssertionError(f"rim_vector {label}: {PogemaVectorEnv._final_obs.rows - rows} "
                                 f"terminal rows copied, expected {b}")
        launches[label] = got
        core, state = env._core, env._state
        idx = torch.linspace(0, b - 1, 16, device=device).long()
        # The returned observations are those of the state now held.
        _check_obs_sample(label, "observations", obs, core.cfg, state, idx)
        # The terminal observations: every env ends at the ending step, and
        # the state it reached before its reset is that step again,
        # without observations.
        ended, _ = step_mod.step(core.cfg, before_end, torch.as_tensor(
            acts[ep - 1].reshape(b, -1), device=device).to(torch.int32), with_obs=False)
        done = step_mod.episode_done(core.cfg, ended).cpu().numpy()
        if not done.all() or not end_infos["_final_obs"].all():
            raise AssertionError(f"rim_vector {label}: {int(done.sum())} of {b} envs ended at "
                                 f"step {ep}, final_obs mask {end_infos['_final_obs'].sum()}")
        _check_obs_sample(label, "final_obs", end_infos["final_obs"], core.cfg, ended, idx)
        check_state_invariants(state)
        summary[label] = {"envs": b, "agents": core.cfg.num_agents, "steps": steps,
                          "episode_steps": ep,
                          "bytes_to_host_per_step": (host.fetch.bytes - copied) / steps,
                          "final_obs_host_bytes": sum(
                              v.nbytes for v in (end_infos["final_obs"].values()
                                                 if obs_type == "POMAPF"
                                                 else [end_infos["final_obs"]])),
                          "k1_launches": got[0], "k1b_launches": got[1]}
        del env, obs, infos, end_infos, before_end, ended
    print("rim_vector (PogemaVectorEnv, config C widths, 1024 envs, cached): "
          + json.dumps(summary), flush=True)
    return launches, summary


def phase_rim_toolbox(device):
    """``toolbox.evaluate`` on the card with A* ('default' observations)
    and with the planner ('MAPF'), on warehouse-32x32 from the port's
    registry and on random 32x32 maps (density 0.3), 16 agents, r=5,
    64-step episodes, seeds 0 and 1; every metric equal to the same
    evaluation on the CPU."""
    from pogema_torch.toolbox import evaluate

    base = dict(num_agents=16, obs_radius=5, max_episode_steps=64)
    out = {}
    for algo, extra in (("A*", {}), ("Planner", {"observation_type": "MAPF"})):
        envs = {"warehouse-32x32": dict(base, map_name="warehouse-32x32", **extra),
                "random-32x32": dict(base, size=32, density=0.3, **extra)}
        t0 = time.perf_counter()
        card = evaluate(envs, algo=algo, seeds=[0, 1], device=device)
        card_s = time.perf_counter() - t0
        cpu = evaluate(envs, algo=algo, seeds=[0, 1], device="cpu")
        if card != cpu:
            raise AssertionError(f"toolbox {algo} on {device} {card} differs from cpu {cpu}")
        out[algo] = {"card_s": card_s, **card}
    print("rim_toolbox (card == cpu): " + json.dumps(out), flush=True)
    return out


# -- the multi-device learner -------------------------------------------------

# mesh_gloo / mesh_nccl: ranks on one card over gloo (NCCL refuses two ranks
# on one GPU), and one rank per card over NCCL where there are several.
MESH_WORKERS = 4
MESH_TIMEOUT_S = 600
MESH_WORKER = os.path.abspath(__file__)  # the script each rank runs
MESH_FLAVOURS = ("obs", "fused_windows", "fused_pre", "recurrent")
# A meshed config-D step against the one-process step from the same state
# (bf16, products of other shapes and other sums): its stats within
# MESH_D_STATS_TOL (relative, absolute under 1), and at least
# MESH_D_ACTIONS_AGREE of its rollout actions equal. An H100 read 2.4e-5
# (data 4) and 8.8e-6 (2 x 2), and every action equal; a rank that
# normalised advantages or averaged losses over its own rows, or gradients
# scaled by the model size, move the stats by far more.
MESH_D_STATS_TOL = 2e-4
MESH_D_ACTIONS_AGREE = 0.999


def _mesh_cases(world):
    """The (data, model) meshes that ``world`` ranks run."""
    return [(4, 1), (2, 2)] if world == 4 else [(world, 1)]


def _whole_run(ts, mesh):
    """A train state's tensors, gathered over ``mesh`` (None: as they are)."""
    from pogema_torch.models import gather_params
    from pogema_torch.parallel import gather_batch

    if mesh is None:
        return ts.env_state, ts.key, ts.params, ts.opt_state["mu"]
    return (gather_batch(ts.env_state, mesh), ts.key, gather_params(ts.params, mesh),
            gather_params(ts.opt_state["mu"], mesh))


def _small_two_steps(flavour, device, seed, mesh):
    """Two train steps of ``flavour`` at the train_agree size from
    ``init_*(key seed + 1)``, over ``mesh`` or (None) in one process.
    Returns (stats of both steps, gathered state, first-minibatch
    gradients of the first step, Adam steps taken, learning rate,
    (K1, K1b) launched by the two steps, each count set to 0 just before
    a step and read just after it)."""
    from pogema_torch.models import gather_params

    core, model, cfg, init, make = _small_train_setup(flavour, device, seed)
    ts, tx = init(core, model, None, cfg, core.make_key(seed + 1), mesh=mesh)
    grads = []

    def hook(epoch, i, loss, g):
        if not grads:
            grads.append(g if mesh is None else gather_params(g, mesh))

    step = make(core, model, cfg, tx, grad_hook=hook, mesh=mesh)
    k1, k1b = _kernels()
    stats, launches = [], [0, 0]
    for _ in range(2):
        k1.launches = k1b.launches = 0
        ts, st = step(ts)
        launches[0] += k1.launches
        launches[1] += k1b.launches
        stats.append({k: float(v) for k, v in st.items()})
    return (stats, _whole_run(ts, mesh), grads[0], 2 * cfg.epochs * cfg.minibatches, cfg.lr,
            tuple(launches))


def _mesh_agree(flavour, device, mesh, label):
    """Two train steps of ``flavour`` (small, f32, seed 0) over ``mesh``
    against ``mesh=None`` in this process: integer state and key equal,
    stats, first-minibatch gradients, Adam's first moment and parameters
    within TRAIN_*_TOL. Returns (report line, (K1, K1b) launched by the
    meshed steps, by the one-process steps)."""
    import torch

    st_m, (env_m, key_m, p_m, mu_m), g_m, adam_steps, lr, launches_m = _small_two_steps(
        flavour, device, 0, mesh)
    st_r, (env_r, key_r, p_r, mu_r), g_r, _, _, launches_r = _small_two_steps(
        flavour, device, 0, None)
    if not (_states_equal(env_m, env_r) and torch.equal(key_m, key_r)):
        raise AssertionError(f"{label} {flavour}: integer state or key differs from one process")
    worst_stat = max(abs(a[k] - b[k]) / max(1.0, abs(b[k]))
                     for a, b in zip(st_m, st_r) for k in b)
    if not all(math.isfinite(v) for s in st_m for v in s.values()):
        raise AssertionError(f"{label} {flavour}: non-finite stats {st_m}")
    scale = max(float(v.abs().max()) for v in g_r.values())
    worst_grad = max(float((g_m[k] - g_r[k]).abs().max()) for k in g_r) / scale
    worst_mu = max(float((mu_m[k] - mu_r[k]).abs().max()) for k in mu_r) / scale
    diffs = torch.cat([(p_m[k] - p_r[k]).abs().flatten() for k in p_r])
    share = float((diffs <= TRAIN_PARAM_TOL).float().mean())
    line = (f"{label} {flavour}: integer state and key equal to one process; "
            f"stats {worst_stat:.2e}, first-minibatch gradients {worst_grad:.2e}, Adam mu "
            f"{worst_mu:.2e}, parameters max {float(diffs.max()):.2e}, {share:.4f} within "
            f"{TRAIN_PARAM_TOL}; (K1, K1b) launched {launches_m}, one process {launches_r}")
    if (worst_stat > TRAIN_STATS_TOL or worst_grad > TRAIN_GRAD_TOL
            or worst_mu > TRAIN_GRAD_TOL or share < 0.99
            or float(diffs.max()) > 2 * lr * adam_steps):
        raise AssertionError(f"beyond the tolerance: {line}")
    return line, launches_m, launches_r


def phase_mesh_one(device):
    """A mesh of one NCCL rank on the card (a world of one): two train
    steps of each flavour at the train_agree size, with ``mesh`` against
    ``mesh=None``; each flavour's meshed steps launch K1 and K1b as often
    as its one-process steps ('pre' launches neither). Returns ((K1, K1b) launches of the meshed
    steps, report)."""
    import torch
    import torch.distributed as dist

    from pogema_torch.parallel import make_mesh

    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions in f32, as the one-process run
    mesh = make_mesh(device=device)
    report, launches = [], [0, 0]
    try:
        if dist.get_backend() != "nccl" or mesh.shape != (1, 1):
            raise AssertionError(f"mesh_one: backend {dist.get_backend()}, mesh {mesh.shape}")
        for flavour in MESH_FLAVOURS:
            line, launches_m, launches_r = _mesh_agree(flavour, device, mesh, "mesh_one 1x1")
            report.append(line)
            if launches_m != launches_r:
                raise AssertionError(f"mesh_one {flavour}: (K1, K1b) launched {launches_m} "
                                     f"meshed, {launches_r} in one process")
            launches[0] += launches_m[0]
            launches[1] += launches_m[1]
        if not all(launches):  # K1: the obs flavour; K1b: 'windows' and recurrent
            raise AssertionError(f"mesh_one: (K1, K1b) launched {tuple(launches)}")
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
        dist.destroy_process_group()
        print("mesh_one (world of one NCCL rank, f32, seed 0, two train steps, meshed vs "
              f"mesh=None; tolerances: stats {TRAIN_STATS_TOL}, gradients {TRAIN_GRAD_TOL}, "
              f"parameters 99% within {TRAIN_PARAM_TOL}):\n  " + "\n  ".join(report), flush=True)
    return tuple(launches), report


def _env_hashes(state):
    """One int64 per env: a position-weighted sum of its grid, agents and
    targets (equal rows give equal hashes)."""
    import torch

    b = state.agents_xy.shape[0]
    out = torch.zeros(b, dtype=torch.int64, device=state.agents_xy.device)
    for t in (state.obstacles, state.agents_xy, state.targets_xy):
        flat = t.reshape(b, -1).long()
        w = torch.arange(1, flat.shape[1] + 1, device=flat.device)
        out = out * 1000003 + (flat * w).sum(dim=1)
    return out


def _config_d_setup(device, mesh=None):
    """(core, model, config, train state, optimizer) of the config-D
    recurrent learner from the shipped rec128_ft weights (bf16), key 1."""
    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch import parallel as tp
    from pogema_torch.interop import load_policy

    core = PogemaCore(GridConfig(seed=0, **CONFIG_D), num_envs=NUM_ENVS_D,
                      auto_reset_mode="regen", device=device)
    model = load_policy(WEIGHTS, device=device)
    cfg = tp.PPOConfig(**TRAIN_D_PPO)
    ts, tx = tp.init_recurrent_train_state(core, model, None, cfg, core.make_key(1), mesh=mesh)
    return core, model, cfg, ts, tx


def _config_d_step(device, mesh=None, lo=0):
    """The rollout a config-D train step makes (its actions), then the
    step itself, over ``mesh`` or in one process: stats, seconds by part,
    (K1, K1b) launches and bytes all-reduced / all-gathered in the step,
    the minibatches in which this rank held rows."""
    import torch

    from pogema_torch import parallel as tp
    from pogema_torch.parallel import mesh as pm
    from pogema_torch.parallel.rollout import make_recurrent_rollout_fn

    core, model, cfg, ts, tx = _config_d_setup(device, mesh)
    init_hashes = _env_hashes(ts.env_state)
    traj = make_recurrent_rollout_fn(core, model.step_from_state, cfg.rollout_steps,
                                     env_offset=lo)(ts.env_state, ts.initial_env_state, ts.h,
                                                    ts.key)[3]
    actions = traj.actions.to(torch.int8)
    del traj
    k1, k1b = _kernels()
    held = []
    start, hook, seconds = _sync_clock()
    step = tp.make_recurrent_train_step(core, model, cfg, tx,
                                        grad_hook=lambda e, i, loss, g: held.append(
                                            float(loss) != 0.0),
                                        phase_hook=hook, mesh=mesh)
    k1.launches = k1b.launches = 0
    pm.all_reduce_sum.bytes = pm.all_gather_cat.bytes = 0
    start()
    ts, stats = step(ts)
    torch.cuda.synchronize()
    out = {"stats": {k: float(v) for k, v in stats.items()}, "seconds": dict(seconds),
           "seconds_total": sum(seconds.values()), "k1": k1.launches, "k1b": k1b.launches,
           "all_reduce_bytes": pm.all_reduce_sum.bytes,
           "all_gather_bytes": pm.all_gather_cat.bytes, "minibatches_held": sum(held),
           "minibatches": len(held), "rollout_steps": cfg.rollout_steps}
    check_state_invariants(ts.env_state)
    return out, init_hashes, actions


def fixed_units(workload, seed, units) -> int:
    """``--fixed-units WORKLOAD SEED UNITS``: the benchmark cell's set-up on
    ``SEED``, then its first ``UNITS`` units, as a timed window would start.
    Prints one JSON line: the collision fixpoint's passes over those units
    (each unit's and their sum), the env steps they made, the generator's
    placement tries (``generate_env.tries``) over them, and sha256
    digests of what they left (``C.random``: the env state; ``D.serve``:
    each kept episode's final rows and metrics, and apart from them its
    logits). ``fixpoint_passes_per_step`` averages over whatever units a
    timed window holds, so a faster checkout reads it over more and other
    units; these counts and digests compare two checkouts over the same
    ones (the passes read 0 where K2 resolves the collisions; the tries
    are equal wherever the resets are). Run it
    from the root of each checkout (copy this file there)."""
    import hashlib

    import torch

    from pogema_torch.core import generator
    from portbench.harness import Cell, Context, load_manifest, load_module

    def digest(tensors):
        h = hashlib.sha256()
        for name in sorted(tensors):
            h.update(name.encode())
            h.update(tensors[name].detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()

    cell = Cell(load_manifest(), workload)
    ctx = Context(cell, seed, "cuda", False)
    drv = load_module("drivers", cell.traffic["driver"]).Driver(ctx)
    drv.setup()
    ctx.sync()
    per_unit, tries = [], generator.generate_env.tries
    for _ in range(units):
        before = drv.counters().get("fixpoint_passes", 0)
        drv.unit()
        per_unit.append(drv.counters().get("fixpoint_passes", 0) - before)
    out = {"workload": workload, "seed": seed, "units": units, "passes": sum(per_unit),
           "passes_per_unit": per_unit, "steps": units * drv.work["steps"],
           "passes_per_step": sum(per_unit) / (units * drv.work["steps"]),
           "placement_tries": generator.generate_env.tries - tries}
    if workload.startswith("C."):
        out["state_digest"] = digest(drv.state.tensors())
    else:
        out["state_digest"] = digest({f"{i}.{k}": v for i, ep in enumerate(drv.episodes)
                                      for part in ep[2:] for k, v in part.items()})
        out["logits_digest"] = digest({str(i): ep[1] for i, ep in enumerate(drv.episodes)})
    print(json.dumps(out), flush=True)
    return 0


def mesh_worker(spec_path) -> int:
    """One rank of mesh_gloo / mesh_nccl (started by ``_mesh_spawn`` with
    torchrun's environment): for each mesh of its world, the small
    train-step agreement of every flavour and one config-D train step;
    with four ranks the dry run. Writes ``rank<r>.json`` beside the
    spec."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from pogema_torch.parallel import initialize_distributed, make_mesh
    from pogema_torch.parallel.dryrun import dryrun_multichip
    from pogema_torch.parallel.mesh import data_rows

    with open(spec_path) as f:
        spec = json.load(f)
    device = spec["device"]
    initialize_distributed(backend=spec["backend"], device=device,
                           timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    rank, world = dist.get_rank(), dist.get_world_size()
    torch.backends.cudnn.allow_tf32 = False
    ref = np.load(spec["reference"])
    out = {"rank": rank, "world": world, "backend": dist.get_backend(), "cases": {}}
    for case in _mesh_cases(world):
        mesh = make_mesh(*case, device=device)
        label = f"mesh_{spec['backend']} {case[0]}x{case[1]}"
        small = [_mesh_agree(flavour, device, mesh, label)[0] for flavour in MESH_FLAVOURS]
        lo, hi = data_rows(mesh, NUM_ENVS_D)
        rec, hashes, actions = _config_d_step(device, mesh, lo)
        rec["init_rows_equal"] = bool(np.array_equal(hashes.cpu().numpy(),
                                                     ref["init_hashes"][lo:hi]))
        rec["actions_agree"] = int((actions.cpu().numpy() == ref["actions"][:, lo:hi]).sum())
        rec["actions"] = int(actions.numel())
        rec["envs"] = [lo, hi]
        rec["small"] = small
        out["cases"][f"{case[0]}x{case[1]}"] = rec
    if world == 4:
        fused, recurrent = dryrun_multichip(4, device)
        out["dryrun"] = {"fused_loss": fused["loss"], "recurrent_loss": recurrent["loss"]}
    with open(os.path.join(os.path.dirname(spec_path), f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_spawn(backend, world, work_dir, reference, device):
    """Run ``world`` ranks of ``mesh_worker`` (one card for all over gloo,
    one card each over NCCL) and return their results by rank. A rank
    that fails stops the others at once; every process is waited for."""
    os.makedirs(work_dir, exist_ok=True)
    spec_path = os.path.join(work_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"backend": backend, "reference": reference, "device": device}, f)
    port = _free_port()
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), LOCAL_RANK=str(rank if backend == "nccl" else 0),
                   OMP_NUM_THREADS="2")
        log = open(os.path.join(work_dir, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, MESH_WORKER, "--mesh-worker", spec_path],
                                      env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT))
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.perf_counter() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = []
        for rank in range(world):
            with open(os.path.join(work_dir, f"rank{rank}.log")) as f:
                tails.append(f"rank {rank} (exit {codes[rank]}):\n" + f.read()[-3000:])
        raise AssertionError(f"{backend} ranks failed:\n" + "\n".join(tails))
    results = []
    for rank in range(world):
        with open(os.path.join(work_dir, f"rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


_MESH_REF = {}


def _mesh_reference(device):
    """The one-process config-D step that the meshed ones are held to,
    computed once: its record, and an .npz (under build/) of the initial
    state's env hashes and the rollout's actions."""
    import numpy as np

    if not _MESH_REF:
        rec, hashes, actions = _config_d_step(device)
        path = os.path.join(ROOT, "build", "mesh", "reference.npz")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, init_hashes=hashes.cpu().numpy(), actions=actions.cpu().numpy())
        _MESH_REF.update(rec=rec, path=path)
        print("mesh reference (one process, config D, rec128_ft bf16): "
              + json.dumps(rec), flush=True)
    return _MESH_REF["rec"], _MESH_REF["path"]


def _mesh_phase(device, backend, world):
    """The meshes of ``world`` ranks over ``backend`` against the one-process
    step: prints each case and returns ({path: (K1, K1b) summed over the
    ranks}, summary)."""
    ref, path = _mesh_reference(device)
    t0 = time.perf_counter()
    results = _mesh_spawn(backend, world, os.path.join(ROOT, "build", "mesh", backend), path,
                          device)
    wall = time.perf_counter() - t0
    launches, summary = {}, {"ranks": world, "backend": backend, "wall_s": wall, "cases": {}}
    t, m = TRAIN_D_PPO["rollout_steps"], TRAIN_D_PPO["minibatches"]
    for case in results[0]["cases"]:
        recs = [r["cases"][case] for r in results]
        for line in recs[0]["small"]:
            print("  " + line, flush=True)
        stats = recs[0]["stats"]
        if any(r["stats"] != stats for r in recs):
            raise AssertionError(f"{backend} {case}: the ranks' stats differ")
        if not all(math.isfinite(v) for v in stats.values()):
            raise AssertionError(f"{backend} {case}: non-finite stats {stats}")
        if not 0.0 < stats["entropy"] < math.log(5) or stats["episodes_finished"] != 0.0:
            raise AssertionError(f"{backend} {case}: entropy {stats['entropy']}, "
                                 f"{stats['episodes_finished']} episodes finished")
        if not all(r["init_rows_equal"] for r in recs):
            raise AssertionError(f"{backend} {case}: a rank's initial state is not its rows of "
                                 "the one-process state")
        for r in recs:  # K1b: the rollout, the bootstrap, each replayed step of a held share
            want = t + 1 + t * r["minibatches_held"]
            if (r["k1"], r["k1b"]) != (0, want) or r["minibatches"] != 2 * m:
                raise AssertionError(f"{backend} {case}: (K1, K1b) launched ({r['k1']}, "
                                     f"{r['k1b']}), expected (0, {want})")
        agree = sum(r["actions_agree"] for r in recs) / sum(r["actions"] for r in recs)
        diff = max(abs(stats[k] - ref["stats"][k]) / max(1.0, abs(ref["stats"][k]))
                   for k in stats)
        if diff > MESH_D_STATS_TOL or agree < MESH_D_ACTIONS_AGREE:
            raise AssertionError(f"{backend} {case}: stats {diff:.3e} from one process (limit "
                                 f"{MESH_D_STATS_TOL}), {agree:.6f} of the rollout actions "
                                 f"equal (floor {MESH_D_ACTIONS_AGREE})")
        launches[f"mesh_{backend}_{case}"] = (sum(r["k1"] for r in recs),
                                              sum(r["k1b"] for r in recs))
        rec = {"stats": stats, "stats_max_rel_diff_vs_one_process": diff,
               "actions_agree_share": agree,
               "k1b_by_rank": [r["k1b"] for r in recs],
               "k1b_sum": sum(r["k1b"] for r in recs),
               "seconds_by_rank": [r["seconds"] for r in recs],
               "seconds_total_max": max(r["seconds_total"] for r in recs),
               "one_process_seconds": ref["seconds"],
               "all_reduce_bytes_by_rank": [r["all_reduce_bytes"] for r in recs],
               "all_gather_bytes_by_rank": [r["all_gather_bytes"] for r in recs]}
        summary["cases"][case] = rec
        print(f"mesh_{backend} {case}: " + json.dumps(rec), flush=True)
    if "dryrun" in results[0]:
        losses = {json.dumps(r["dryrun"], sort_keys=True) for r in results}
        if len(losses) != 1:
            raise AssertionError(f"{backend} dryrun: the ranks' losses differ: {losses}")
        summary["dryrun"] = results[0]["dryrun"]
        print(f"mesh_{backend} dryrun_multichip(4): {results[0]['dryrun']}", flush=True)
    print(f"mesh_{backend}: {world} ranks in {wall:.1f} s (start, build load, cases)",
          flush=True)
    return launches, summary


def phase_mesh_gloo(device):
    """Four ranks on the one card over gloo with CUDA tensors: data = 4 and
    data 2 x model 2, each the small agreement of every flavour and one
    config-D train step (1024 envs x 128 agents, rec128_ft bf16, T = 64,
    2 epochs x 8 minibatches) against the one-process step from the same
    state; then the dry run at 4 ranks."""
    return _mesh_phase(device, "gloo", MESH_WORKERS)


def phase_mesh_nccl(device):
    """The cases of mesh_gloo over NCCL on min(4, cards) cards, one rank
    each; not run on one card."""
    import torch

    count = torch.cuda.device_count()
    if count < 2:
        print("mesh_nccl: not run (1 card)", flush=True)
        return {}, None
    return _mesh_phase(device, "nccl", min(MESH_WORKERS, count))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import pogema_torch  # noqa: F401
        from pogema_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-worker":
        return mesh_worker(sys.argv[2])
    if len(sys.argv) == 5 and sys.argv[1] == "--fixed-units":
        return fixed_units(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    if not card:
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr}", file=sys.stderr)
        return 1
    print(card, flush=True)
    device = "cuda"
    failed = []

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # report every phase, then fail as a whole
            traceback.print_exc()
            failed.append(name)
            out = None
        print(f"phase {name}: {'FAILED' if name in failed else 'ok'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return out

    def do_build():
        reports = build.build_all(build.SOURCES)
        for name, log in reports.items():
            for line in log.splitlines():
                if any(k in line for k in ("Compiling entry", "registers", "smem", "spill")):
                    print(f"ptxas {name}: {line.strip()}")

    phase("build", do_build)
    if failed:
        return 1
    p = CONFIG_C["size"] + 2 * CONFIG_C["obs_radius"]
    record = phase("k1", phase_k1, device, NUM_ENVS_C, p, CONFIG_C["num_agents"],
                   CONFIG_C["obs_radius"])
    record_b = phase("k1b", phase_k1b, device, NUM_ENVS_C, p, CONFIG_C["num_agents"],
                     CONFIG_C["obs_radius"])
    wide_out = phase("k1b_wide", phase_k1b_wide, device)
    record_k7 = phase("k7", phase_k7, device)
    record_k2 = phase("k2", phase_k2, device)
    record_k8 = phase("k8", phase_k8, device)
    record_k4 = phase("k4", phase_k4, device)
    record_k9 = phase("k9", phase_k9, device)
    phase("devices_agree", phase_devices_agree, device)
    main_out = phase("main_path", phase_main, device)
    pomapf_out = phase("pomapf", phase_pomapf, device)
    phase("policy", phase_policy, device)
    serve_out = phase("serve", phase_serve, device)
    serve_e_out = phase("serve_e", phase_serve_e, device)
    phase("serve_agree", phase_serve_agree, device)
    phase("planner", phase_planner, device)
    phase("rim_agree", phase_rim_agree, device)
    rim_env_out = phase("rim_env", phase_rim_env, device)
    rim_vector_out = phase("rim_vector", phase_rim_vector, device)
    phase("rim_toolbox", phase_rim_toolbox, device)
    phase("train_agree", phase_train_agree, device)
    train_out = phase("train", phase_train, device)
    train_ff_out = phase("train_ff", phase_train_ff, device)
    mesh_one_out = phase("mesh_one", phase_mesh_one, device)
    mesh_gloo_out = phase("mesh_gloo", phase_mesh_gloo, device)
    mesh_nccl_out = phase("mesh_nccl", phase_mesh_nccl, device)

    shapes = phase("k1_shapes", phase_k1_shapes, device)
    if failed or None in (record, record_b, record_k7, record_k2, record_k8, record_k4, record_k9,
                          wide_out, main_out, pomapf_out, serve_out,
                          serve_e_out, train_out, train_ff_out, shapes, rim_env_out,
                          rim_vector_out, mesh_one_out, mesh_gloo_out, mesh_nccl_out):
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    # Each kernel's launches on the paths driven above, its counter set to
    # 0 just before each. "launches" is the count on the full-width path
    # that runs the kernel: config C with packed observations for K1b, the
    # same config with POMAPF observations for K1 (the packed paths do not
    # launch it).
    for i, rec in enumerate((record, record_b)):
        rec["launches_by_path"] = {"main_path": main_out[0][i], "pomapf": pomapf_out[0][i],
                                   "serve": serve_out[0][i], "train": train_out[0][i],
                                   "train_ff": train_ff_out[0][0][i],
                                   "train_ff_windows": train_ff_out[0][1][i],
                                   "rim_env": rim_env_out[0][i],
                                   "rim_vector_packed": rim_vector_out[0]["packed"][i],
                                   "rim_vector_grid": rim_vector_out[0]["grid"][i],
                                   "rim_vector_pomapf": rim_vector_out[0]["pomapf"][i],
                                   **{f"k1b_wide_{k}": v[i] for k, v in wide_out[0].items()},
                                   **{k: v[i] for k, v in serve_e_out[0].items()},
                                   "mesh_one": mesh_one_out[0][i],
                                   **{k: v[i] for k, v in mesh_gloo_out[0].items()},
                                   **{k: v[i] for k, v in mesh_nccl_out[0].items()}}
        rec["by_centres_per_block"] = shapes[i].pop("by_centres_per_block")
        rec["other_shapes"] = shapes[i]
    record_b["other_shapes"]["serve_config_e"] = wide_out[1]
    record_b["by_centres_per_block"]["serve_config_e"] = wide_out[2]
    record["launches"] = pomapf_out[0][0]
    record_b["launches"] = main_out[0][1]
    if not all(record_b["launches_by_path"][k] > 0
               for k in ("main_path", "serve", "train", "train_ff_windows", "serve_e",
                         "k1b_wide_core_packed", "k1b_wide_train_recurrent",
                         "k1b_wide_train_fused_windows", "k1b_wide_vector_packed", "mesh_one",
                         *mesh_gloo_out[0], *mesh_nccl_out[0])):
        print("chip_smoke: a packed path did not launch K1b", file=sys.stderr)
        return 1
    if record["launches"] <= 0:
        print("chip_smoke: the POMAPF path did not launch K1", file=sys.stderr)
        return 1
    if not (all(record["launches_by_path"][k] > 0
                for k in ("rim_env", "rim_vector_grid", "rim_vector_pomapf", "ladder_PPO",
                          "ladder_random"))
            and record_b["launches_by_path"]["rim_vector_packed"] > 0):
        print("chip_smoke: a rim path did not launch its kernel", file=sys.stderr)
        return 1
    # The card's name and power limit once more, beside the results: a
    # reader of the output's tail finds them there.
    print(card, flush=True)
    record_k7["launches_by_path"] = {"main_path_per_step": main_out[1]["k7_launches_per_step"],
                                     "serve_per_episode": serve_out[1]["k7_launches_per_episode"]}
    record_k2["launches_by_path"] = {"main_path_per_step": main_out[1]["k2_launches_per_step"],
                                     "serve_per_episode": serve_out[1]["k2_launches_per_episode"]}
    record_k8["launches_by_path"] = {"serve_per_episode": serve_out[1]["k8_launches_per_episode"],
                                     "serve_e_per_episode":
                                         serve_e_out[1]["k8_launches_per_episode"],
                                     "train_per_step": train_out[1]["k8_launches_per_step"]}
    record_k4["launches_by_path"] = {"serve_per_episode": serve_out[1]["k4_launches_per_episode"],
                                     "serve_e_per_episode":
                                         serve_e_out[1]["k4_launches_per_episode"]}
    record_k9["launches_by_path"].update(
        serve_per_episode=serve_out[1]["k9_launches_per_episode"],
        serve_e_per_episode=serve_e_out[1]["k9_launches_per_episode"])
    print(json.dumps({"kernels": [record, record_b, record_k7, record_k2, record_k8,
                                  record_k4, record_k9]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
