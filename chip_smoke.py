"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure is reported; any failure exits 1 and prints no
result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``pogema_torch/csrc`` (one nvcc each,
     all at once) into ``build/kernels``;
  3. hold K1, the packed-window kernel, bit for bit against its plain
     PyTorch version at the main path's shapes and at edge cases
     (agents on the padding border, w in {3, 5, 11, 13}), and time it
     beside its memory bound, its plain version and one PyTorch gather;
  4. every collision system x on_target, cached and regen auto-reset: a
     small reset and 64 ``step_autoreset`` steps on the card must equal
     the same run on the CPU bit for bit (the CPU run is held against
     the JAX package by the tests);
  5. the main path: config C (4096 envs x 64 agents, 64x64 mazes, obs
     radius 5, priority collisions, 'finish', cached auto-reset, packed
     observations) reset on the card, then 3 timed trials of 256
     ``step_autoreset`` steps with actions from a CUDA generator, with
     its invariants checked and K1's launches counted; a per-part
     breakdown of one step and a profiler kernel table follow;
  6. policy: the shipped ``.ckpt_rec128_ft`` weights (committed as
     ``pogema_torch/weights/rec128_ft.npz``) in bf16 on 64 config-D
     states: K1 bit-equal at M = N = 128, logits and values within
     POLICY_TOL of the same module on the CPU, greedy actions equal where
     the CPU's top-2 margin exceeds twice that;
  7. serve, the evaluation path at full width: ``make_policy_evaluator``
     on config D (1024 envs x 128 agents, LifeLong 64x64, r=5) with those
     weights, 3 timed greedy episodes, K1 launched exactly once per step,
     invariants and metrics checked;
  8. serve_agree: both evaluators (policy, f32 model; planner) on the
     card and on the CPU with the same keys must agree bit for bit (the
     policy may first differ only at a near-tie, which is printed);
  9. planner: ``evaluate_planner`` at config-C shapes with 1024 envs:
     the fields' time and sweeps, fields against the CPU, the episode;
 10. train_agree: two PPO train steps of each flavour (observation-based,
     fused 'windows', fused 'pre', recurrent) at a small f32 size on the
     card and on the CPU from the same numpy state: integer state and key
     bit-equal (or first differing at a near-tie of a sampled action,
     which is printed), stats, first-minibatch gradients and parameters
     within the tolerances stated at TRAIN_*_TOL; K1 against its plain
     version at the update's shapes, from non-contiguous callers;
 11. train, the training path at full width: three recurrent PPO train
     steps on config D (1024 envs x 128 agents, regen auto-reset) from the
     shipped weights in bf16: stats, the split of each step's seconds,
     peak memory, K1 launched exactly 64 + 1 + 2*8*64 times per step;
 12. train_ff: three fused train steps at 1024 envs x 8 agents, 16x16
     (embed/hidden 256, 'auto' picks 'pre': no K1, the grid convolutions
     counted), then one step with obstacle_path='windows';
then one JSON line listing the kernels and, last, the ok line.

Needs one CUDA device; exits non-zero without one, and outside a
checkout of the repository.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet

CONFIG_C = dict(size=64, num_agents=64, obs_radius=5, max_episode_steps=128,
                collision_system="priority", on_target="finish")
NUM_ENVS_C = 4096
STEPS_PER_TRIAL = 256
TRIALS = 3

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
# The planner at config-C shapes with a quarter of config C's envs.
PLANNER_ENVS = 1024

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


def phase_k1(device, b, p, n, r):
    """Phase 3. Returns the kernel record (without ``launches``)."""
    import torch

    from pogema_torch.ops import cuda_windows
    from pogema_torch.ops.windows import extract_windows_packed_ref, packed_lanes

    kernel = cuda_windows.extract_windows_packed
    saved = kernel.launches
    # The main path's shapes: reset (M = N) and cached step (M = 2N).
    for m in (n, 2 * n):
        grid, xy = random_windows_inputs(b, p, m, r, device, seed=m)
        got, ref = kernel(grid, xy, 2 * r + 1), extract_windows_packed_ref(grid, xy, 2 * r + 1)
        if not torch.equal(got, ref):
            raise AssertionError(f"K1 differs from its plain version at B={b} M={m}: "
                                 f"max |diff| {(got - ref).abs().max().item()}")
    for w in (3, 5, 11, 13):
        grid, xy = random_windows_inputs(64, 40, 37, w // 2, device, seed=w, border=True)
        got, ref = kernel(grid, xy, w), extract_windows_packed_ref(grid, xy, w)
        if got.shape != (64, 37, packed_lanes(w)) or not torch.equal(got, ref):
            raise AssertionError(f"K1 differs from its plain version at w={w} (border cases)")
    print(f"K1 bit-equal to its plain version: B={b} P={p} M in ({n}, {2 * n}); "
          f"w in (3, 5, 11, 13) with border centres", flush=True)

    t = time_k1(device, b, p, 2 * n, r)
    kernel.launches = saved
    return {"name": "packed_windows", "route": "cuda", "source": "pogema_torch/csrc/windows.cu",
            "replaces": "pogema_tpu/ops/pallas_windows.py:71", **t}


def time_k1(device, b, p, m, r):
    """K1 at one shape beside its byte bound, its plain version and one
    PyTorch gather: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms}. The launches made here are not left in the count."""
    import torch

    from pogema_torch.ops import cuda_windows
    from pogema_torch.ops.windows import extract_windows_packed_ref, packed_lanes

    kernel = cuda_windows.extract_windows_packed
    saved = kernel.launches
    w = 2 * r + 1
    lanes = packed_lanes(w)
    grid, xy = random_windows_inputs(b, p, m, r, device, seed=7)
    out = kernel(grid, xy, w)
    err = (out - extract_windows_packed_ref(grid, xy, w)).abs().max().item()
    ms = cuda_time_ms(lambda: kernel(grid, xy, w))
    plain_ms = cuda_time_ms(lambda: extract_windows_packed_ref(grid, xy, w), iters=5)
    # Library yardstick: one gather from the float grid (plus a zero cell
    # for the padding lanes) by a precomputed index; the index is built
    # outside the timed call.
    gflat = torch.cat([grid.reshape(b, p * p).float(), torch.zeros(b, 1, device=device)], 1)
    k = torch.arange(lanes, device=device)
    rr = (xy[..., 0:1].long() - r + k // w).clamp(0, p - 1)
    cc = (xy[..., 1:2].long() - r + k % w).clamp(0, p - 1)
    idx = torch.where(k < w * w, rr * p + cc, p * p).reshape(b, m * lanes)
    lib = torch.gather(gflat, 1, idx).reshape(b, m, lanes)
    if not torch.equal(lib, out):
        raise AssertionError("the library gather disagrees with K1")
    library_ms = cuda_time_ms(lambda: torch.gather(gflat, 1, idx))
    nbytes = b * p * p + b * m * 2 * 4 + b * m * lanes * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    kernel.launches = saved
    print(f"K1 at B={b} P={p} M={m} w={w}: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
          f"{nbytes} bytes), plain {plain_ms:.4f} ms, gather {library_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": library_ms}


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
    """The state invariants, and the obstacle block of the observations
    equals the plain windows."""
    import torch

    from pogema_torch.ops.windows import extract_windows_packed_ref

    b, n, _ = state.agents_xy.shape
    cells = check_state_invariants(state)
    ww = cfg.window ** 2
    idx = torch.linspace(0, b - 1, sample, device=cells.device).long()
    ref = extract_windows_packed_ref(state.obstacles[idx], state.agents_xy[idx], cfg.window)
    if not torch.equal(obs[idx, :, :ww], ref[..., :ww]):
        raise AssertionError("obstacle block of the observations differs from the plain windows")
    if obs.shape != (b, n, 3 * ww) or not torch.isfinite(obs).all():
        raise AssertionError(f"observations of shape {tuple(obs.shape)} or not finite")


def phase_main(device):
    """Phase 5. Returns (K1 launches, summary dict)."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core import collisions
    from pogema_torch.ops import cuda_windows

    kernel = cuda_windows.extract_windows_packed
    core = PogemaCore(GridConfig(seed=0, **CONFIG_C), num_envs=NUM_ENVS_C, maze=True,
                      device=device, obs_layout="packed")
    gen = torch.Generator(device=device).manual_seed(0)
    b, n = NUM_ENVS_C, CONFIG_C["num_agents"]

    kernel.launches = 0
    collisions.fixpoint.passes = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs = core.reset(0)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    if kernel.launches != 1:
        raise AssertionError(f"reset launched K1 {kernel.launches} times, expected 1")
    check_invariants(state, obs, core.cfg)
    init = state
    best, done_envs, total_steps = float("inf"), 0, 0
    for trial in range(TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS_PER_TRIAL):
            actions = torch.randint(0, 5, (b, n), device=device, generator=gen, dtype=torch.int32)
            state, obs, res, done, _ = core.step_autoreset(state, init, actions)
            done_envs += done
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        total_steps += STEPS_PER_TRIAL
        check_invariants(state, obs, core.cfg)
    launches = kernel.launches
    passes = collisions.fixpoint.passes
    if launches != 1 + total_steps:
        raise AssertionError(f"K1 launched {launches} times over reset + {total_steps} steps, "
                             f"expected {1 + total_steps}")
    finished = int(done_envs.sum())
    if finished == 0:
        raise AssertionError("no env finished an episode: auto-reset never fired")
    sps = b * STEPS_PER_TRIAL / best
    summary = {"reset_s": reset_s, "env_steps_per_s": sps, "ms_per_step": best / STEPS_PER_TRIAL * 1e3,
               "steps": total_steps, "episodes_finished": finished,
               "fixpoint_passes_per_step": passes / total_steps}
    print("main path (config C, cached, packed obs): " + json.dumps(summary), flush=True)
    return launches, summary


def phase_breakdown(device, steps=32):
    """Host-clock time of each part of a config-C cached step, each part
    run ``steps`` times between two synchronisations (so the host syncs
    inside a part, such as the collision fixpoint's, are in its time)."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core import collisions, metrics, obs, step as step_mod

    core = PogemaCore(GridConfig(seed=0, **CONFIG_C), num_envs=NUM_ENVS_C, maze=True,
                      device=device, obs_layout="packed")
    cfg, n = core.cfg, CONFIG_C["num_agents"]
    init, _ = core.reset(1, with_obs=False)
    gen = torch.Generator(device=device).manual_seed(1)
    acts = torch.randint(0, 5, (NUM_ENVS_C, n), device=device, generator=gen, dtype=torch.int32)
    state = init
    for _ in range(4):
        state, *_ = core.step_autoreset(state, init, acts)
    new_state, _ = step_mod.step(cfg, state, acts, with_obs=False)
    done = step_mod.episode_done(cfg, new_state)
    reset_state = core._cached_reset(new_state, init, done)
    both = torch.cat([new_state.agents_xy, reset_state.agents_xy], dim=1)
    win = obs.obstacle_windows(cfg, new_state.obstacles, both)
    pre, post = win.split(n, dim=1)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    parts = {
        "full_step": lambda: core.step_autoreset(state, init, acts),
        "resolve_moves": lambda: collisions.resolve_moves(cfg, state.obstacles, state.agents_xy,
                                                          state.active, acts),
        "step_state": lambda: step_mod.step(cfg, state, acts, with_obs=False),
        "done_and_metrics": lambda: (step_mod.episode_done(cfg, new_state),
                                     metrics.episode_metrics(cfg, new_state)),
        "cached_select": lambda: core._cached_reset(new_state, init, done),
        "k1_windows": lambda: obs.obstacle_windows(cfg, new_state.obstacles, both),
        "assemble_obs_x2": lambda: (step_mod.observe_state(cfg, new_state, pre),
                                    step_mod.observe_state(cfg, reset_state, post)),
    }
    collisions.fixpoint.passes = 0
    out = {k: timed(fn) for k, fn in parts.items()}
    print("config-C step breakdown, ms per step (host clock): " + json.dumps(out), flush=True)
    return out


def _profile(label, fname, fn, steps):
    """Device time by kernel over ``steps`` calls of ``fn``
    (torch.profiler), written to chiprun_out/<fname>; prints the
    device-busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us()
    dev_us = sum(kernels.values())
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", fname), "w") as f:
        for name, us in sorted(kernels.items(), key=lambda kv: -kv[1]):
            f.write(f"{us / steps:10.1f} us/step  {name}\n")
    print(f"profile over {steps} {label}: wall {wall * 1e3 / steps:.3f} ms/step "
          f"(profiler on), kernels {dev_us / 1e3 / steps:.3f} ms/step, device busy share "
          f"{dev_us / 1e6 / wall:.3f}", flush=True)
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / steps:9.1f} us/step  {name[:90]}", flush=True)
    return dev_us / 1e6 / steps, kernels


def profile_step(device, steps=8):
    """The kernel table of a few config-C steps
    (chiprun_out/profile_config_c.txt)."""
    import torch

    from pogema_torch import GridConfig, PogemaCore

    core = PogemaCore(GridConfig(seed=0, **CONFIG_C), num_envs=NUM_ENVS_C, maze=True,
                      device=device, obs_layout="packed")
    state, _ = core.reset(1, with_obs=False)
    gen = torch.Generator(device=device).manual_seed(1)
    acts = [torch.randint(0, 5, (NUM_ENVS_C, CONFIG_C["num_agents"]), device=device,
                          generator=gen, dtype=torch.int32) for _ in range(steps + 2)]
    for a in acts[:2]:
        state, *_ = core.step_autoreset(state, state, a)
    init, box = state, [state]
    todo = iter(acts[2:])

    def one():
        box[0] = core.step_autoreset(box[0], init, next(todo))[0]

    _profile("config-C steps", "profile_config_c.txt", one, steps)


def profile_serve(device, steps=8):
    """The kernel table of a few config-D serving steps, each the body of
    the evaluator's loop: policy forward, greedy action, env step, done
    test and freeze (chiprun_out/profile_serve_d.txt)."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core import step as step_mod
    from pogema_torch.core.api import select_state
    from pogema_torch.interop import load_policy

    core = PogemaCore(GridConfig(seed=0, **CONFIG_D), num_envs=NUM_ENVS_D, device=device)
    model = load_policy(WEIGHTS, device=device)
    st, _ = core.reset(core.make_key(5), with_obs=False)
    box = [st, model.initial_carry((NUM_ENVS_D, CONFIG_D["num_agents"]))]

    @torch.no_grad()
    def one():
        st, h = box
        done = step_mod.episode_done(core.cfg, st)
        h, logits, _ = model.step_from_state(st.obstacles, st.agents_xy, st.targets_xy,
                                             st.active, h)
        new, _ = step_mod.step(core.cfg, st, logits.argmax(-1).to(torch.int32), with_obs=False)
        box[:] = [select_state(done, st, new), h]

    one()
    _profile("config-D serving steps", "profile_serve_d.txt", one, steps)


def _rel_err(got, want):
    """max |got - want| / max(1, |want|), on the CPU in f32."""
    got, want = got.float().cpu(), want.float().cpu()
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def _top2_margin(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def phase_policy(device, b=64, steps=3):
    """The shipped .ckpt_rec128_ft weights (from the committed .npz) in
    bf16 on 64 config-D states: K1 bit-equal to its plain version at
    M = N = 128, and the card's logits and values against the same module
    on the CPU over ``steps`` chained GRU steps."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core import step as step_mod
    from pogema_torch.interop import load_policy
    from pogema_torch.ops import cuda_windows
    from pogema_torch.ops.windows import extract_windows_packed_ref

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
    card, host = load_policy(WEIGHTS, device=device), load_policy(WEIGHTS, device="cpu")
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
    print(f"policy (rec128_ft, bf16, B={b} N={n}): K1 bit-equal at M=N={n}; card vs cpu "
          f"max |diff|/max(1,|cpu|) per step {errs} (tolerance {POLICY_TOL}); greedy actions "
          f"differ at {flips} of {decided} agents with a cpu top-2 margin > {2 * POLICY_TOL}; "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    if max(errs) > POLICY_TOL or flips:
        raise AssertionError("the card's policy outputs differ from the cpu's beyond the tolerance")


def phase_serve(device):
    """This slice's path at full width: make_policy_evaluator on config D
    (1024 envs x 128 agents, 64x64, r=5, LifeLong) with the shipped
    rec128_ft weights in bf16, 3 timed greedy episodes (each with its
    reset). Then, outside the counted run, host-clock times of the reset,
    the policy forward and its parts, the env step, the done test and
    freeze, and K1 at config-D shapes. Returns (K1 launches, summary);
    ``loop_ms_per_step`` is (best episode - reset) / steps."""
    import torch

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.core import collisions, step as step_mod
    from pogema_torch.core.api import select_state
    from pogema_torch.interop import load_policy
    from pogema_torch.core.obs import packed_observation
    from pogema_torch.models.embed_actor_critic import embed_obs
    from pogema_torch.ops import cuda_windows
    from pogema_torch.ops.windows import packed_lanes
    from pogema_torch.parallel import make_policy_evaluator

    kernel = cuda_windows.extract_windows_packed
    b, n, steps = NUM_ENVS_D, CONFIG_D["num_agents"], CONFIG_D["max_episode_steps"]
    core = PogemaCore(GridConfig(seed=0, **CONFIG_D), num_envs=b, device=device)
    model = load_policy(WEIGHTS, device=device)
    run = make_policy_evaluator(core, model)

    times, throughput = [], []
    kernel.launches = 0
    collisions.fixpoint.passes = 0
    for ep in range(SERVE_EPISODES):
        before = kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = run(core.make_key(ep))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if kernel.launches - before != steps:
            raise AssertionError(f"episode {ep} launched K1 {kernel.launches - before} times, "
                                 f"expected {steps} (one per policy step)")
        check_state_invariants(state)
        thr = metrics["avg_throughput"]
        if thr.shape != (b,) or not torch.isfinite(thr).all() or not (state.step_count == steps).all():
            raise AssertionError("bad metrics or episode length at the end of a serving episode")
        throughput.append(float(thr.mean()))
    launches, passes = kernel.launches, collisions.fixpoint.passes

    def host_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = core.reset(core.make_key(9), with_obs=False)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    h = model.initial_carry((b, n))
    acts = torch.zeros(b, n, dtype=torch.int32, device=device)
    args = (st.obstacles, st.agents_xy, st.targets_xy, st.active)
    obs = packed_observation(model.window, *args)
    bias = model.embed_bias.to(model.dtype)
    e = embed_obs(model.embed_kernel, bias, model.dtype, obs)
    with torch.no_grad():
        policy_ms = host_ms(lambda: model.step_from_state(*args, h))
        parts = {"packed_obs": host_ms(lambda: packed_observation(model.window, *args)),
                 "embed_gemm": host_ms(lambda: embed_obs(model.embed_kernel, bias, model.dtype, obs)),
                 "gru_and_head": host_ms(lambda: model._finish(h, e))}
    step_ms = host_ms(lambda: step_mod.step(core.cfg, st, acts, with_obs=False))
    done_select_ms = host_ms(lambda: select_state(step_mod.episode_done(core.cfg, st), st, st))
    w = core.cfg.window
    k1_ms = cuda_time_ms(lambda: kernel(st.obstacles, st.agents_xy, w))
    p = st.obstacles.shape[-1]
    k1_bound_ms = (b * p * p + b * n * 8 + b * n * packed_lanes(w) * 4) / HBM_BYTES_PER_S * 1e3
    best = min(times)
    summary = {"episode_s": times, "env_steps_per_s": b * steps / best,
               "ms_per_step": best / steps * 1e3, "reset_s": reset_s,
               "loop_ms_per_step": (best - reset_s) / steps * 1e3,
               "policy_ms_per_step": policy_ms, "policy_parts_ms": parts,
               "env_step_ms": step_ms, "done_and_freeze_ms": done_select_ms,
               "avg_throughput": throughput, "k1_launches": launches,
               "k1_launches_per_episode": launches / SERVE_EPISODES,
               "fixpoint_passes_per_step": passes / (SERVE_EPISODES * steps),
               "k1_ms_config_d": k1_ms, "k1_bound_ms_config_d": k1_bound_ms}
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
    """K1 against its plain version at the shapes the updates give it."""
    import torch

    from pogema_torch.ops import cuda_windows
    from pogema_torch.ops.windows import extract_windows_packed_ref

    kernel = cuda_windows.extract_windows_packed
    # The update hands K1 slices of mixed or env-major tensors: the wrapper
    # refuses a view, and the callers' contiguous copies give the plain
    # version's result. Recurrent replay at config D (B = 128, M = 128), the
    # fused 'windows' loss of train_ff (B = 16384, M = 8).
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
    print("K1 bit-equal to its plain version at the update's shapes (B=128 M=128 P=74; "
          "B=16384 M=8 P=26) from contiguous copies of views; a view itself is refused", flush=True)


def phase_train_agree(device):
    """Two train steps of each flavour on the card and on the cpu from
    the same numpy state (f32 model, small size), after K1 at the
    update's shapes."""
    import numpy as np
    import torch

    from pogema_torch.interop import train_state_from_numpy, train_state_to_numpy
    from pogema_torch.ops import cuda_windows

    if device != "cpu":
        check_k1_update_shapes(device)
    kernel = cuda_windows.extract_windows_packed
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions in f32, as on the cpu
    report = []
    try:
        for flavour in ("obs", "fused_windows", "fused_pre", "recurrent"):
            agreed = False
            for seed in (0, 1, 2):
                core_c, model_c, cfg, init, make = _small_train_setup(flavour, "cpu", seed)
                core_d, model_d = _small_train_setup(flavour, device, seed)[:2]
                ts_c, tx = init(core_c, model_c, None, cfg, core_c.make_key(seed + 1))
                arrays = train_state_to_numpy(ts_c)
                ts_d = train_state_from_numpy(arrays, device, torch.float32)
                grads = {"cpu": [], device: []}
                steps = {d: make(c, m, cfg, tx, grad_hook=lambda e, i, loss, g, d=d:
                                 grads[d].append({k: v.detach().cpu() for k, v in g.items()}))
                         for d, c, m in (("cpu", core_c, model_c), (device, core_d, model_d))}
                before = kernel.launches
                starts, stats = [], []
                for _ in range(2):
                    starts.append((ts_c, ts_d))
                    ts_c, st_c = steps["cpu"](ts_c)
                    ts_d, st_d = steps[device](ts_d)
                    stats.append((st_c, st_d))
                used_k1 = kernel.launches - before
                if device != "cpu" and (used_k1 > 0) != (flavour != "fused_pre"):
                    raise AssertionError(f"{flavour}: {used_k1} K1 launches on the card")
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
                              f"{used_k1} K1 launches; stats {worst_stat:.2e}, first-minibatch "
                              f"gradients {worst_grad:.2e}, Adam mu {worst_mu:.2e} (of the largest "
                              f"gradient entry), parameters max {float(diffs.max()):.2e}, "
                              f"{share:.4f} within {TRAIN_PARAM_TOL}")
                if (worst_stat > TRAIN_STATS_TOL or worst_grad > TRAIN_GRAD_TOL
                        or worst_mu > TRAIN_GRAD_TOL or share < 0.99
                        or float(diffs.max()) > 2 * cfg.lr * adam_steps):
                    raise AssertionError(f"{flavour} on {device} differs from cpu beyond the "
                                         f"tolerance: {report[-1]}")
                agreed = True
                break
            if not agreed:
                raise AssertionError(f"{flavour}: no seed gave equal trajectories: {report}")
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
        print("train_agree (card vs cpu, f32, two train steps; tolerances: stats "
              f"{TRAIN_STATS_TOL}, gradients {TRAIN_GRAD_TOL}, parameters 99% within "
              f"{TRAIN_PARAM_TOL}):\n  " + "\n  ".join(report), flush=True)


def _run_train_steps(label, core, model, cfg, init, make, key_seed, steps, expect_k1,
                     expect_finished, device):
    """``steps`` train steps with the per-step prints and checks shared by
    the training phases: finite stats, entropy in (0, ln 5), the expected
    episodes finished and K1 launches, finite gradients, changed and
    finite parameters that the module also holds, the state invariants.
    Returns (K1 launches, list of per-step dicts)."""
    import math

    import torch

    from pogema_torch.models import EmbedActorCritic
    from pogema_torch.ops import cuda_windows

    kernel = cuda_windows.extract_windows_packed
    start, hook, seconds = _sync_clock()
    finite = [torch.ones((), dtype=torch.bool, device=device)]

    def grad_hook(epoch, i, loss, grads):
        for g in grads.values():
            finite[0] = finite[0] & torch.isfinite(g).all()

    ts, tx = init(core, model, None, cfg, core.make_key(key_seed))
    step = make(core, model, cfg, tx, grad_hook=grad_hook, phase_hook=hook)
    kernel.launches = 0
    out = []
    for i in range(steps):
        before, convs = kernel.launches, EmbedActorCritic.grid_embed.calls
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
               "k1_launches": kernel.launches - before,
               "grid_convs": EmbedActorCritic.grid_embed.calls - convs}
        print(f"{label} step {i}: " + json.dumps(rec), flush=True)
        out.append(rec)
        if not all(math.isfinite(v) for v in host.values()):
            raise AssertionError(f"{label} step {i}: non-finite stats {host}")
        if not 0.0 < host["entropy"] < math.log(5):
            raise AssertionError(f"{label} step {i}: entropy {host['entropy']} outside (0, ln 5)")
        if host["episodes_finished"] != expect_finished[i]:
            raise AssertionError(f"{label} step {i}: {host['episodes_finished']} episodes "
                                 f"finished, expected {expect_finished[i]}")
        if rec["k1_launches"] != expect_k1:
            raise AssertionError(f"{label} step {i}: K1 launched {rec['k1_launches']} times, "
                                 f"expected {expect_k1}")
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
    return kernel.launches, out


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
               "peak_gib": max(r["peak_gib"] for r in recs), "k1_launches_per_step": launches / TRAIN_STEPS,
               "episode_avg_throughput_step1": thr}
    print("train summary: " + json.dumps(summary), flush=True)
    return launches, summary


def phase_train_ff(device):
    """The feedforward fused learner at 1024 envs x 8 agents, 16x16, r=5,
    embed/hidden 256, T = 64, 2 epochs x 4 minibatches, random bf16 init:
    three steps with obstacle_path='auto' (picks 'pre': no K1, two grid
    convolutions per rollout and one per loss), then one step with
    'windows' (K1 once per rollout step, once for the bootstrap, once per
    loss). Returns ((launches 'pre', launches 'windows'), summary)."""
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
        expect_k1 = 0 if path == "auto" else t + 1 + e * m
        launches[path], recs = _run_train_steps(
            f"train_ff ({path})", core, model, cfg, tp.init_fused_train_state,
            tp.make_fused_train_step, 1, steps, expect_k1, [0.0, 1024.0, 0.0], device)
        convs = [r["grid_convs"] for r in recs]
        want_convs = 2 + e * m if path == "auto" else 0
        if any(c != want_convs for c in convs):
            raise AssertionError(f"train_ff ({path}): {convs} grid convolutions per step, "
                                 f"expected {want_convs}")
        best = min(recs, key=lambda r: r["seconds_total"])
        out[path] = {"seconds_per_step": [r["seconds_total"] for r in recs],
                     "best_split_s": best["seconds"], "env_steps_per_s_best": best["env_steps_per_s"],
                     "peak_gib": max(r["peak_gib"] for r in recs), "grid_convs_per_step": convs[0],
                     "k1_launches_per_step": launches[path] / steps}
    print("train_ff summary: " + json.dumps(out), flush=True)
    return (launches["auto"], launches["windows"]), out


def profile_train(device):
    """The kernel table of one recurrent train step at config-D shapes with
    T = 16 and one epoch (profile_train_d.txt beside the other kernel
    tables): every kernel at the full step's shapes, an eighth of its
    passes, so that the trace stays small. The same step is timed once
    with the profiler off, for a busy share that the tracing does not
    dilute."""
    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch import parallel as tp
    from pogema_torch.interop import load_policy

    core = PogemaCore(GridConfig(seed=0, **CONFIG_D), num_envs=NUM_ENVS_D,
                      auto_reset_mode="regen", device=device)
    model = load_policy(WEIGHTS, device=device)
    cfg = tp.PPOConfig(**dict(TRAIN_D_PPO, rollout_steps=16, epochs=1))
    ts, tx = tp.init_recurrent_train_state(core, model, None, cfg, core.make_key(2))
    step = tp.make_recurrent_train_step(core, model, cfg, tx)
    box = [step(ts)[0]]

    def one():
        box[0] = step(box[0])[0]

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    dev_s, kernels = _profile("config-D recurrent train step (T=16, 1 epoch x 8 minibatches)",
                              "profile_train_d.txt", one, 1)
    k1_us = sum(us for name, us in kernels.items() if "packed_windows_kernel" in name)
    t, m = cfg.rollout_steps, cfg.minibatches
    print(f"the same step with the profiler off: wall {plain_wall * 1e3:.1f} ms, so device busy "
          f"share {dev_s / plain_wall:.3f}; K1 took {k1_us:.1f} us of device time over "
          f"{t + 1} launches at B={NUM_ENVS_D} and {m * t} at B={NUM_ENVS_D // m}", flush=True)


def phase_k1_shapes(device):
    """K1 beside its bound, its plain version and the gather at the
    config-D serving shape and at the recurrent update's shape (config
    C's is in the kernel record itself)."""
    p = CONFIG_D["size"] + 2 * CONFIG_D["obs_radius"]
    n, r = CONFIG_D["num_agents"], CONFIG_D["obs_radius"]
    out = {}
    for name, b in (("serve_config_d", NUM_ENVS_D),
                    ("train_update_config_d", NUM_ENVS_D // TRAIN_D_PPO["minibatches"])):
        out[name] = dict(B=b, M=n, P=p, **time_k1(device, b, p, n, r))
    return out


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
        reports = build.build_all(["windows"])
        for name, log in reports.items():
            for line in log.splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

    phase("build", do_build)
    if failed:
        return 1
    p = CONFIG_C["size"] + 2 * CONFIG_C["obs_radius"]
    record = phase("k1", phase_k1, device, NUM_ENVS_C, p, CONFIG_C["num_agents"],
                   CONFIG_C["obs_radius"])
    phase("devices_agree", phase_devices_agree, device)
    main_out = phase("main_path", phase_main, device)
    phase("breakdown", phase_breakdown, device)
    try:  # the profiler is a diagnostic: the run does not depend on it
        profile_step(device)
    except Exception:
        traceback.print_exc()
        print("profile: torch.profiler unavailable on this machine", flush=True)
    phase("policy", phase_policy, device)
    serve_out = phase("serve", phase_serve, device)
    try:
        profile_serve(device)
    except Exception:
        traceback.print_exc()
        print("profile: torch.profiler unavailable on this machine", flush=True)
    phase("serve_agree", phase_serve_agree, device)
    phase("planner", phase_planner, device)
    phase("train_agree", phase_train_agree, device)
    train_out = phase("train", phase_train, device)
    train_ff_out = phase("train_ff", phase_train_ff, device)
    try:
        profile_train(device)
    except Exception:
        traceback.print_exc()
        print("profile: torch.profiler unavailable on this machine", flush=True)

    shapes = phase("k1_shapes", phase_k1_shapes, device)
    if (failed or record is None or main_out is None or serve_out is None or train_out is None
            or train_ff_out is None):
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    record["launches"] = main_out[0]
    record["launches_by_path"] = {"main_path": main_out[0], "serve": serve_out[0],
                                  "train": train_out[0], "train_ff": train_ff_out[0][0],
                                  "train_ff_windows": train_ff_out[0][1]}
    record["other_shapes"] = shapes
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
