"""Dry-run entry points of the port: the flagship model's forward, and one
full train step of both learner families over a mesh of processes.

Counterpart of ``__graft_entry__.py`` (``entry`` and
``dryrun_multichip``). One rank per card:

    torchrun --nproc-per-node 4 -m pogema_torch.parallel.dryrun
    torchrun --nproc-per-node 4 -m pogema_torch.parallel.dryrun --device cpu   # gloo
    python -m pogema_torch.parallel.dryrun            # one process, one card

Each rank prints one line, ``RESULT <rank> mesh <data>x<model>
fused_loss=<x> recurrent_loss=<y>``.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.distributed as dist


def entry(device="cuda"):
    """(fn, example_args): the forward of the flagship model, the fused
    window-embedding actor-critic reading raw env state
    (``EmbedActorCritic.from_state``: one K1b launch on the card). The
    module holds its parameters, so ``fn`` takes only the state."""
    from ..models import init_embed_params

    window = 11  # obs_radius 5
    model, _ = init_embed_params(torch.Generator().manual_seed(0), window)
    model.to(device)
    b, n, size = 64, 8, 16
    p = size + window - 1  # padded grid
    r = window // 2
    rng = np.random.default_rng(0)
    grids = torch.as_tensor((rng.random((b, p, p)) < 0.2).astype(np.uint8), device=device)
    agents_xy = torch.as_tensor(rng.integers(r, r + size, (b, n, 2)), dtype=torch.int32,
                                device=device)
    targets_xy = torch.as_tensor(rng.integers(r, r + size, (b, n, 2)), dtype=torch.int32,
                                 device=device)
    active = torch.ones((b, n), dtype=torch.bool, device=device)
    return model.from_state, (grids, agents_xy, targets_xy, active)


def dryrun_multichip(n_devices: int, device="cuda") -> tuple:
    """One FULL train step of each learner family, the fused feedforward
    step and the recurrent (GRU) step, over a mesh ('data', 'model') of
    ``n_devices`` ranks (the whole world; a lone process makes a world of
    one): env state and trajectories shard over 'data', the trunk and the
    GRU gates over 'model' (2 when ``n_devices`` is even; the carried h
    is then 'model'-sharded). Tiny shapes: 8x8, 2 agents, r=2, embed and
    hidden 64, T=4, 1 epoch x 2 minibatches, 2 envs per data rank.
    Returns the two steps' stats; raises unless both losses are finite."""
    from .. import GridConfig, PogemaCore
    from ..models import init_embed_params, init_recurrent_params, partition_params
    from . import (PPOConfig, init_fused_train_state, init_recurrent_train_state,
                   make_fused_train_step, make_mesh, make_recurrent_train_step)
    from .learner import params_of

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs a world of {n_devices} ranks, "
                         f"this one has {world}")
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(data=n_devices // model_axis, model=model_axis, device=device)
    cfg = GridConfig(seed=0, size=8, density=0.2, num_agents=2, obs_radius=2,
                     max_episode_steps=8, on_target="restart")
    num_envs = 2 * (n_devices // model_axis)
    core = PogemaCore(cfg, num_envs=num_envs, auto_reset_mode="regen", device=device)
    ppo = PPOConfig(rollout_steps=4, epochs=1, minibatches=2)
    out = []
    for init_params, init, make, seeds in (
            (init_embed_params, init_fused_train_state, make_fused_train_step, (0, 1)),
            (init_recurrent_params, init_recurrent_train_state, make_recurrent_train_step,
             (2, 3))):
        model, _ = init_params(torch.Generator().manual_seed(seeds[0]), cfg.obs_radius * 2 + 1,
                               embed=64, hidden=64)
        params = partition_params(params_of(model), mesh)
        ts, tx = init(core, model, params, ppo, core.make_key(seeds[1]), mesh=mesh)
        ts, stats = make(core, model, ppo, tx, mesh=mesh)(ts)
        loss = float(stats["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"dryrun_multichip({n_devices}): loss {loss}, stats {stats}")
        out.append({k: float(v) for k, v in stats.items()})
    return tuple(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: NCCL, one rank per card) or 'cpu' (gloo)")
    args = ap.parse_args(argv)
    from .mesh import initialize_distributed

    initialize_distributed(device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    fn, example = entry(args.device)
    with torch.no_grad():
        logits, _ = fn(*example)
    if tuple(logits.shape) != (64, 8, 5):
        raise AssertionError(f"entry: logits of shape {tuple(logits.shape)}")
    fused, recurrent = dryrun_multichip(world, args.device)
    model_axis = 2 if world % 2 == 0 else 1
    print(f"RESULT {dist.get_rank()} mesh {world // model_axis}x{model_axis} "
          f"fused_loss={fused['loss']:.9g} recurrent_loss={recurrent['loss']:.9g}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
