"""End-to-end PPO training with the PyTorch port on one NVIDIA GPU.

Counterpart of ``examples/train_ppo.py``. The default is the FUSED
learner: the policy reads the env state through its first layer, so no
observation tensor exists anywhere in training. ``--model recurrent``
trains the GRU family, ``--model conv`` the observation-based conv
actor-critic.

  python examples/train_ppo_cuda.py --envs 1024 --agents 8 --size 16 --iters 50

Fine-tuning the shipped recurrent policy on config D:

  python examples/train_ppo_cuda.py --model recurrent --embed 128 --hidden 128 \\
      --envs 1024 --agents 128 --size 64 --minibatches 8 --lr 1.5e-4 \\
      --entropy-coef 0.003 --init-params pogema_torch/weights/rec128_ft.npz \\
      --checkpoint runs/rec128_ft2 --iters 200

Across cards, one rank per card, as the JAX script's device mesh
(``make_mesh()``: the env batch split over 'data'; ``--envs`` is the
global batch):

  torchrun --nproc-per-node 4 examples/train_ppo_cuda.py --envs 4096 ...
  torchrun --nproc-per-node 2 examples/train_ppo_cuda.py --device cpu ...   # gloo

Without ``torchrun`` it is one process, as before. Rank 0 prints, logs
and saves the params; with ``--checkpoint-every`` each rank saves and
resumes its own train state (``<checkpoint>_state_rank<r>``).

Runs on the card unless ``--device cpu`` is given, and raises without
one. A params checkpoint converts to the flax tree of the JAX package
with ``pogema_torch.interop.params_to_flax``. Left out, against the JAX
script: ``--tb-dir``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises when there is no card) or 'cpu'")
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--obs-radius", type=int, default=5)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rollout-steps", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--entropy-coef", type=float, default=0.01)
    ap.add_argument("--obstacle-path", default="auto", choices=["auto", "pre", "windows"],
                    help="fused-learner obstacle strategy (see "
                         "pogema_torch.parallel.make_fused_train_step)")
    ap.add_argument("--on-target", default="restart")
    ap.add_argument("--maps", default="random",
                    choices=["random", "maze", "mixed", "mixed-random", "mixed-maze"],
                    help="world distribution: Bernoulli 'random' (default), 'maze' "
                         "(sidewinder), or the config-E mixed random+maze pool "
                         "(pogema_torch.maps.mixed_pool; 'mixed-random' / 'mixed-maze' "
                         "keep one half)")
    ap.add_argument("--density", type=float, default=0.3)
    ap.add_argument("--max-episode-steps", type=int, default=128)
    ap.add_argument("--model", choices=["fused", "recurrent", "conv"], default="fused",
                    help="'fused' = feedforward obs-free EmbedActorCritic; 'recurrent' = GRU "
                         "family (obs-free); 'conv' = obs-based")
    ap.add_argument("--gru-hidden", type=int, default=None,
                    help="recurrent model only: GRU hidden size (defaults to --hidden)")
    ap.add_argument("--embed", type=int, default=256)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0, help="seeds the parameter init")
    ap.add_argument("--checkpoint", default=None, help="save the final params here")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="every k iters, save the FULL train state to <checkpoint>_state "
                         "(restart tolerance; requires --checkpoint)")
    ap.add_argument("--init-params", default=None,
                    help="warm start: a params checkpoint of this script, or an .npz of "
                         "flax leaves (pogema_torch/weights/rec128_ft.npz). Optimizer and "
                         "env state start fresh; use --resume for exact continuation.")
    ap.add_argument("--resume", action="store_true",
                    help="if <checkpoint>_state exists, restore it and continue from the "
                         "saved iteration (bit-exact against an uninterrupted run)")
    ap.add_argument("--log", default=None, help="CSV file for per-iteration training stats")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="fused and recurrent models: run K train steps per call; stats then "
                         "have K-step granularity. --iters (and --checkpoint-every) must be "
                         "divisible by K.")
    ap.add_argument("--log-every", type=int, default=1,
                    help="fetch and print stats every k iters (one host fetch each)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from pogema_torch import GridConfig, PogemaCore
    from pogema_torch.interop import state_from_flax, unflatten_params
    from pogema_torch.models import init_embed_params, init_params, init_recurrent_params
    from pogema_torch.parallel import (
        PPOConfig,
        init_fused_train_state,
        init_recurrent_train_state,
        init_train_state,
        initialize_distributed,
        make_fused_train_many,
        make_fused_train_step,
        make_mesh,
        make_recurrent_train_many,
        make_recurrent_train_step,
        make_train_step,
    )
    from pogema_torch.utils.checkpoint import (
        checkpoint_exists,
        restore_checkpoint,
        save_checkpoint,
    )

    # Under torchrun: one rank per card (NCCL), or gloo with --device cpu.
    initialize_distributed(device=args.device)
    mesh = make_mesh(device=args.device) if dist.is_initialized() else None
    rank = dist.get_rank() if mesh is not None else 0

    cfg = GridConfig(seed=0, size=args.size, num_agents=args.agents, obs_radius=args.obs_radius,
                     density=args.density, max_episode_steps=args.max_episode_steps,
                     on_target=args.on_target)
    # LifeLong: 'regen' gives new maps, placements and goal queues each
    # episode (episodes end together at the time limit, so regeneration
    # runs once per episode); cached mode would replay the same goals.
    fused_ok = args.on_target == "restart" and cfg.max_episode_steps % args.rollout_steps == 0
    auto_reset = "regen" if fused_ok else "cached"
    window = cfg.obs_radius * 2 + 1
    gen = torch.Generator().manual_seed(args.seed)
    map_bank = None
    if args.maps.startswith("mixed"):
        from pogema_torch.maps import mixed_pool

        map_bank = mixed_pool(args.size)
        half = len(map_bank) // 2
        if args.maps == "mixed-random":
            map_bank = map_bank[:half]
        elif args.maps == "mixed-maze":
            map_bank = map_bank[half:]
    env_kw = dict(maze=args.maps == "maze", map_bank=map_bank, device=args.device)

    if args.model == "fused":
        core = PogemaCore(cfg, num_envs=args.envs, auto_reset_mode=auto_reset, **env_kw)
        model, _ = init_embed_params(gen, window, embed=args.embed, hidden=args.hidden)
    elif args.model == "recurrent":
        core = PogemaCore(cfg, num_envs=args.envs, auto_reset_mode=auto_reset, **env_kw)
        model, _ = init_recurrent_params(gen, window, embed=args.embed,
                                         hidden=args.gru_hidden or args.hidden)
    else:
        # bf16 observations halve the trajectory; the model computes in bf16 anyway.
        core = PogemaCore(cfg, num_envs=args.envs, obs_dtype=torch.bfloat16, **env_kw)
        model, _ = init_params(gen, window)
    params = None
    if args.init_params:
        if args.init_params.endswith(".npz"):
            with np.load(args.init_params) as z:
                params = state_from_flax(unflatten_params({k: z[k] for k in z.files}))
        else:
            params = restore_checkpoint(args.init_params)
        print(f"warm-started params from {args.init_params}")
    ppo = PPOConfig(lr=args.lr, rollout_steps=args.rollout_steps, epochs=args.epochs,
                    minibatches=args.minibatches, entropy_coef=args.entropy_coef,
                    obstacle_path=args.obstacle_path)

    # Append on --resume so that a restart keeps the earlier curve; the
    # header is written only when the file is empty.
    log_file = open(args.log, "a" if args.resume else "w") if args.log and rank == 0 else None
    if log_file:
        log_file.seek(0, 2)

    key = core.make_key(1)
    kd = args.steps_per_dispatch
    if args.model in ("fused", "recurrent"):
        if args.model == "fused":
            ts, tx = init_fused_train_state(core, model, params, ppo, key, mesh=mesh)
            mk_one, mk_many = make_fused_train_step, make_fused_train_many
        else:
            ts, tx = init_recurrent_train_state(core, model, params, ppo, key, mesh=mesh)
            mk_one, mk_many = make_recurrent_train_step, make_recurrent_train_many
        if kd > 1:
            if args.iters % kd:
                raise SystemExit("--iters must be divisible by --steps-per-dispatch")
            if args.checkpoint_every and args.checkpoint_every % kd:
                raise SystemExit("--checkpoint-every must be divisible by --steps-per-dispatch")
            train_step = mk_many(core, model, ppo, tx, kd, mesh=mesh)
        else:
            train_step = mk_one(core, model, ppo, tx, mesh=mesh)
    else:
        if kd > 1:
            raise SystemExit("--steps-per-dispatch needs --model fused or recurrent")
        ts, tx = init_train_state(core, model, params, ppo, key, mesh=mesh)
        train_step = make_train_step(core, model, ppo, tx, mesh=mesh)

    if args.checkpoint:
        args.checkpoint = os.path.abspath(args.checkpoint)
    state_path = f"{args.checkpoint}_state" if args.checkpoint else None
    if state_path and mesh is not None:
        state_path = f"{state_path}_rank{rank}"
    if args.checkpoint_every and not state_path:
        raise SystemExit("--checkpoint-every requires --checkpoint")
    start_iter = 0
    if args.resume:
        if not state_path:
            raise SystemExit("--resume requires --checkpoint")
        if checkpoint_exists(state_path):
            saved = restore_checkpoint(state_path, like={"iter": np.int64(0), "ts": ts})
            ts, start_iter = saved["ts"], int(saved["iter"])
            if start_iter % kd:
                raise SystemExit(f"resumed iter {start_iter} is not aligned with "
                                 f"--steps-per-dispatch {kd}")
            print(f"resumed from {state_path} at iter {start_iter}")

    steps_per_iter = args.envs * args.rollout_steps
    t0 = time.perf_counter()
    it_last = start_iter
    for it in range(start_iter, args.iters, kd):
        ts, stats = train_step(ts)
        it = it + kd - 1  # last train step of this call
        if args.checkpoint_every and (it + 1) % args.checkpoint_every == 0:
            save_checkpoint(state_path, {"iter": np.int64(it + 1), "ts": ts})
        if rank or (it + 1) % args.log_every and it + 1 < args.iters:
            continue
        # ONE host fetch of the stacked stats (it also waits for the device).
        keys = sorted(stats)
        host = dict(zip(keys, torch.stack([stats[k].float() for k in keys]).tolist()))
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        sps = steps_per_iter * (it + 1 - it_last) / dt
        it_last = it + 1
        metric = (f"throughput {host.get('episode_avg_throughput', 0):.3f}"
                  if args.on_target == "restart" else f"ISR {host.get('episode_ISR', 0):.3f}")
        print(f"iter {it:4d}  reward/step {host['reward_per_step']:.4f}  {metric}  "
              f"loss {host['loss']:.4f}  entropy {host['entropy']:.3f}  "
              f"{sps:,.0f} env-steps/s", flush=True)
        if log_file:
            if log_file.tell() == 0:  # first logged row (not necessarily iter 0)
                print("iter,env_steps_per_s," + ",".join(keys), file=log_file)
            print(f"{it},{sps:.1f}," + ",".join(f"{host[k]:.6g}" for k in keys),
                  file=log_file, flush=True)
    if log_file:
        log_file.close()
    if args.checkpoint and rank == 0:
        save_checkpoint(args.checkpoint, ts.params)
        print(f"saved params to {args.checkpoint}")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
