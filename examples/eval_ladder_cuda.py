"""Head-to-head LifeLong evaluation ladder at any shape (configs C/D/E),
with the PyTorch port on one NVIDIA GPU.

Counterpart of ``examples/eval_ladder.py``: the PPO weights against the
decentralized A* baseline, the centralized batched planner ("Planner",
MAPF observations) and random, on episode avg_throughput (goals per step
per agent, the LifeLong metric), over unseen seeds. The weights are the
committed ``.npz`` files of ``pogema_torch/weights`` (the orbax
checkpoints of the JAX script, converted).

  python examples/eval_ladder_cuda.py --agents 128 --size 64 \\
      --ckpt pogema_torch/weights/rec128.npz --seeds 1001 1002 1003
  python examples/eval_ladder_cuda.py --agents 256 --size 128 --maps mixed \\
      --ckpt pogema_torch/weights/maze256.npz --algos random A* Planner PPO

Runs on the card unless ``--device cpu`` is given, and raises without
one.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises when there is no card) or 'cpu'")
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--density", type=float, default=0.3)
    ap.add_argument("--obs-radius", type=int, default=5)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--maps", default="random",
                    choices=["random", "mixed", "mixed-random", "mixed-maze"],
                    help="'mixed' draws each seed's world uniformly from the config-E mixed "
                         "random+maze pool; 'mixed-random' / 'mixed-maze' restrict the draw "
                         "to one kind (per-kind means are reported apart, never averaged "
                         "across kinds)")
    ap.add_argument("--braid", type=float, default=0.15,
                    help="maze braid level of the pool (0.0 = perfect mazes)")
    ap.add_argument("--ckpt", default=None,
                    help="PPO weights: an .npz of flax leaves (pogema_torch/weights/*.npz) "
                         "or a params checkpoint of the port")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1001, 1002, 1003])
    ap.add_argument("--algos", nargs="+", default=["random", "A*", "Planner", "PPO"])
    args = ap.parse_args(argv)

    import numpy as np

    from pogema_torch.toolbox import evaluate

    base = dict(size=args.size, density=args.density, num_agents=args.agents,
                obs_radius=args.obs_radius, on_target="restart", max_episode_steps=args.steps)

    pool = None
    if args.maps.startswith("mixed"):
        from pogema_torch.maps import mixed_pool

        pool = mixed_pool(args.size, braid=args.braid)

    def env_for(seed):
        kw = dict(base)
        kind = None
        if pool is not None:
            half = len(pool) // 2
            # A uniform draw over the pool (or one kind's half), seeded by
            # the eval seed: the distribution training samples from.
            rng = np.random.default_rng(seed)
            if args.maps == "mixed-random":
                idx = int(rng.integers(half))
            elif args.maps == "mixed-maze":
                idx = half + int(rng.integers(len(pool) - half))
            else:
                idx = int(rng.integers(len(pool)))
            kind = "random" if idx < half else "maze"
            kw["map"] = pool[idx].tolist()
        return kw, kind

    results = {}
    for algo in args.algos:
        per_seed, kinds = [], []
        for seed in args.seeds:
            kw, kind = env_for(seed)
            if algo == "A*":
                kw["observation_type"] = "POMAPF"
            elif algo == "Planner":
                kw["observation_type"] = "MAPF"
            akw = {"checkpoint": args.ckpt} if algo == "PPO" else None
            m = evaluate(kw, algo=algo, seeds=[seed], algo_kwargs=akw, device=args.device)["env"]
            per_seed.append(m.get("avg_throughput", 0.0))
            kinds.append(kind)
        mean = sum(per_seed) / len(per_seed)
        results[algo] = mean
        row = {"algo": algo, "avg_throughput": round(mean, 4),
               "per_seed": [round(x, 4) for x in per_seed]}
        for k in ("random", "maze"):
            vals = [x for x, kk in zip(per_seed, kinds) if kk == k]
            if vals:
                row[f"mean_{k}"] = round(sum(vals) / len(vals), 4)
        print(json.dumps(row), flush=True)
    return results


if __name__ == "__main__":
    main()
