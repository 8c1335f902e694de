"""Head-to-head LifeLong evaluation at the config-C shape, with the
PyTorch port on one NVIDIA GPU: 64 agents on a 64x64 grid,
on_target='restart', unseen seeds.

Counterpart of ``examples/eval_lifelong_64.py``: the PPO weights (by
default the committed ``pogema_torch/weights/ppo64.npz``, the orbax
checkpoint ``.ckpt_ppo64`` converted), the decentralized A* baseline,
the centralized batched planner ("Planner", MAPF observations) and
random, on episode avg_throughput (goals per step, the LifeLong metric).

  python examples/eval_lifelong_64_cuda.py [checkpoint] [seeds...]

``--size``, ``--agents`` and ``--steps`` shrink the world for a quick
run; ``--device cpu`` runs on the host (the default, 'cuda', raises
without a card).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", nargs="?",
                    default=os.path.join(ROOT, "pogema_torch", "weights", "ppo64.npz"))
    ap.add_argument("seeds", type=int, nargs="*", default=[1001, 1002, 1003])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises when there is no card) or 'cpu'")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--steps", type=int, default=128)
    args = ap.parse_args(argv)

    from pogema_torch.toolbox import evaluate

    base = dict(size=args.size, density=0.3, num_agents=args.agents, obs_radius=5,
                on_target="restart", max_episode_steps=args.steps)
    run = dict(seeds=args.seeds, device=args.device)
    results = {}
    results["random"] = evaluate(dict(base), algo="random", **run)["env"]
    results["A*"] = evaluate(dict(base, observation_type="POMAPF"), algo="A*", **run)["env"]
    results["Planner"] = evaluate(dict(base, observation_type="MAPF"), algo="Planner",
                                  **run)["env"]
    results["PPO"] = evaluate(dict(base), algo="PPO", algo_kwargs={"checkpoint": args.checkpoint},
                              **run)["env"]

    for name, m in results.items():
        print(json.dumps({"algo": name, "avg_throughput": round(m.get("avg_throughput", 0), 4),
                          "ep_length": m.get("ep_length")}))
    return results


if __name__ == "__main__":
    main()
