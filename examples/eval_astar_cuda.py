"""Evaluate the scripted A* baseline over a config grid (the reference
README's canonical usage, via the toolbox harness), with the PyTorch
port's envs on one NVIDIA GPU.

Counterpart of ``examples/eval_astar.py``.

  python examples/eval_astar_cuda.py [--seeds 0 1 2] [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ENVIRONMENTS = {
    "random-8": dict(size=8, density=0.3, num_agents=4, obs_radius=3, max_episode_steps=64,
                     observation_type="POMAPF"),
    "random-16": dict(size=16, density=0.3, num_agents=8, obs_radius=3, max_episode_steps=128,
                      observation_type="POMAPF"),
    "warehouse": dict(map_name="warehouse-16x16", num_agents=8, obs_radius=3,
                      max_episode_steps=128, observation_type="POMAPF"),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises when there is no card) or 'cpu'")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)

    from pogema_torch.toolbox import evaluate

    results = evaluate(ENVIRONMENTS, algo="A*", seeds=args.seeds, device=args.device)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
