"""Record an episode and save SVG animations (plain, egocentric, static),
mirroring the reference's AnimationMonitor usage, with the PyTorch port's
envs on one NVIDIA GPU.

Counterpart of ``examples/animate.py``: A* on POMAPF observations, then
the same scenario under the batched global planner (MAPF observations).

  python examples/animate_cuda.py [--out renders] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises when there is no card) or 'cpu'")
    ap.add_argument("--out", default="renders", help="directory of the SVG files")
    args = ap.parse_args(argv)

    from pogema_torch import (AnimationConfig, AnimationMonitor, BatchAStarAgent,
                              GlobalPlannerPolicy, GridConfig, pogema_v0)

    def episode(obs_type, policy):
        env = AnimationMonitor(
            pogema_v0(GridConfig(seed=7, size=12, density=0.25, num_agents=4, obs_radius=3,
                                 max_episode_steps=48, observation_type=obs_type),
                      device=args.device),
            AnimationConfig(directory=args.out, save_every_idx_episode=None))
        obs, _ = env.reset()
        while True:
            obs, rew, term, trunc, infos = env.step(policy.act(obs))
            if all(t or tr for t, tr in zip(term, trunc)):
                return env, infos[0]["metrics"]

    env, metrics = episode("POMAPF", BatchAStarAgent())
    print("metrics:", metrics)
    paths = [env.save_animation(os.path.join(args.out, "episode.svg")),
             env.save_animation(os.path.join(args.out, "episode_ego.svg"),
                                AnimationConfig(egocentric_idx=0)),
             env.save_animation(os.path.join(args.out, "episode_static.svg"),
                                AnimationConfig(static=True))]
    env, metrics = episode("MAPF", GlobalPlannerPolicy(device=args.device))
    print("planner metrics:", metrics)
    paths.append(env.save_animation(os.path.join(args.out, "planner_episode.svg")))
    for p in paths:
        print(p)
    return paths


if __name__ == "__main__":
    main()
