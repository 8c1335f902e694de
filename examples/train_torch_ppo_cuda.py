"""External-framework end-to-end proof: a plain PyTorch PPO learner on the
port's batched engine, through the NumPy rim, on one NVIDIA GPU.

Counterpart of ``examples/train_torch_ppo.py``: the environment is
:class:`pogema_torch.PogemaVectorEnv` stepping B envs x N agents per call
on ``--device`` with ``obs_layout='packed'`` (flat [B*N, 3*W*W] rows,
one K1b launch per observation set on the card), and the policy and
optimizer are plain torch on the same device. NumPy sits at the boundary,
as it does for an external SampleFactory or CleanRL learner.

  python examples/train_torch_ppo_cuda.py --envs 256 --agents 4 --size 12 --iters 40

``--device cpu`` runs both on the host (the default, 'cuda', raises
without a card); there it computes what the JAX script computes with its
env on the host.
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
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--size", type=int, default=12)
    ap.add_argument("--obs-radius", type=int, default=3)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--rollout-steps", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--gae-lambda", type=float, default=0.95)
    ap.add_argument("--clip", type=float, default=0.2)
    ap.add_argument("--entropy-coef", type=float, default=0.01)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--on-target", default="restart")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn as nn

    from pogema_torch import GridConfig, PogemaVectorEnv

    torch.manual_seed(0)
    dev = torch.device(args.device)
    env = PogemaVectorEnv(
        GridConfig(seed=0, size=args.size, num_agents=args.agents, obs_radius=args.obs_radius,
                   max_episode_steps=64, on_target=args.on_target),
        num_vec_envs=args.envs, obs_layout="packed", auto_reset_mode="cached", device=dev)
    obs_dim = 3 * (2 * args.obs_radius + 1) ** 2
    n_act = 5
    slots = env.num_envs  # B*N agent slots

    class ActorCritic(nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk = nn.Sequential(
                nn.Linear(obs_dim, args.hidden), nn.ReLU(),
                nn.Linear(args.hidden, args.hidden), nn.ReLU())
            self.pi = nn.Linear(args.hidden, n_act)
            self.v = nn.Linear(args.hidden, 1)

        def forward(self, x):
            h = self.trunk(x)
            return self.pi(h), self.v(h).squeeze(-1)

    model = ActorCritic().to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    def on_dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    obs, _ = env.reset(seed=0)
    obs = on_dev(obs)
    T = args.rollout_steps
    for it in range(args.iters):
        t0 = time.perf_counter()
        b_obs = torch.empty((T, slots, obs_dim), device=dev)
        b_act = torch.empty((T, slots), dtype=torch.long, device=dev)
        b_logp = torch.empty((T, slots), device=dev)
        b_val = torch.empty((T, slots), device=dev)
        b_rew = torch.empty((T, slots), device=dev)
        b_done = torch.empty((T, slots), device=dev)
        metric_sum, metric_n = 0.0, 0
        for t in range(T):
            with torch.no_grad():
                logits, value = model(obs)
                dist = torch.distributions.Categorical(logits=logits)
                act = dist.sample()
                logp = dist.log_prob(act)
            nobs, rew, term, trunc, infos = env.step(act.cpu().numpy())
            b_obs[t], b_act[t], b_logp[t], b_val[t] = obs, act, logp, value
            b_rew[t] = on_dev(rew)
            b_done[t] = on_dev(np.logical_or(term, trunc))
            if "metrics/ep_length" in infos:
                mask = infos["_metrics"]
                key = ("metrics/avg_throughput" if "metrics/avg_throughput" in infos
                       else "metrics/ISR")
                metric_sum += float(infos[key][mask].sum())
                metric_n += int(mask.sum())
            obs = on_dev(nobs)

        with torch.no_grad():
            _, last_val = model(obs)
        adv = torch.zeros_like(b_rew)
        gae = torch.zeros(slots, device=dev)
        for t in reversed(range(T)):
            nxt = last_val if t == T - 1 else b_val[t + 1]
            mask = 1.0 - b_done[t]
            delta = b_rew[t] + args.gamma * nxt * mask - b_val[t]
            gae = delta + args.gamma * args.gae_lambda * mask * gae
            adv[t] = gae
        ret = adv + b_val

        def flat(x):
            return x.reshape(T * slots, *x.shape[2:])

        f_obs, f_act = flat(b_obs), flat(b_act)
        f_logp, f_adv, f_ret = flat(b_logp), flat(adv), flat(ret)
        f_adv = (f_adv - f_adv.mean()) / (f_adv.std() + 1e-8)
        n = T * slots
        mb = n // args.minibatches
        stats = {}
        for _ in range(args.epochs):
            perm = torch.randperm(n).to(dev)
            for k in range(args.minibatches):
                idx = perm[k * mb:(k + 1) * mb]
                logits, value = model(f_obs[idx])
                dist = torch.distributions.Categorical(logits=logits)
                ratio = torch.exp(dist.log_prob(f_act[idx]) - f_logp[idx])
                a = f_adv[idx]
                pg = -torch.min(ratio * a,
                                torch.clamp(ratio, 1 - args.clip, 1 + args.clip) * a).mean()
                v_loss = 0.5 * (value - f_ret[idx]).pow(2).mean()
                ent = dist.entropy().mean()
                loss = pg + v_loss - args.entropy_coef * ent
                opt.zero_grad()
                loss.backward()
                nn.utils.clip_grad_norm_(model.parameters(), 0.5)
                opt.step()
                stats = {"loss": loss.item(), "entropy": ent.item(), "v_loss": v_loss.item()}
        dt = time.perf_counter() - t0
        sps = T * args.envs / dt
        metric = metric_sum / max(metric_n, 1)
        print(f"iter {it:3d}  reward/step {float(b_rew.mean()):.4f}  ep_metric {metric:.3f}  "
              f"loss {stats['loss']:.4f}  entropy {stats['entropy']:.3f}  "
              f"{sps:,.0f} env-steps/s", flush=True)
    return float(b_rew.mean())


if __name__ == "__main__":
    main()
