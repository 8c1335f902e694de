"""Evaluation harness of the port: the counterpart of
``pogema_tpu/toolbox.py`` (YAML-driven evaluation, an algo registry,
result aggregation).

Registers policies by name, runs them over grids of configs × seeds on
``device`` (the card unless the caller asks for the CPU), and averages
the standard MAPF metrics (ISR/CSR/ep_length/avg_throughput).

    from pogema_torch.toolbox import evaluate
    results = evaluate({"size": 16, "num_agents": 8}, algo="A*",
                       seeds=[0, 1, 2], device="cuda")

    # or YAML-driven:
    #   python -m pogema_torch.toolbox eval.yaml [--device cpu]
    # with eval.yaml:
    #   algo: A*
    #   seeds: [0, 1, 2]
    #   environments:
    #     random-16: {size: 16, density: 0.3, num_agents: 8}
    #     warehouse: {map_name: warehouse-16x16, num_agents: 8}
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

from .a_star_policy import BatchAStarAgent
from .envs import pogema_v0
from .grid_config import NUM_ACTIONS, GridConfig

ALGO_REGISTRY: dict = {}


def register_algo(name: str, factory: Callable) -> None:
    """factory(**algo_kwargs) -> policy with .act(observations) -> list[int]
    and optionally .reset_states(). A factory with a ``device`` parameter
    also gets :func:`evaluate`'s ``device``."""
    ALGO_REGISTRY[name] = factory


class _RandomPolicy:
    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)

    def act(self, observations):
        return self._rng.integers(NUM_ACTIONS, size=len(observations)).tolist()

    def reset_states(self):
        pass


def _params_tree(checkpoint):
    """The flax-shaped ``{'params': ...}`` nest, or an ``.npz`` path, that
    :func:`pogema_torch.interop.load_policy` takes, from ``checkpoint``:
    an ``.npz`` of flattened flax leaves, a params checkpoint of the port
    (``utils.checkpoint``, the ``{name: tensor}`` dict that
    ``examples/train_ppo_cuda.py --checkpoint`` writes), or such a nest or
    dict itself."""
    from .interop import state_to_flax
    from .utils.checkpoint import restore_checkpoint

    if isinstance(checkpoint, dict):
        return checkpoint if "params" in checkpoint else state_to_flax(checkpoint)
    if str(checkpoint).endswith(".npz"):
        return checkpoint
    if os.path.isdir(checkpoint):
        raise ValueError(f"{checkpoint} is a directory (an orbax checkpoint of the JAX package?); "
                         "pass an .npz of its leaves (interop.flatten_params) or a checkpoint "
                         "file of the port")
    return state_to_flax(restore_checkpoint(checkpoint))


class PPOPolicy:
    """A trained actor-critic as a toolbox algo (name "PPO").

    The model family and sizes are inferred from the parameters as the JAX
    toolbox does (``interop.params_from_flax``): ``embed_kernel`` with
    ``gru`` is :class:`~pogema_torch.models.RecurrentEmbedActorCritic`
    (hidden state carried across ``act`` calls, cleared by
    ``reset_states``), ``embed_kernel`` alone
    :class:`~pogema_torch.models.EmbedActorCritic`, anything else the conv
    :class:`~pogema_torch.models.ActorCritic`. Consumes the 3-channel
    'default' observations. Runs eagerly under ``torch.inference_mode``
    on ``device`` ("cuda" by default, raising without a card) in bf16, as
    the JAX toolbox does. ``temperature=0`` acts
    greedily; > 0 samples with the policy's own host RNG."""

    def __init__(self, checkpoint, temperature: float = 0.0, seed=0, device="cuda"):
        from .interop import load_policy
        from .models import RecurrentEmbedActorCritic

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PPOPolicy(device='cuda') needs a CUDA device; pass device='cpu' "
                               "to run on the host")
        self._model = load_policy(_params_tree(checkpoint), self.device, torch.bfloat16)
        self._recurrent = isinstance(self._model, RecurrentEmbedActorCritic)
        self._h = None
        self._temperature = float(temperature)
        self._rng = np.random.default_rng(seed)

    def logits(self, observations) -> np.ndarray:
        """f64[N, 5] logits of one call (the recurrent state advances)."""
        obs = np.asarray(observations, np.float32)  # [N, 3, W, W]
        with torch.inference_mode():
            x = torch.as_tensor(obs, device=self.device)
            if self._recurrent:
                if self._h is None or self._h.shape[0] != obs.shape[0]:
                    self._h = self._model.initial_carry((obs.shape[0],))
                self._h, logits, _ = self._model(x, self._h)
            else:
                logits = self._model(x)[0]
            return logits.to(torch.float64).cpu().numpy()

    def act(self, observations, episode_start: bool = False):
        """``episode_start=True`` marks an episode boundary explicitly (as
        :meth:`reset_states` first does), for callers that drive the policy
        themselves instead of through ``run_episode``."""
        if episode_start:
            self.reset_states()
        logits = self.logits(observations)
        if self._temperature > 0.0:
            # Gumbel-max sampling with the policy's own host RNG.
            u = self._rng.uniform(1e-12, 1.0, size=logits.shape)
            logits = logits / self._temperature - np.log(-np.log(u))
        return np.argmax(logits, axis=-1).astype(int).tolist()

    def reset_states(self):
        self._h = None

    # gym-style alias: harnesses that call ``policy.reset()`` at episode
    # boundaries get the same state clear.
    def reset(self):
        self.reset_states()


def _planner_factory(device="cuda", **kwargs):
    from .planner_policy import GlobalPlannerPolicy

    return GlobalPlannerPolicy(device=device, **kwargs)


register_algo("A*", BatchAStarAgent)
register_algo("random", _RandomPolicy)
register_algo("PPO", PPOPolicy)
# Centralized shortest-path baseline (privileged, needs
# observation_type='MAPF' in the environment kwargs).
register_algo("Planner", _planner_factory)


def run_episode(env, policy, max_steps: int = 10_000) -> dict:
    obs, infos = env.reset()
    if hasattr(policy, "reset_states"):
        policy.reset_states()
    for _ in range(max_steps):
        obs, rew, term, trunc, infos = env.step(policy.act(obs))
        if all(t or tr for t, tr in zip(term, trunc)):
            return dict(infos[0].get("metrics", {}))
    raise RuntimeError("episode never terminated")


def evaluate(environments, algo: str = "A*", seeds=(0,), algo_kwargs: Optional[dict] = None,
             device="cuda") -> dict:
    """environments: GridConfig kwargs dict, or {name: kwargs} mapping.
    Returns {env_name: {metric: mean over seeds}}. The envs, and the
    algos whose factory has a ``device`` parameter (PPO, Planner), run on
    ``device``."""
    if isinstance(environments, dict) and not any(
            isinstance(v, dict) for v in environments.values()):
        environments = {"env": environments}
    factory = ALGO_REGISTRY[algo]
    kwargs_algo = dict(algo_kwargs or {})
    if "device" in inspect.signature(factory).parameters:
        kwargs_algo.setdefault("device", device)
    results = {}
    for name, kwargs in environments.items():
        per_seed = []
        for seed in seeds:
            cfg = GridConfig(**{**kwargs, "seed": int(seed)})
            env = pogema_v0(cfg, device=device)
            policy = factory(**kwargs_algo)
            per_seed.append(run_episode(env, policy))
        keys = sorted({k for m in per_seed for k in m})
        results[name] = {k: float(np.mean([m[k] for m in per_seed if k in m])) for k in keys}
        results[name]["episodes"] = len(per_seed)
    return results


def evaluate_from_yaml(path: str, device="cuda") -> dict:
    import yaml

    with open(path) as f:
        spec = yaml.safe_load(f)
    return evaluate(spec["environments"], algo=spec.get("algo", "A*"),
                    seeds=spec.get("seeds", [0]), algo_kwargs=spec.get("algo_kwargs"),
                    device=device)


def main(argv=None):  # pragma: no cover - thin CLI
    ap = argparse.ArgumentParser(description="Evaluate an algo over the environments of a "
                                             "YAML file (see the module docstring).")
    ap.add_argument("spec", help="the YAML file")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    print(json.dumps(evaluate_from_yaml(args.spec, device=args.device), indent=2))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
