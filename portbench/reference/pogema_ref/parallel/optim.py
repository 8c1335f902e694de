"""The learner's optimizer: global-norm clipping, then Adam.

Counterpart of the ``optax.chain(optax.clip_by_global_norm(max_norm),
optax.adam(lr))`` that ``pogema_tpu/parallel/learner.py`` builds. The two
transforms are written out over a flat ``{name: tensor}`` dict in the
order of float operations that optax 0.2.6 uses:

* clip: ``g`` unchanged when ``norm < max_norm``, else
  ``(g / norm) * max_norm`` (no ``+ 1e-6`` in the denominator, unlike
  ``torch.nn.utils.clip_grad_norm_``);
* Adam: ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) * g**2 + b2 * nu``,
  bias corrections ``1 - b**count`` in f32, and the update
  ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` (``eps_root = 0``).
  ``torch.optim.Adam`` orders these differently (``eps`` is added to
  ``sqrt(nu) / sqrt(1 - b2**count)``, the step size is divided by the
  first correction).

The state is a plain dict ``{"count": i32[], "mu": {...}, "nu": {...}}``
so it can be saved, compared and carried across to optax's
``ScaleByAdamState``. Nothing here is in place: every call returns new
tensors.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Hyperparameters of the chain; ``init`` and ``update`` are the two
    halves of an optax ``GradientTransformation``."""

    lr: float
    max_norm: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict) -> dict:
        """Zero moments shaped like ``params`` and a zero step count."""
        first = next(iter(params.values()))
        return {"count": torch.zeros((), dtype=torch.int32, device=first.device),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, grads: dict, state: dict):
        """(updates, new_state): add ``updates[k]`` to parameter ``k``."""
        clipped = clip_by_global_norm(grads, self.max_norm)
        return adam_update(clipped, state, self.lr, self.b1, self.b2, self.eps)


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares."""
    total = None
    for g in grads.values():
        s = (g * g).sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    norm = global_norm(grads)
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * max_norm) for k, g in grads.items()}


def adam_update(grads: dict, state: dict, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """One Adam step on ``grads``; returns (updates, new_state)."""
    count = state["count"] + 1
    f32 = torch.float32
    dev = count.device
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=dev), count)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=dev), count)
    mu, nu, updates = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1 - b1) * g + b1 * state["mu"][k]
        nu[k] = (1 - b2) * (g * g) + b2 * state["nu"][k]
        updates[k] = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps) * (-lr)
    return updates, {"count": count, "mu": mu, "nu": nu}
