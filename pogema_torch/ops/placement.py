"""Placement of a reset's agents and targets in plain PyTorch: the plain
version of K9.

Counterpart of ``pogema_tpu/core/generator.py``'s ``place_agents_and_targets``
(a ``lax.top_k`` and a ``lax.fori_loop`` over the agents, not a Pallas
kernel): the agents at the top-N uniforms over eligible cells (ties to the
lower index, as ``lax.top_k``), then each target the first argmax of masked
random bits over the free cells of the agent's component. The loop makes
N passes of masked int64 ops over ``[B, P*P]``, each with a hash of every
cell. It is what ``ops/cuda_placement.py`` returns for tensors on the CPU,
and what the card's kernel is held against.
"""

from __future__ import annotations

import torch

from . import cuda_threefry


def multi_cell_component(components, p: int) -> torch.Tensor:
    """bool[B, P*P]: free cells with a free 4-neighbour (component of
    size >= 2). The border is obstacles, so wrapped reads are not free."""
    b = components.shape[0]
    free = (components < p * p).reshape(b, p, p)
    nbr = (free.roll(1, 1) | free.roll(-1, 1) | free.roll(1, 2) | free.roll(-1, 2))
    return (free & nbr).reshape(b, p * p)


def _uniform(keys, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` of each key in [0, 1): the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    mant = (cuda_threefry.bits(keys, (n,)) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def place_agents_and_targets(keys, components, p: int, n: int):
    """N distinct agent cells among eligible cells, then per agent a
    target: a free cell of its component, distinct from earlier targets
    and from its own start. ``keys`` int64[B, 2], ``components`` the
    labels int64[B, P*P]. Returns (agent_cells i64[B, N], target_cells
    i64[B, N], ok bool[B])."""
    big = p * p
    b = keys.shape[0]
    dev = keys.device
    k = cuda_threefry.split(keys, 2)
    k_agents, k_targets = k[:, 0].contiguous(), k[:, 1].contiguous()

    eligible = multi_cell_component(components, p)
    u = _uniform(k_agents, big)
    scores = torch.where(eligible, u, torch.full_like(u, -1.0))
    # lax.top_k order: descending, ties to the lower index (stable sort).
    top_scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    agents_ok = (top_scores[:, :n] >= 0.0).all(dim=1)
    agent_cells = order[:, :n]

    free = components < big
    cell_ids = torch.arange(big, device=dev)
    used = torch.zeros(b, big, dtype=torch.bool, device=dev)
    targets = torch.zeros(b, n, dtype=torch.int64, device=dev)
    ok = agents_ok
    for i in range(n):
        a = agent_cells[:, i : i + 1]
        comp = components.gather(1, a)
        mask = free & (components == comp) & ~used & (cell_ids[None, :] != a)
        g = cuda_threefry.bits(cuda_threefry.fold_in(k_targets, i), (big,))
        sc = torch.where(mask, g, torch.zeros_like(g))
        c = torch.argmax(sc, dim=1, keepdim=True)  # first index of the max
        ok = ok & mask.gather(1, c)[:, 0]
        used = used | (cell_ids[None, :] == c)
        targets[:, i] = c[:, 0]
    return agent_cells, targets, ok
