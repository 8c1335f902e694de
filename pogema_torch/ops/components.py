"""4-connected component labels in plain PyTorch: the plain version of K4.

Counterpart of ``pogema_tpu/core/generator.py``'s ``connected_components``
(a ``lax.while_loop`` of segmented scans, not a Pallas kernel): a
min-label flood fill by segmented running minima along rows and columns,
iterated to the fixpoint. Labels are the minimum flat index of each
component. It is what ``ops/cuda_components.py`` returns for tensors on
the CPU, and what the card's kernel is held against. Each sweep syncs the
host once; ``connected_components.sweeps`` counts the sweeps.
"""

from __future__ import annotations

import torch


def _segmented_min_scan(vals, boundary, dim: int, reverse: bool):
    """Running minimum along ``dim`` of [B, P, P], reset at boundary
    cells, by the encoding w = seg * K + (K-1 - v) under a running max
    (seg only grows along the direction, so the max comes from the
    current segment, and maximising K-1-v minimises v)."""
    p = vals.shape[-1]
    big = p * p
    k = big + 2
    if reverse:
        vals, boundary = vals.flip(dim), boundary.flip(dim)
    seg = torch.cumsum(boundary.long(), dim=dim)
    w = seg * k + (k - 1 - vals.clamp(max=k - 1))
    w = torch.cummax(w, dim=dim).values
    out = ((k - 1) - (w - seg * k)).clamp(max=big)
    return out.flip(dim) if reverse else out


def connected_components(padded_grid) -> torch.Tensor:
    """i64[B, P*P]: for free cells the minimum flat index of their
    4-connected component; P*P for obstacles (any nonzero cell of the
    [B, P, P] grid). Each sweep syncs the host once;
    ``connected_components.sweeps`` counts them."""
    b, p, _ = padded_grid.shape
    big = p * p
    obstacle = padded_grid.bool()
    ids = torch.arange(big, device=padded_grid.device).reshape(1, p, p)
    labels = torch.where(obstacle, torch.full_like(ids, big), ids)

    def sweep(lab):
        lab = _segmented_min_scan(lab, obstacle, 2, False)
        lab = _segmented_min_scan(lab, obstacle, 2, True)
        lab = _segmented_min_scan(lab, obstacle, 1, False)
        return _segmented_min_scan(lab, obstacle, 1, True)

    for _ in range(big):
        nxt = sweep(labels)
        connected_components.sweeps += 1
        if torch.equal(nxt, labels):
            break
        labels = nxt
    return torch.where(obstacle, big, labels).reshape(b, big)


connected_components.sweeps = 0
