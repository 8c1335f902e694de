"""Debug-mode invariant checks of an env state.

Counterpart of ``pogema_tpu/utils/validation.py``: the port's
``EnvState`` (tensors on any device) is read to numpy through
``interop.state_to_numpy`` and checked on the host. Test/debug only,
never on the step path.
"""

from __future__ import annotations

import numpy as np

from ..interop import state_to_numpy


def validate_state(cfg, state) -> list:
    """Returns a list of violation strings (empty = healthy). Checks the
    core invariants the reference guarantees: nobody on an obstacle, no
    two active agents on one cell, targets on free cells, coordinates in
    bounds, counters sane. ``cfg``: the core's ``StaticConfig``."""
    errors = []
    arrays = state_to_numpy(state)
    grid, xy, targ = arrays["obstacles"], arrays["agents_xy"], arrays["targets_xy"]
    active = arrays["active"]
    p = cfg.padded_size
    batch_shape = grid.shape[:-2]
    flat = int(np.prod(batch_shape)) if batch_shape else 1
    grid = grid.reshape(flat, p, p)
    xy = xy.reshape(flat, -1, 2)
    targ = targ.reshape(flat, -1, 2)
    active = active.reshape(flat, -1)

    for b in range(flat):
        if (xy[b] < 0).any() or (xy[b] >= p).any():
            errors.append(f"env {b}: agent out of bounds")
            continue
        if grid[b, xy[b, :, 0], xy[b, :, 1]].any():
            errors.append(f"env {b}: agent standing on an obstacle")
        if grid[b, targ[b, :, 0], targ[b, :, 1]].any():
            errors.append(f"env {b}: target on an obstacle")
        cells = [tuple(c) for c, a in zip(xy[b], active[b]) if a]
        if len(cells) != len(set(cells)):
            errors.append(f"env {b}: two active agents share a cell")
        r = cfg.obs_radius
        if (xy[b] < r).any() or (xy[b] >= p - r).any():
            errors.append(f"env {b}: agent inside the obstacle border")
    step = arrays["step_count"]
    if (step < 0).any() or (step > cfg.max_episode_steps).any():
        errors.append("step_count out of range")
    return errors
