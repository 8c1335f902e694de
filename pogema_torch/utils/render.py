"""ANSI console rendering (upstream: pogema/envs.py render()); a copy of
``pogema_tpu/utils/render.py``."""

from __future__ import annotations


def render_ansi(obstacles, agents_xy, targets_xy, active) -> str:
    """obstacles: u8[S, S] (unpadded); agents/targets: logical coords."""
    s = obstacles.shape[0]
    rows = [["#" if obstacles[x][y] else "." for y in range(s)] for x in range(s)]
    for i, (x, y) in enumerate(targets_xy):
        if 0 <= x < s and 0 <= y < s:
            rows[x][y] = chr(ord("a") + i % 26)
    for i, (x, y) in enumerate(agents_xy):
        if active[i] and 0 <= x < s and 0 <= y < s:
            rows[x][y] = chr(ord("A") + i % 26)
    return "\n".join(" ".join(r) for r in rows)
