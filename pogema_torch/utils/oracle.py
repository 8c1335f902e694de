"""Trusted slow NumPy oracle of the environment semantics.

Counterpart of ``pogema_tpu/utils/oracle.py``, copied so that the port
holds itself to its own oracle without JAX: a direct, loop-based
transcription of the documented behavior (upstream: pogema/envs.py +
pogema/grid.py), kept deliberately naive so it is easy to audit. Tests
drive the port's core and this oracle with identical states/actions and
require identical positions, rewards, flags and observations.

NOT on any hot path — test-only.
"""

from __future__ import annotations

import numpy as np

from ..grid_config import MOVES, StaticConfig


class OracleEnv:
    """One env instance, state injected (not generated)."""

    def __init__(self, cfg: StaticConfig, obstacles_padded, agents_xy, targets_xy,
                 active=None, step_count=0):
        self.cfg = cfg
        self.grid = np.asarray(obstacles_padded, np.uint8).copy()
        self.agents_xy = [tuple(map(int, xy)) for xy in np.asarray(agents_xy)]
        self.targets_xy = [tuple(map(int, xy)) for xy in np.asarray(targets_xy)]
        n = cfg.num_agents
        self.active = list(active) if active is not None else [True] * n
        self.terminated = [False] * n
        self.on_goal_ever = [False] * n
        self.goals_achieved = [0] * n
        self.step_count = int(step_count)

    # -- movement -------------------------------------------------------

    def _proposed(self, actions):
        out = []
        for i, a in enumerate(actions):
            dx, dy = MOVES[int(a)]
            x, y = self.agents_xy[i]
            tx, ty = x + dx, y + dy
            if not self.active[i] or self.grid[tx, ty]:
                out.append((x, y))
            else:
                out.append((tx, ty))
        return out

    def _move_priority(self, actions):
        occupied = {xy for i, xy in enumerate(self.agents_xy) if self.active[i]}
        new_xy = list(self.agents_xy)
        for i in range(len(new_xy)):
            if not self.active[i]:
                continue
            dx, dy = MOVES[int(actions[i])]
            x, y = new_xy[i]
            t = (x + dx, y + dy)
            if t != (x, y) and not self.grid[t] and t not in occupied:
                occupied.discard((x, y))
                occupied.add(t)
                new_xy[i] = t
        return new_xy

    def _move_block_both(self, actions):
        desired = self._proposed(actions)
        cur_cells = {xy for i, xy in enumerate(self.agents_xy) if self.active[i]}
        counts: dict = {}
        for i, d in enumerate(desired):
            if self.active[i]:
                counts[d] = counts.get(d, 0) + 1
        new_xy = list(self.agents_xy)
        for i, d in enumerate(desired):
            if not self.active[i] or d == self.agents_xy[i]:
                continue
            if d in cur_cells or counts[d] > 1:
                continue
            new_xy[i] = d
        return new_xy

    def _move_soft(self, actions):
        desired = self._proposed(actions)
        n = len(desired)
        moving = [
            self.active[i] and desired[i] != self.agents_xy[i] for i in range(n)
        ]
        # vertex conflicts among movers
        counts: dict = {}
        for i in range(n):
            if moving[i]:
                counts[desired[i]] = counts.get(desired[i], 0) + 1
        for i in range(n):
            if moving[i] and counts[desired[i]] > 1:
                moving[i] = False
        # swaps
        pos_of = {xy: i for i, xy in enumerate(self.agents_xy) if self.active[i]}
        for i in range(n):
            if not moving[i]:
                continue
            j = pos_of.get(desired[i])
            if j is not None and j != i and desired[j] == self.agents_xy[i]:
                moving[i] = False
        # chains: blocked movers become stayers and may block others
        changed = True
        while changed:
            changed = False
            stay_cells = {
                self.agents_xy[i] for i in range(n) if self.active[i] and not moving[i]
            }
            for i in range(n):
                if moving[i] and desired[i] in stay_cells:
                    moving[i] = False
                    changed = True
        return [desired[i] if moving[i] else self.agents_xy[i] for i in range(n)]

    # -- step -----------------------------------------------------------

    def step(self, actions):
        cfg = self.cfg
        mover = {
            "priority": self._move_priority,
            "block_both": self._move_block_both,
            "soft": self._move_soft,
        }[cfg.collision_system]
        new_xy = mover(actions)
        n = cfg.num_agents
        on_goal = [
            self.active[i] and new_xy[i] == self.targets_xy[i] for i in range(n)
        ]
        rewards = [0.0] * n
        self.agents_xy = new_xy
        for i in range(n):
            if on_goal[i]:
                self.goals_achieved[i] += 1
                self.on_goal_ever[i] = True
        if cfg.on_target == "finish":
            for i in range(n):
                if on_goal[i]:
                    rewards[i] = 1.0
                    self.terminated[i] = True
                    self.active[i] = False
        elif cfg.on_target == "nothing":
            all_on = all(
                self.agents_xy[i] == self.targets_xy[i] for i in range(n)
            )
            self.terminated = [all_on] * n
        else:  # restart — respawn handled by caller (RNG engine differs)
            for i in range(n):
                if on_goal[i]:
                    rewards[i] = 1.0
        self.step_count += 1
        truncated = [self.step_count >= cfg.max_episode_steps] * n
        return rewards, list(self.terminated), truncated, on_goal

    # -- observations ---------------------------------------------------

    def observe(self):
        cfg = self.cfg
        r, w, n = cfg.obs_radius, cfg.window, cfg.num_agents
        occ = np.zeros_like(self.grid)
        for i, (x, y) in enumerate(self.agents_xy):
            if self.active[i]:
                occ[x, y] = 1
        obs = np.zeros((n, 3, w, w), np.float32)
        for i, (x, y) in enumerate(self.agents_xy):
            obs[i, 0] = self.grid[x - r : x + r + 1, y - r : y + r + 1]
            obs[i, 1] = occ[x - r : x + r + 1, y - r : y + r + 1]
            tx, ty = self.targets_xy[i]
            rx = min(max(tx - x, -r), r) + r
            ry = min(max(ty - y, -r), r) + r
            obs[i, 2, rx, ry] = 1.0
        return obs
