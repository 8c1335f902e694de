"""A copy of ``pogema_tpu/a_star_policy.py`` (numpy and ``heapq`` only),
kept so that the port never imports the JAX package.

Scripted decentralized A* baseline (upstream: pogema/a_star_policy.py,
SURVEY.md §2 "A* baseline policy", §3.4 call stack).

Per agent: accumulate seen obstacles across steps in a persistent memory,
run A* (heapq, Manhattan heuristic, 4-neighborhood) from the current
position to the (possibly projected) goal, emit the action toward the
first path cell; stay when no path exists.

Works with both observation formats:
* 'POMAPF'/'MAPF' dict obs ({'obstacles', 'xy', 'target_xy'}): global
  coordinates allow a true persistent obstacle memory (reference
  behavior);
* 'default' 3-channel tensor obs: no global frame is available, so the
  agent plans inside the egocentric window toward the projected target
  cell (channel 2) each step.

Host-side tool — used by tests and benchmarks, not on the device path.
"""

from __future__ import annotations

import heapq

import numpy as np

from .grid_config import MOVES

_INV_MOVES = {m: i for i, m in enumerate(MOVES)}


class Node:
    """Search node (upstream exposes the same tiny class)."""

    __slots__ = ("g", "h", "xy", "parent")

    def __init__(self, xy, g=0, h=0, parent=None):
        self.xy = xy
        self.g = g
        self.h = h
        self.parent = parent

    @property
    def f(self):
        return self.g + self.h

    def __lt__(self, other):
        return (self.f, self.h) < (other.f, other.h)


def _manhattan(a, b):
    return abs(a[0] - b[0]) + abs(a[1] - b[1])


def a_star(start, goal, is_blocked, max_expansions: int = 10000):
    """Returns the next cell on a shortest path start->goal, or None.
    ``is_blocked(xy)`` answers from the agent's obstacle knowledge;
    unknown cells count as free (optimistic, like the reference)."""
    start = tuple(start)
    goal = tuple(goal)
    if start == goal:
        return None
    open_heap = [Node(start, 0, _manhattan(start, goal))]
    best_g = {start: 0}
    closed = set()
    expansions = 0
    best_node = open_heap[0]
    while open_heap and expansions < max_expansions:
        node = heapq.heappop(open_heap)
        if node.xy in closed:
            continue
        closed.add(node.xy)
        expansions += 1
        if node.h < best_node.h:
            best_node = node
        if node.xy == goal:
            best_node = node
            break
        for dx, dy in MOVES[1:]:
            nxt = (node.xy[0] + dx, node.xy[1] + dy)
            if is_blocked(nxt):
                continue
            g = node.g + 1
            if g < best_g.get(nxt, 1 << 30):
                best_g[nxt] = g
                heapq.heappush(
                    open_heap, Node(nxt, g, _manhattan(nxt, goal), node)
                )
    # Walk back to the first step from start (toward goal, or toward the
    # closest reachable cell when the goal was not reached).
    node = best_node
    if node.xy == start:
        return None
    while node.parent is not None and node.parent.xy != start:
        node = node.parent
    return node.xy


class AStarAgent:
    """One agent's policy with persistent obstacle memory."""

    def __init__(self, seed: int = 0):
        self._memory: dict = {}
        self._rng = np.random.default_rng(seed)

    def reset(self):
        self._memory.clear()

    # -- obs ingestion ---------------------------------------------------

    def _update_memory(self, obstacles_window, xy):
        w = obstacles_window.shape[0]
        r = w // 2
        ox, oy = int(xy[0]) - r, int(xy[1]) - r
        for i in range(w):
            for j in range(w):
                self._memory[(ox + i, oy + j)] = bool(obstacles_window[i, j] > 0.5)

    def act(self, obs) -> int:
        if isinstance(obs, dict):
            window = np.asarray(obs["obstacles"])
            xy = tuple(int(v) for v in np.asarray(obs["xy"]))
            target = tuple(int(v) for v in np.asarray(obs["target_xy"]))
            self._update_memory(window, xy)
            mem = self._memory

            def is_blocked(c):
                return mem.get(c, False)

            nxt = a_star(xy, target, is_blocked)
        else:
            o = np.asarray(obs)
            window = o[0]
            w = window.shape[0]
            r = w // 2
            xy = (r, r)
            targets = np.argwhere(o[2] > 0.5)
            if len(targets) == 0:
                return 0
            target = tuple(int(v) for v in targets[0])

            def is_blocked(c):
                if not (0 <= c[0] < w and 0 <= c[1] < w):
                    return True
                return window[c] > 0.5

            nxt = a_star(xy, target, is_blocked)
        if nxt is None:
            return 0
        delta = (nxt[0] - xy[0], nxt[1] - xy[1])
        return _INV_MOVES.get(delta, 0)


class BatchAStarAgent:
    """One ``AStarAgent`` per agent; maps a list of observations to a
    list of actions (upstream: pogema/a_star_policy.py)."""

    def __init__(self, seed: int = 0):
        self._seed = seed
        self.astar_agents: dict = {}

    def act(self, observations) -> list:
        actions = []
        for i, obs in enumerate(observations):
            if i not in self.astar_agents:
                self.astar_agents[i] = AStarAgent(self._seed + i)
            actions.append(self.astar_agents[i].act(obs))
        return actions

    def reset_states(self):
        self.astar_agents.clear()
