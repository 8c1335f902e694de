"""Episode history recording and deterministic replay (upstream:
pogema/wrappers/persistence.py, SURVEY.md §2 "Persistence").

``PersistentWrapper`` records a compact per-step snapshot of every
agent's state; the history can be serialized (``compact``/``decompact``)
and replayed to reconstruct the episode — this is what the SVG animation
consumes."""

from __future__ import annotations

from dataclasses import asdict, dataclass

from ..utils.gym_compat import Wrapper


@dataclass
class AgentState:
    x: int
    y: int
    tx: int
    ty: int
    active: bool
    step: int

    def get_xy(self):
        return self.x, self.y

    def get_target_xy(self):
        return self.tx, self.ty

    def is_active(self):
        return self.active


class PersistentWrapper(Wrapper):
    def __init__(self, env, xy_offset: int = 0):
        """``xy_offset`` is added to recorded coordinates (the reference
        records border-padded coordinates; we record logical ones by
        default and let the consumer choose)."""
        super().__init__(env)
        self._offset = xy_offset
        self._history: list[list[AgentState]] = []
        self._obstacles = None

    # -- recording -------------------------------------------------------

    def _snapshot(self, step: int):
        env = self.env.unwrapped
        agents = env.get_agents_xy()
        targets = env.get_targets_xy()
        active = env.active
        return [
            AgentState(
                x=a[0] + self._offset,
                y=a[1] + self._offset,
                tx=t[0] + self._offset,
                ty=t[1] + self._offset,
                active=bool(active[i]),
                step=step,
            )
            for i, (a, t) in enumerate(zip(agents, targets))
        ]

    def reset(self, **kwargs):
        out = self.env.reset(**kwargs)
        env = self.env.unwrapped
        self._obstacles = env.get_obstacles()
        self._history = [self._snapshot(0)]
        return out

    def step(self, actions):
        out = self.env.step(actions)
        self._history.append(self._snapshot(len(self._history)))
        return out

    # -- access / serialization -----------------------------------------

    def get_obstacles(self, **kwargs):
        return self._obstacles

    # gymnasium 1.x removed implicit attribute forwarding; keep the
    # reference Grid accessors reachable through the wrapper.
    def get_agents_xy(self, **kwargs):
        return self.env.unwrapped.get_agents_xy(**kwargs)

    def get_targets_xy(self, **kwargs):
        return self.env.unwrapped.get_targets_xy(**kwargs)

    @property
    def active(self):
        return self.env.unwrapped.active

    def get_history(self):
        return self._history

    def get_full_history(self):
        """Per-agent trajectories: list over agents of list over steps."""
        if not self._history:
            return []
        n = len(self._history[0])
        return [[snap[i] for snap in self._history] for i in range(n)]

    @staticmethod
    def compact(history) -> list:
        return [[asdict(s) for s in snap] for snap in history]

    @staticmethod
    def decompact(data) -> list:
        return [[AgentState(**d) for d in snap] for snap in data]
