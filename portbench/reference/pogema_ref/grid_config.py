"""Environment configuration of the reference.

A JAX-free copy of ``pogema_tpu/grid_config.py``: the pydantic
``GridConfig`` (same fields, defaults and validation) and the frozen
``StaticConfig`` it compiles to. It is a copy, not an import, because
importing ``pogema_tpu.grid_config`` runs ``pogema_tpu/__init__.py``,
which imports the JAX core.

Here ``StaticConfig`` is not a jit argument: it only carries the
shapes and branch choices (grid size, agents, radius, collision system,
``on_target``, observation type and layout) that the batched torch
functions read.
"""

from __future__ import annotations

import sys
from typing import Any, Optional

from pydantic import BaseModel, field_validator, model_validator

# Cell contents (upstream: pogema/grid_config.py).
FREE = 0
OBSTACLE = 1

# Action ids: 0=stay, 1=up, 2=down, 3=left, 4=right (row, col deltas).
# Upstream: pogema/grid_config.py MOVES.
MOVES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
NUM_ACTIONS = len(MOVES)

_COLLISION_SYSTEMS = ("priority", "block_both", "soft")
_ON_TARGETS = ("finish", "nothing", "restart")
_OBSERVATION_TYPES = ("default", "POMAPF", "MAPF")
_INTEGRATIONS = (None, "SampleFactory", "PyMARL", "rllib", "gymnasium", "PettingZoo")


class GridConfig(BaseModel, extra="forbid"):
    """Declarative env spec. Field names/defaults track the reference
    ``GridConfig`` (SURVEY.md §2, confidence HIGH on fields / MED on
    defaults); validation rules follow SURVEY.md §2 "Config".
    """

    seed: Optional[int] = None
    size: int = 8
    density: float = 0.3
    num_agents: int = 1
    obs_radius: int = 5
    agents_xy: Optional[list] = None
    targets_xy: Optional[list] = None
    collision_system: str = "priority"
    persistent: bool = False
    observation_type: str = "default"
    on_target: str = "finish"
    map: Optional[Any] = None
    map_name: Optional[str] = None
    integration: Optional[str] = None
    max_episode_steps: int = 64
    auto_reset: Optional[bool] = None

    # --- constants exposed as class attrs for API parity ---
    FREE: int = FREE
    OBSTACLE: int = OBSTACLE
    MOVES: tuple = MOVES

    @field_validator("size")
    @classmethod
    def _size_ok(cls, v):
        if not 2 <= v <= 8192:
            raise ValueError("size must be in [2, 8192]")
        return v

    @field_validator("density")
    @classmethod
    def _density_ok(cls, v):
        if not 0.0 <= v < 1.0:
            raise ValueError("density must be in [0, 1)")
        return v

    @field_validator("num_agents")
    @classmethod
    def _num_agents_ok(cls, v):
        if v < 1:
            raise ValueError("num_agents must be >= 1")
        return v

    @field_validator("obs_radius")
    @classmethod
    def _obs_radius_ok(cls, v):
        if v < 1:
            raise ValueError("obs_radius must be >= 1")
        return v

    @field_validator("max_episode_steps")
    @classmethod
    def _mes_ok(cls, v):
        if v < 1:
            raise ValueError("max_episode_steps must be >= 1")
        return v

    @field_validator("collision_system")
    @classmethod
    def _cs_ok(cls, v):
        if v not in _COLLISION_SYSTEMS:
            raise ValueError(f"collision_system must be one of {_COLLISION_SYSTEMS}")
        return v

    @field_validator("on_target")
    @classmethod
    def _ot_ok(cls, v):
        if v not in _ON_TARGETS:
            raise ValueError(f"on_target must be one of {_ON_TARGETS}")
        return v

    @field_validator("observation_type")
    @classmethod
    def _obs_type_ok(cls, v):
        if v not in _OBSERVATION_TYPES:
            raise ValueError(f"observation_type must be one of {_OBSERVATION_TYPES}")
        return v

    @field_validator("integration")
    @classmethod
    def _integration_ok(cls, v):
        if v not in _INTEGRATIONS:
            raise ValueError(f"integration must be one of {_INTEGRATIONS}")
        return v

    @model_validator(mode="after")
    def _finalize(self):
        # seed stays None when unset: the host rim then draws a fresh map
        # every reset (reference behavior); a fixed seed reproduces exactly.
        if self.map is None and self.map_name is not None:
            raise ValueError("the reference copy has no map registry: pass the map itself")
        if self.map is not None:
            grid, agents_xy, targets_xy = parse_map(self.map)
            object.__setattr__(self, "map", grid)
            if agents_xy and self.agents_xy is None:
                object.__setattr__(self, "agents_xy", agents_xy)
            if targets_xy and self.targets_xy is None:
                object.__setattr__(self, "targets_xy", targets_xy)
            if agents_xy and targets_xy:
                if len(agents_xy) != len(targets_xy):
                    raise ValueError("map defines unequal numbers of agents and targets")
                if self.num_agents == 1 and len(agents_xy) > 1:
                    object.__setattr__(self, "num_agents", len(agents_xy))
            size = max(len(self.map), max(len(r) for r in self.map))
            if size > self.size:
                object.__setattr__(self, "size", size)
        if (self.agents_xy is None) != (self.targets_xy is None):
            raise ValueError("agents_xy and targets_xy must be provided together")
        if self.agents_xy is not None:
            if len(self.agents_xy) != len(self.targets_xy):
                raise ValueError("agents_xy and targets_xy must have equal length")
            if self.num_agents == 1 and len(self.agents_xy) > 1:
                object.__setattr__(self, "num_agents", len(self.agents_xy))
            if len(self.agents_xy) < self.num_agents:
                raise ValueError("not enough agents_xy for num_agents")
        return self

    def to_static(self) -> "StaticConfig":
        return StaticConfig(
            size=self.size,
            density=self.density,
            num_agents=self.num_agents,
            obs_radius=self.obs_radius,
            collision_system=self.collision_system,
            on_target=self.on_target,
            observation_type=self.observation_type,
            max_episode_steps=self.max_episode_steps,
            has_fixed_map=self.map is not None,
            has_fixed_positions=self.agents_xy is not None,
        )


def parse_map(map_spec):
    """Parse a map given as a string or a list-of-lists.

    String format (upstream: pogema/grid_config.py map parsing, SURVEY.md §2):
    rows separated by newlines; ``.``/`` `` = free, ``#`` = obstacle,
    ``0``/``1`` also accepted; uppercase letters are agent starts and the
    matching lowercase letters their goals.

    Returns (grid: list[list[int]], agents_xy: list, targets_xy: list).
    """
    agents: dict = {}
    targets: dict = {}
    if isinstance(map_spec, str):
        rows = [r for r in map_spec.split("\n") if r.strip()]
        grid = []
        for i, row in enumerate(rows):
            row = row.strip()
            line = []
            for j, ch in enumerate(row.split() if " " in row else row):
                if ch in (".", "0"):
                    line.append(FREE)
                elif ch in ("#", "!", "@", "1"):
                    line.append(OBSTACLE)
                elif ch.isalpha() and ch.isupper():
                    agents[ch.lower()] = (i, j)
                    line.append(FREE)
                elif ch.isalpha():
                    targets[ch] = (i, j)
                    line.append(FREE)
                else:
                    raise ValueError(f"unsupported map character {ch!r}")
            grid.append(line)
    else:
        grid = [[int(bool(c)) for c in row] for row in map_spec]
    width = max(len(r) for r in grid) if grid else 0
    for r in grid:
        r.extend([FREE] * (width - len(r)))
    keys = sorted(set(agents) & set(targets))
    if set(agents) != set(targets):
        missing = set(agents) ^ set(targets)
        if missing:
            raise ValueError(f"unmatched agent/goal letters in map: {sorted(missing)}")
    agents_xy = [list(agents[k]) for k in keys]
    targets_xy = [list(targets[k]) for k in keys]
    return grid, agents_xy, targets_xy


class StaticConfig:
    """Frozen, hashable subset of :class:`GridConfig`: the shapes and
    branch structure the batched core functions read. Dynamic data
    (keys, fixed maps / positions) flows through tensors instead.
    """

    __slots__ = (
        "size",
        "density",
        "num_agents",
        "obs_radius",
        "collision_system",
        "on_target",
        "observation_type",
        "max_episode_steps",
        "has_fixed_map",
        "has_fixed_positions",
        "obs_layout",
    )

    def __init__(
        self,
        size,
        density,
        num_agents,
        obs_radius,
        collision_system,
        on_target,
        observation_type,
        max_episode_steps,
        has_fixed_map=False,
        has_fixed_positions=False,
        obs_layout="grid",
    ):
        object.__setattr__(self, "size", int(size))
        object.__setattr__(self, "density", float(density))
        object.__setattr__(self, "num_agents", int(num_agents))
        object.__setattr__(self, "obs_radius", int(obs_radius))
        object.__setattr__(self, "collision_system", str(collision_system))
        object.__setattr__(self, "on_target", str(on_target))
        object.__setattr__(self, "observation_type", str(observation_type))
        object.__setattr__(self, "max_episode_steps", int(max_episode_steps))
        object.__setattr__(self, "has_fixed_map", bool(has_fixed_map))
        object.__setattr__(self, "has_fixed_positions", bool(has_fixed_positions))
        # Engine-side option, not a reference GridConfig field: 'grid'
        # keeps the reference obs shape [N, 3, W, W]; 'packed' flattens
        # to [N, 3*W*W] (channel blocks back to back), the layout an
        # external learner's embedding matmul reads directly (set via
        # PogemaCore(obs_layout=...)).
        if obs_layout not in ("grid", "packed"):
            raise ValueError(f"obs_layout must be 'grid' or 'packed', got {obs_layout!r}")
        object.__setattr__(self, "obs_layout", str(obs_layout))

    # Padded grid geometry: the obstacle border of width obs_radius on all
    # sides is the reference's key trick (upstream: pogema/grid.py) — window
    # slicing never leaves the array and out-of-bounds is "obstacle".
    @property
    def padded_size(self) -> int:
        return self.size + 2 * self.obs_radius

    @property
    def window(self) -> int:
        return 2 * self.obs_radius + 1

    def _key(self):
        return tuple(getattr(self, s) for s in self.__slots__)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, StaticConfig) and self._key() == other._key()

    def __setattr__(self, *_):
        raise AttributeError("StaticConfig is frozen")

    def __repr__(self):
        kv = ", ".join(f"{s}={getattr(self, s)!r}" for s in self.__slots__)
        return f"StaticConfig({kv})"


def _module_sanity():  # pragma: no cover
    assert len(MOVES) == NUM_ACTIONS


_module_sanity()
