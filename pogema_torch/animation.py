"""SVG episode animation (upstream: pogema/animation.py), the counterpart
of ``pogema_tpu/animation.py``: ``AnimationMonitor`` wraps an env,
records the episode via
:class:`~pogema_torch.wrappers.persistence.PersistentWrapper`, and renders
an animated SVG (SMIL ``<animate>`` timelines) — obstacles as rounded
rects, agents as colored circles, goals as hollow circles, optional
egocentric masking of one agent's field of view, optional static frame.

Pure host-side tooling; minimal hand-rolled SVG primitives, no external
SVG dependency (like the reference). Gymnasium's ``Wrapper`` comes
through ``utils/gym_compat.py``, so the monitor runs where gymnasium is
not installed."""

from __future__ import annotations

import os
from itertools import cycle
from typing import Optional

from pydantic import BaseModel

from .utils.gym_compat import Wrapper
from .wrappers.persistence import PersistentWrapper


class AnimationConfig(BaseModel):
    """Mirrors the reference AnimationConfig fields (SURVEY.md §2, MED).

    ``show_border`` draws the grid's surrounding obstacle ring (the
    reference grid is border-padded; the ring is its visual stand-in) —
    the canvas grows by one cell per side. ``uid`` namespaces the SVG:
    the root group gets ``id="{uid}"`` (so several animations can be
    inlined in one HTML page) and auto-saved files are named
    ``{uid}_{episode}.svg``."""

    directory: str = "renders"
    static: bool = False
    show_agents: bool = True
    show_targets: bool = True
    show_lines: bool = False
    show_border: bool = True
    egocentric_idx: Optional[int] = None
    save_every_idx_episode: Optional[int] = 1
    uid: Optional[str] = None


# Scale: one grid cell = _CELL px; visual sizes relative to the cell.
_CELL = 35
_RADIUS = 0.35  # agent circle radius in cells
_COLORS = ["#c1433c", "#2e6f9e", "#6e81af", "#00b9c8", "#72D5C8", "#0ea08c", "#8F7B66"]


class _Tag:
    name = "g"

    def __init__(self, **attrs):
        self.attrs = attrs
        self.children = []
        self.animations = []

    def render(self) -> str:
        attrs = " ".join(
            f'{k.replace("_", "-")}="{v}"' for k, v in self.attrs.items() if v is not None
        )
        inner = "".join(c.render() for c in self.children) + "".join(
            a.render() for a in self.animations
        )
        if inner:
            return f"<{self.name} {attrs}>{inner}</{self.name}>"
        return f"<{self.name} {attrs}/>"


class Rect(_Tag):
    name = "rect"


class Circle(_Tag):
    name = "circle"


class Line(_Tag):
    name = "line"


class Animation(_Tag):
    name = "animate"


class Drawing:
    def __init__(self, width, height, uid: Optional[str] = None):
        self.width = width
        self.height = height
        self.uid = uid
        self.elements = []

    def render(self) -> str:
        body = "".join(e.render() for e in self.elements)
        if self.uid is not None:
            body = f'<g id="{self.uid}">{body}</g>'
        return (
            f'<svg xmlns="http://www.w3.org/2000/svg" '
            f'width="{self.width}" height="{self.height}" '
            f'viewBox="0 0 {self.width} {self.height}">'
            f'<rect width="100%" height="100%" fill="white"/>'
            f"{body}</svg>"
        )


class AnimationMonitor(Wrapper):
    """Wrap a pogema env; saves an SVG per episode (every
    ``save_every_idx_episode``-th) into ``animation_config.directory``
    and on demand via :meth:`save_animation`."""

    def __init__(self, env, animation_config: AnimationConfig = None):
        self._persistence = PersistentWrapper(env)
        super().__init__(self._persistence)
        self.animation_config = animation_config or AnimationConfig()
        self._episode_idx = 0
        self._finished = False

    def step(self, actions):
        obs, rew, term, trunc, infos = self.env.step(actions)
        if all(t or tr for t, tr in zip(term, trunc)) and not self._finished:
            self._finished = True
            cfg = self.animation_config
            every = cfg.save_every_idx_episode
            if every and (self._episode_idx % every == 0):
                os.makedirs(cfg.directory, exist_ok=True)
                stem = f"{cfg.uid}_" if cfg.uid else ""
                name = f"{stem}{self._episode_idx}.svg"
                self.save_animation(os.path.join(cfg.directory, name), cfg)
        return obs, rew, term, trunc, infos

    def reset(self, **kwargs):
        out = self.env.reset(**kwargs)
        self._episode_idx += 1
        self._finished = False
        return out

    # -- rendering -------------------------------------------------------

    def create_animation(self, animation_config: AnimationConfig = None) -> Drawing:
        cfg = animation_config or self.animation_config
        obstacles = self._persistence.get_obstacles()
        history = self._persistence.get_history()
        if obstacles is None or not history:
            raise RuntimeError("no episode recorded yet — reset() and step() first")
        s = len(obstacles)
        steps = len(history)
        n = len(history[0])
        gc = getattr(self.env.unwrapped, "grid_config", None)
        r = gc.obs_radius if gc is not None else 5

        # show_border: one ring of obstacle cells around the recorded
        # grid (the grid core is border-padded; this is the drawn stand-in).
        pad = 1 if cfg.show_border else 0
        d = Drawing(width=_CELL * (s + 2 * pad), height=_CELL * (s + 2 * pad),
                    uid=cfg.uid)
        dur = max(steps * 0.25, 0.25)

        def cx(y):  # svg x from grid col
            return (y + pad) * _CELL + _CELL // 2

        def cy(x):  # svg y from grid row
            return (x + pad) * _CELL + _CELL // 2

        ego = cfg.egocentric_idx

        def visible(step_idx, x, y):
            snap = history[min(step_idx, steps - 1)][ego]
            return abs(snap.x - x) <= r and abs(snap.y - y) <= r

        def obstacle_rect(x, y):
            rect = Rect(
                x=(y + pad) * _CELL + 1,
                y=(x + pad) * _CELL + 1,
                width=_CELL - 2,
                height=_CELL - 2,
                rx=5,
                fill="#84A1AE",
            )
            if ego is not None and not cfg.static:
                vals = ";".join(
                    "1.0" if visible(t, x, y) else "0.4" for t in range(steps)
                )
                rect.animations.append(
                    Animation(
                        attributeName="opacity",
                        values=vals,
                        dur=f"{dur}s",
                        repeatCount="indefinite",
                    )
                )
            d.elements.append(rect)

        # border ring
        if pad:
            for y in range(-1, s + 1):
                obstacle_rect(-1, y)
                obstacle_rect(s, y)
            for x in range(s):
                obstacle_rect(x, -1)
                obstacle_rect(x, s)

        # obstacles
        for x in range(s):
            for y in range(s):
                if obstacles[x][y]:
                    obstacle_rect(x, y)

        color_iter = cycle(_COLORS)
        colors = [next(color_iter) for _ in range(n)]

        # agent -> goal guide lines (the reference's show_lines flag,
        # SURVEY.md §2 "Animation": show_agents/lines/border). Drawn under
        # agents/goals; animated alongside them, fading out when the agent
        # deactivates.
        if cfg.show_lines:
            for i in range(n):
                if ego is not None and i != ego:
                    continue
                h0 = history[0][i]
                line = Line(
                    x1=cx(h0.y), y1=cy(h0.x),
                    x2=cx(h0.ty), y2=cy(h0.tx),
                    stroke=colors[i], stroke_width=2,
                    stroke_dasharray="4,4", opacity=0.6,
                )
                if not cfg.static:
                    for attr, vals in (
                        ("x1", ";".join(str(cx(h[i].y)) for h in history)),
                        ("y1", ";".join(str(cy(h[i].x)) for h in history)),
                        ("x2", ";".join(str(cx(h[i].ty)) for h in history)),
                        ("y2", ";".join(str(cy(h[i].tx)) for h in history)),
                        ("opacity", ";".join(
                            "0.6" if h[i].active else "0.0" for h in history)),
                    ):
                        line.animations.append(
                            Animation(attributeName=attr, values=vals,
                                      dur=f"{dur}s", repeatCount="indefinite")
                        )
                d.elements.append(line)

        # goal markers
        if cfg.show_targets:
            for i in range(n):
                if ego is not None and i != ego:
                    continue
                last = history[-1][i]
                circle = Circle(
                    cx=cx(history[0][i].ty),
                    cy=cy(history[0][i].tx),
                    r=int(_RADIUS * _CELL),
                    stroke=colors[i],
                    stroke_width=2,
                    fill="none",
                )
                if not cfg.static:
                    xs = ";".join(str(cx(h[i].ty)) for h in history)
                    ys = ";".join(str(cy(h[i].tx)) for h in history)
                    circle.animations.append(
                        Animation(attributeName="cx", values=xs, dur=f"{dur}s",
                                  repeatCount="indefinite")
                    )
                    circle.animations.append(
                        Animation(attributeName="cy", values=ys, dur=f"{dur}s",
                                  repeatCount="indefinite")
                    )
                del last
                d.elements.append(circle)

        # agents
        if cfg.show_agents:
            for i in range(n):
                h0 = history[0][i]
                circle = Circle(
                    cx=cx(h0.y),
                    cy=cy(h0.x),
                    r=int(_RADIUS * _CELL),
                    fill=colors[i],
                )
                if not cfg.static:
                    xs = ";".join(str(cx(h[i].y)) for h in history)
                    ys = ";".join(str(cy(h[i].x)) for h in history)

                    def agent_opacity(t):
                        if not history[t][i].active:
                            return "0.0"
                        if ego is not None and i != ego:
                            # grey out agents outside the ego agent's view
                            s_ego = history[t][ego]
                            s_me = history[t][i]
                            if (abs(s_ego.x - s_me.x) > r
                                    or abs(s_ego.y - s_me.y) > r):
                                return "0.2"
                        return "1.0"

                    ops = ";".join(agent_opacity(t) for t in range(steps))
                    for attr, vals in (("cx", xs), ("cy", ys), ("opacity", ops)):
                        circle.animations.append(
                            Animation(attributeName=attr, values=vals,
                                      dur=f"{dur}s", repeatCount="indefinite")
                        )
                d.elements.append(circle)

        return d

    def save_animation(self, name: str = "render.svg",
                       animation_config: AnimationConfig = None):
        drawing = self.create_animation(animation_config)
        parent = os.path.dirname(name)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(name, "w") as f:
            f.write(drawing.render())
        return name
