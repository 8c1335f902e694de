"""Metric wrappers (upstream: pogema/wrappers/metrics.py, SURVEY.md §2
"Metrics wrappers"): host-side parity classes that inject
``info['metrics']`` for every agent at episode end.

Definitions (they match the POGEMA papers and the on-device
``core.metrics``):

* ISR — fraction of agents that reached their goal (disappear modes:
  ever; non-disappear: standing on it at episode end);
* CSR — 1.0 iff all agents reached;
* ep_length — steps to episode end;
* avg_throughput — LifeLong: goals achieved per step (summed over agents).

The port's rim computes these on the device already; these wrappers
recompute from the host-visible step stream, so they can wrap any
multi-agent list-convention env (and double as an independent check of
the device values in tests).
"""

from __future__ import annotations

import time

from ..utils.gym_compat import Wrapper


class AbstractMetric(Wrapper):
    """Base: accumulate over the episode; on the step the episode ends,
    write ``info['metrics'][self.name] = value`` into every agent info."""

    name = "abstract"

    def __init__(self, env):
        super().__init__(env)
        self._reset_state()

    # -- overridables ----------------------------------------------------

    def _reset_state(self):
        pass

    def _accumulate(self, obs, rewards, terminated, truncated, infos):
        pass

    def _value(self):
        raise NotImplementedError

    # -- plumbing --------------------------------------------------------

    def reset(self, **kwargs):
        self._reset_state()
        return self.env.reset(**kwargs)

    def step(self, actions):
        obs, rewards, terminated, truncated, infos = self.env.step(actions)
        self._accumulate(obs, rewards, terminated, truncated, infos)
        if all(t or tr for t, tr in zip(terminated, truncated)):
            value = self._value()
            if value is not None:
                for info in infos:
                    info.setdefault("metrics", {})[self.name] = value
        return obs, rewards, terminated, truncated, infos


class ISRMetric(AbstractMetric):
    """Individual success rate for disappear ('finish') mode: an agent
    succeeds when its terminated flag first turns True.

    Meaningless under LifeLong ('restart': terminated never fires) — the
    reference gates wrapper choice by mode, so this wrapper declines to
    emit there (warns once, injects nothing) instead of silently
    reporting ISR=0; use LifeLongAverageThroughputMetric."""

    name = "ISR"

    def _reset_state(self):
        self._succeeded = None
        self._warned = False

    def _wrong_mode(self):
        gc = getattr(self.env.unwrapped, "grid_config", None)
        return gc is not None and gc.on_target == "restart"

    def _accumulate(self, obs, rewards, terminated, truncated, infos):
        if self._succeeded is None:
            self._succeeded = [False] * len(terminated)
        for i, t in enumerate(terminated):
            self._succeeded[i] = self._succeeded[i] or bool(t)

    def _value(self):
        if self._wrong_mode():
            if not self._warned:
                import warnings

                warnings.warn(
                    f"{type(self).__name__} is undefined under "
                    "on_target='restart' (LifeLong) — no metric emitted; "
                    "use LifeLongAverageThroughputMetric",
                    stacklevel=3,
                )
                self._warned = True
            return None
        return float(sum(self._succeeded)) / len(self._succeeded)


class CSRMetric(ISRMetric):
    name = "CSR"

    def _value(self):
        if self._wrong_mode():
            return super()._value()  # warn-once + None
        return float(all(self._succeeded))


class EpLengthMetric(AbstractMetric):
    name = "ep_length"

    def _reset_state(self):
        self._steps = 0

    def _accumulate(self, *a):
        self._steps += 1

    def _value(self):
        return float(self._steps)


class LifeLongAverageThroughputMetric(AbstractMetric):
    """LifeLong: each reward of 1.0 is a goal reached; throughput =
    total goals / episode length."""

    name = "avg_throughput"

    def _reset_state(self):
        self._goals = 0.0
        self._steps = 0

    def _accumulate(self, obs, rewards, terminated, truncated, infos):
        self._goals += float(sum(rewards))
        self._steps += 1

    def _value(self):
        return self._goals / max(self._steps, 1)


class LifeLongAttritionMetric(AbstractMetric):
    """LifeLong: mean goals per agent over the episode."""

    name = "attrition"

    def _reset_state(self):
        self._goals = None
        self._steps = 0

    def _accumulate(self, obs, rewards, terminated, truncated, infos):
        if self._goals is None:
            self._goals = [0.0] * len(rewards)
        for i, r in enumerate(rewards):
            self._goals[i] += float(r)
        self._steps += 1

    def _value(self):
        return sum(self._goals) / len(self._goals)


class _NonDisappearBase(AbstractMetric):
    """Non-disappear modes ('nothing'): success = standing on the goal at
    episode end, read through the env's position accessors."""

    def _on_goal_now(self):
        env = self.env.unwrapped if hasattr(self.env, "unwrapped") else self.env
        agents = env.get_agents_xy()
        targets = env.get_targets_xy()
        return [a == t for a, t in zip(agents, targets)]


class NonDisappearISRMetric(_NonDisappearBase):
    name = "ISR"

    def _value(self):
        on_goal = self._on_goal_now()
        return float(sum(on_goal)) / len(on_goal)


class NonDisappearCSRMetric(_NonDisappearBase):
    name = "CSR"

    def _value(self):
        return float(all(self._on_goal_now()))


class NonDisappearEpLengthMetric(EpLengthMetric):
    pass


class RuntimeMetricWrapper(AbstractMetric):
    """Wall-clock seconds per episode (upstream's runtime wrapper)."""

    name = "runtime"

    def _reset_state(self):
        self._t0 = time.monotonic()

    def _value(self):
        return time.monotonic() - self._t0
