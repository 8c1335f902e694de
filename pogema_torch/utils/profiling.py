"""Tracing and profiling helpers.

Counterpart of ``pogema_tpu/utils/profiling.py``, which wraps
``jax.profiler``. :func:`trace_region` is the port's one span
primitive: the package opens one at each layer boundary (the env step,
the collisions, the auto-reset, the observation, the reset and the
generator's stages, the evaluator's episode and policy forward), all
named ``pogema.*``. A span costs a flag test while nothing listens.
Under a ``torch.profiler`` it is a function-scope ``RecordFunction``
range, and on a CUDA device also an NVTX range, so it sits in the same
trace as the kernels it launched. Function scope makes it a host op of
the trace: a ``record_function`` (user scope) range would also be drawn
on the device's timeline as a user annotation, which readers of the
device's busy time take for device work. Under :func:`tracing` it is
kept in memory on the host clock (``time.perf_counter_ns``), with its
parent, for totals and self times by name and a Chrome trace.

A trace is a ``torch.profiler.profile`` written as a Chrome trace
(:func:`capture_trace`), and the env-steps/s meter waits for the device
before it reads the clock, because CUDA launches return before the
work is done.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time

import torch

_profiler_enabled = torch.autograd._profiler_enabled
_recorder = None  # the Recorder of the innermost active tracing(), or None
_nvtx = None  # whether spans also push NVTX ranges (a card is present); set on first use


class _Off:
    """The span while nothing listens: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class Recorder:
    """Spans kept in memory while :func:`tracing` is active, in the
    order they opened: ``names[i]``, ``starts[i]`` and ``ends[i]`` (ns
    on ``time.perf_counter_ns``), ``parents[i]`` (index of the span it
    opened in, or -1). Spans of one thread only."""

    def __init__(self):
        self.names, self.starts, self.ends, self.parents = [], [], [], []
        self._open = []

    def _enter(self, name: str) -> int:
        i = len(self.names)
        self.names.append(name)
        self.parents.append(self._open[-1] if self._open else -1)
        self.ends.append(-1)
        self._open.append(i)
        self.starts.append(time.perf_counter_ns())
        return i

    def _exit(self, i: int):
        self.ends[i] = time.perf_counter_ns()
        self._open.pop()

    def self_ns(self) -> list:
        """Per span: its duration less the part its child spans cover."""
        own = [e - s for s, e in zip(self.starts, self.ends)]
        for i, p in enumerate(self.parents):
            if p >= 0:
                own[p] -= self.ends[i] - self.starts[i]
        return own

    def totals(self) -> dict:
        """{name: {"calls", "ns" (inclusive), "self_ns"}} over closed spans."""
        out = {}
        for name, s, e, own in zip(self.names, self.starts, self.ends, self.self_ns()):
            if e < 0:
                continue
            t = out.setdefault(name, {"calls": 0, "ns": 0, "self_ns": 0})
            t["calls"] += 1
            t["ns"] += e - s
            t["self_ns"] += own
        return out

    def to_chrome_trace(self, path: str):
        """Write the closed spans as Chrome trace complete events (open
        in Perfetto or chrome://tracing); times in us from the first span."""
        t0 = min(self.starts, default=0)
        events = [{"name": n, "ph": "X", "pid": os.getpid(), "tid": 0,
                   "ts": (s - t0) / 1e3, "dur": (e - s) / 1e3}
                  for n, s, e in zip(self.names, self.starts, self.ends) if e >= 0]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


class _Span:
    __slots__ = ("name", "rec", "rf", "i")

    def __init__(self, name, rec):
        self.name, self.rec, self.rf = name, rec, None

    def __enter__(self):
        if _profiler_enabled():
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
            if _nvtx:
                torch.cuda.nvtx.range_push(self.name)
        if self.rec is not None:
            self.i = self.rec._enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec._exit(self.i)
        if self.rf is not None:
            if _nvtx:
                torch.cuda.nvtx.range_pop()
            self.rf.__exit__(*exc)
        return False


def trace_region(name: str):
    """A span over the ``with`` block: nothing (a shared no-op context)
    while neither :func:`tracing` nor a profiler is active; a profiler
    range (and NVTX range where a card is present) under a profiler; a
    span kept by the active recorder under :func:`tracing`."""
    if _recorder is None and not _profiler_enabled():
        return _OFF
    global _nvtx
    if _nvtx is None:
        _nvtx = torch.cuda.is_available()
    return _Span(name, _recorder)


def traced(name: str):
    """Decorator: run the function inside ``trace_region(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with trace_region(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


@contextlib.contextmanager
def tracing():
    """Keep every span opened in the block; yields the :class:`Recorder`.
    Nested, the inner block records alone and the outer one resumes
    after it."""
    global _recorder
    outer, rec = _recorder, Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = outer


@contextlib.contextmanager
def capture_trace(logdir: str):
    """Profile the block (host and, where a card is present, device
    activity) and write ``logdir/trace.json`` (Chrome trace format; open
    it in Perfetto or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class ThroughputMeter:
    """Sustained env-steps/s counter. :meth:`lap` first waits for
    ``device`` ("cuda" by default, raising without a card; "cpu" waits
    for nothing), so the steps counted have run."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ThroughputMeter(device='cuda') needs a CUDA device; pass "
                               "device='cpu' to time host work")
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def add(self, env_steps: int):
        self._steps += int(env_steps)

    def lap(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        rate = self._steps / dt if dt > 0 else 0.0
        self.reset()
        return rate
