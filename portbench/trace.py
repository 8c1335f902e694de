"""Reading a ``torch.profiler`` trace of a bounded slice of a run.

The arithmetic is that of ``chip_smoke._profile``: device time per
kernel name summed over the slice, and the busy share of the slice's
wall time. Two things are added: the busy time is the union of the
device intervals (so operations that overlap on two streams count
once), and each idle gap between them is named by the innermost host
operation that was running at its midpoint, which says what the host
was doing while the card waited.

The raw events are read from the profiler's kineto results, not from
``prof.events()``, because building an ``EventList`` of a whole train
step (hundreds of thousands of events) takes minutes.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

TOP = 10
# Backward search for the host event that covers a gap: how far to look.
_SCAN = 4000
# Gaps shorter than this are idle time all the same, but are not named.
_NAMED_GAP_NS = 2_000


class Slice:
    """What one profiled slice shows: ``busy_s`` (union of device
    intervals), ``window_s`` (host clock, start to final sync),
    ``kernels`` {name: seconds}, ``idle`` {host op: seconds}."""

    def __init__(self, window_s, busy_s, kernels, idle):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels
        self.idle = idle

    def kernel_seconds(self, fragment: str) -> float:
        """Summed device seconds of the kernels whose name holds ``fragment``."""
        return sum(s for name, s in self.kernels.items() if fragment in name)

    def breakdown(self) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def _is_device(ev) -> bool:
    return ev.device_type() != torch.autograd.DeviceType.CPU


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _host_label(starts, host, mid):
    """What the host was doing at ``mid``: the innermost host event that
    covers it (latest start) with its parent, as 'parent > child', or
    'host between ops' where no event covers it (Python between calls)."""
    i = bisect.bisect_right(starts, mid) - 1
    found = []
    for j in range(i, max(-1, i - _SCAN), -1):
        s, e, name = host[j]
        if e >= mid:
            found.append(name)
            if len(found) == 2:
                break
    if not found:
        return "host between ops"
    return " > ".join(reversed(found))


def reduce(events, t0_ns: int, t1_ns: int, window_s: float) -> Slice:
    """Busy time, kernels by name and idle gaps by host op, over the
    events of [t0_ns, t1_ns] (the profiler's clock)."""
    kernels, dev, host = {}, [], []
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if _is_device(ev):
            s, e = max(s, t0_ns), min(e, t1_ns)
            if e <= s:
                continue
            kernels[ev.name()] = kernels.get(ev.name(), 0.0) + (e - s) / 1e9
            dev.append((s, e))
        else:
            host.append((s, e, ev.name()))
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) / 1e9
    host.sort()
    starts = [h[0] for h in host]
    idle, prev = {}, t0_ns
    for s, e in busy + [[t1_ns, t1_ns]]:
        gap = s - prev
        if gap > 0:
            label = _host_label(starts, host, prev + gap // 2) if gap >= _NAMED_GAP_NS else \
                "short gaps (< 2 us)"
            idle[label] = idle.get(label, 0.0) + gap / 1e9
        prev = max(prev, e)
    return Slice(window_s, busy_s, kernels, idle)


def _activities(device_type: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync(device_type: str):
    if device_type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def profiled(device_type: str, out: list):
    """Profile the block; on exit append its :class:`Slice` to ``out``.
    The block's wall time runs from a sync before it to a sync after it."""
    _sync(device_type)
    with torch.profiler.profile(activities=_activities(device_type)) as prof:
        with torch.profiler.record_function("portbench.slice"):
            t0 = time.perf_counter()
            yield
            _sync(device_type)
            window_s = time.perf_counter() - t0
    events = list(prof.profiler.kineto_results.events())
    marks = [ev for ev in events if ev.name() == "portbench.slice" and not _is_device(ev)]
    if marks:  # the slice on the profiler's own clock
        t0_ns = marks[0].start_ns()
        t1_ns = t0_ns + marks[0].duration_ns()
        window_s = marks[0].duration_ns() / 1e9
    else:
        t0_ns = min(ev.start_ns() for ev in events)
        t1_ns = t0_ns + int(window_s * 1e9)
    out.append(reduce([ev for ev in events if ev.name() != "portbench.slice"], t0_ns, t1_ns,
                      window_s))
