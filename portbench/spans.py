"""The program's spans over a run of a cell: where the host's time goes
inside a unit, and which span launched the device's work.

``pogema_torch`` opens a ``pogema.*`` span at each layer boundary
(``utils.profiling.trace_region``). This module runs a one-card cell as
the harness's traced run does, with a *span slice* between the window
and the profiled slice: whole units under ``profiling.tracing()``, no
profiler, for ``SLICE_S`` of host clock or the window's length where
that is shorter. It comes before the profiler because eager launches
stay slower for the rest of the process once a profiler has run. The
profiled slice then runs with the spans on, so their ranges sit in the
device trace beside the kernels:

    python3 portbench/spans.py --workload C.random --seed 7 --seconds 30

It prints a table to standard error, per span: calls, host ms a unit
(inclusive and self, from the span slice), device ms and idle ms a unit
(from the profiled slice); writes the span slice's spans to
``build/portbench/spans.<cell>.json`` (Chrome trace format); and prints
one JSON line: ``correct``, the cell's per-layer metrics with those of
``metrics/`` that read spans, the window's and the span slice's mean
unit, and the table.

Host time is what a span measures: a sync inside a span charges that
span with waiting for device work queued before it. The device column
makes up for that: each kernel is charged to the innermost span that
was open when the host launched it (the launch found by the kernel's
correlation id), and each idle gap of the card to the innermost span
the host was in. ``pogema.*`` events are left out of the events that
``trace.reduce`` names idle gaps by, so ``device_ops``, ``idle_gaps``
and the busy share read what they read without spans.
"""

from __future__ import annotations

import time

T0 = time.time()  # set-up is counted from here, as in run.py

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

SLICE_S = 3.0  # host seconds of the span slice (or the window's length, where shorter)
PREFIX = "pogema."
OUTSIDE = "(outside spans)"
_NAMED_GAP_NS = 2_000  # idle pieces shorter than this are not named (as in trace.py)
SITES = 4  # idle sites listed per span
# The readers in metrics/ that read spans.
METRICS = ("select_ms_per_step", "collisions_ms_per_step", "observe_ms_per_step",
           "reset_ms_per_episode.serve", "policy_ms_per_step.serve", "policy_mfu.serve")


def span_slice(driver, ctx, window_s: float) -> tuple:
    """Whole units under ``profiling.tracing()``: (recorder, units, seconds)."""
    from pogema_torch.utils import profiling

    limit = min(SLICE_S, window_s)
    units = 0
    with profiling.tracing() as rec:
        start = time.perf_counter()
        while True:
            driver.unit()
            units += 1
            if ctx.agree(time.perf_counter() - start >= limit):
                break
        seconds = time.perf_counter() - start
    return rec, units, seconds


def _self_segments(spans, t0_ns, t1_ns):
    """Sorted, disjoint (start, end, name) pieces of [t0_ns, t1_ns]: each
    instant goes to the innermost span open then, or to ``OUTSIDE``."""
    out, stack, cursor = [], [], t0_ns

    def emit(end, name):
        nonlocal cursor
        end = min(max(end, cursor), t1_ns)
        if end > cursor:
            out.append((cursor, end, name))
        cursor = max(cursor, end)

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            emit(end, top)
        emit(s, stack[-1][1] if stack else OUTSIDE)
        stack.append((e, name))
    while stack:
        end, top = stack.pop()
        emit(end, top)
    emit(t1_ns, OUTSIDE)
    return out


def _innermost(segments, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segments[i][0] <= t < segments[i][1]:
        return segments[i][2]
    return OUTSIDE


def by_span(spans, kernels, t0_ns: int, t1_ns: int, label=None) -> dict:
    """{span name: {"device_s", "idle_s", "sites"}} over [t0_ns, t1_ns].
    ``spans``: (start, end, name) host spans; ``kernels``: (start, end,
    launch) of each device operation, ``launch`` its host launch time or
    None where it was not found. A kernel's clipped time goes to the
    innermost span open at its launch; each instant the card is idle goes
    to the innermost span open then. With ``label`` (host ns -> what the
    host was doing), ``sites`` splits a span's idle pieces of 2 us or
    more by the label at their midpoint."""
    segments = _self_segments(spans, t0_ns, t1_ns)
    starts = [s for s, _, _ in segments]
    out = {}

    def entry(name):
        return out.setdefault(name, {"device_s": 0.0, "idle_s": 0.0, "sites": {}})

    busy = []
    for s, e, launch in kernels:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        name = OUTSIDE if launch is None else _innermost(segments, starts, launch)
        entry(name)["device_s"] += (e - s) / 1e9
        busy.append((s, e))
    merged = []
    for s, e in sorted(busy):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    j = 0
    for s, e, name in segments:  # the segment's idle pieces lie between busy intervals
        d = entry(name)
        while j < len(merged) and merged[j][1] <= s:
            j += 1
        cursor, k = s, j
        while cursor < e:
            nxt = merged[k][0] if k < len(merged) and merged[k][0] < e else e
            if nxt > cursor:
                d["idle_s"] += (nxt - cursor) / 1e9
                if label is not None and nxt - cursor >= _NAMED_GAP_NS:
                    site = label(cursor + (nxt - cursor) // 2)
                    d["sites"][site] = d["sites"].get(site, 0.0) + (nxt - cursor) / 1e9
            if nxt >= e:
                break
            cursor = max(cursor, merged[k][1])
            k += 1
    return out


def _is_device(ev) -> bool:
    import torch

    return ev.device_type() != torch.autograd.DeviceType.CPU


def split_events(events) -> tuple:
    """(events other than spans, pogema spans as (start, end, name),
    kernels as (start, end, launch)) of a profiler's kineto events. A
    kernel's launch is the CUDA runtime call with its correlation id, or
    else the CPU op its linked correlation id names."""
    others, spans, device = [], [], []
    runtime, ops = {}, {}
    for ev in events:
        name, s = ev.name(), ev.start_ns()
        if _is_device(ev):
            device.append(ev)
            others.append(ev)
        elif name.startswith(PREFIX):
            spans.append((s, s + ev.duration_ns(), name))
        else:
            others.append(ev)
            corr = ev.correlation_id()
            if corr:
                (runtime if name.startswith("cu") else ops).setdefault(corr, s)
    kernels = []
    for ev in device:
        s = ev.start_ns()
        launch = runtime.get(ev.correlation_id())
        if launch is None:
            launch = ops.get(ev.linked_correlation_id())
        kernels.append((s, s + ev.duration_ns(), launch))
    return others, spans, kernels


@contextlib.contextmanager
def profiled(device_type: str, out: list):
    """``trace.profiled`` with the spans read apart: on exit append
    (the ``trace.Slice`` of the events other than spans, ``by_span`` with
    idle pieces named as ``trace.reduce`` names its gaps)."""
    import torch

    from portbench import trace as tr

    tr._sync(device_type)
    with torch.profiler.profile(activities=tr._activities(device_type)) as prof:
        with torch.profiler.record_function("portbench.slice"):
            t0 = time.perf_counter()
            yield
            tr._sync(device_type)
            window_s = time.perf_counter() - t0
    events = list(prof.profiler.kineto_results.events())
    marks = [ev for ev in events if ev.name() == "portbench.slice" and not _is_device(ev)]
    if marks:
        t0_ns = marks[0].start_ns()
        t1_ns = t0_ns + marks[0].duration_ns()
        window_s = marks[0].duration_ns() / 1e9
    else:
        t0_ns = min(ev.start_ns() for ev in events)
        t1_ns = t0_ns + int(window_s * 1e9)
    others, spans, kernels = split_events(ev for ev in events if ev.name() != "portbench.slice")
    host = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
                  for ev in others if not _is_device(ev))
    starts = [h[0] for h in host]
    out.append((tr.reduce(others, t0_ns, t1_ns, window_s),
                by_span(spans, kernels, t0_ns, t1_ns, lambda t: tr._host_label(starts, host, t))))


def measure(ctx, seconds: float, t0_wall: float, driver=None) -> tuple:
    """``harness.measure`` with the span slice between the window and the
    profiled slice (traced runs only). The Run gains ``spans`` (the span
    slice's totals by name), ``span_units``, ``span_s`` and
    ``span_device`` (``by_span`` of the profiled slice)."""
    import torch

    from portbench import harness

    if driver is None:
        driver = harness.load_module("drivers", ctx.traffic["driver"]).Driver(ctx)
    driver.setup()
    ctx.sync()
    setup_s = time.time() - t0_wall
    before = driver.counters()
    durations = []
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        driver.unit()
        now = time.perf_counter()
        durations.append(now - t)
        if ctx.agree(now - start >= seconds):
            break
    window_s = time.perf_counter() - start
    counters = harness._delta(driver.counters(), before)
    extra = {"slice": None, "slice_counters": {}, "slice_units": 0}
    if ctx.trace:
        rec, units, span_s = span_slice(driver, ctx, window_s)
        extra.update(spans=rec.totals(), span_units=units, span_s=span_s, recorder=rec)
        before = driver.counters()
        slices = []
        with profiled("cuda" if ctx.device.startswith("cuda") else "cpu", slices):
            extra["slice_units"] = driver.traced_slice()
        extra["slice"], extra["span_device"] = slices[0]
        extra["slice_counters"] = harness._delta(driver.counters(), before)
    peak = torch.cuda.max_memory_allocated() if ctx.device.startswith("cuda") else 0
    run = harness.Run(cell=ctx.cell, chips=ctx.world, setup_s=setup_s, window_s=window_s,
                      units=len(durations), unit_seconds=durations, work=driver.work,
                      shapes=driver.shapes, counters=counters,
                      phases=getattr(driver, "phases", {}), memory_peak=int(peak), **extra)
    if run.slice is not None:
        run.busy_s, run.busy_window_s = run.slice.busy_s, run.slice.window_s
    driver.release()
    return run, driver.check()


# -- what the metric readers read ----------------------------------------


def host_ms(run, span: str, per_unit: float):
    """Host ms inside ``span`` over the span slice, per ``per_unit`` a
    unit (steps, episodes), or None without a span slice or the span."""
    totals = getattr(run, "spans", None)
    if not totals or span not in totals or not per_unit:
        return None
    return totals[span]["ns"] / 1e6 / (per_unit * run.span_units)


def device_s(run, span: str):
    """Device seconds of the kernels launched inside ``span`` in the
    profiled slice, or None where there were none."""
    seconds = (getattr(run, "span_device", None) or {}).get(span, {}).get("device_s", 0.0)
    return seconds if seconds > 0 else None


def table(run) -> dict:
    """Per span: calls, host ms a unit (inclusive, self) from the span
    slice; device and idle ms a unit from the profiled slice, with the
    idle time's largest sites (the host op it waited in)."""
    out = {}
    dev = getattr(run, "span_device", None) or {}
    for name in sorted(set(run.spans) | set(dev)):
        t = run.spans.get(name, {"calls": 0, "ns": 0, "self_ns": 0})
        d = dev.get(name, {"device_s": 0.0, "idle_s": 0.0, "sites": {}})
        per = 1e3 / max(run.slice_units, 1)
        sites = sorted(d["sites"].items(), key=lambda kv: -kv[1])[:SITES]
        out[name] = {"calls": t["calls"] / run.span_units,
                     "host_ms": t["ns"] / 1e6 / run.span_units,
                     "self_ms": t["self_ns"] / 1e6 / run.span_units,
                     "device_ms": per * d["device_s"], "idle_ms": per * d["idle_s"],
                     "idle_sites_ms": [[k, per * v] for k, v in sites]}
    return out


def _format(rows: dict, run) -> str:
    lines = [f"spans of {run.cell.name}: span slice {run.span_units} units in {run.span_s:.3f} s "
             f"(mean unit {1e3 * run.span_s / run.span_units:.4f} ms; window's "
             f"{1e3 * run.window_s / run.units:.4f} ms), profiled slice {run.slice_units} units",
             f"{'span':32s} {'calls/unit':>10s} {'host ms':>10s} {'self ms':>10s} "
             f"{'device ms':>10s} {'idle ms':>10s}   (a unit)"]
    for name, r in rows.items():
        lines.append(f"{name:32s} {r['calls']:10.2f} {r['host_ms']:10.4f} {r['self_ms']:10.4f} "
                     f"{r['device_ms']:10.4f} {r['idle_ms']:10.4f}")
    return "\n".join(lines)


def report(run, checks: list, kind: str) -> dict:
    """Write the span slice's Chrome trace, print the table to standard
    error, and return the result line."""
    from portbench import harness

    run.recorder.to_chrome_trace(str(harness.ROOT / "build" / "portbench"
                                     / f"spans.{run.cell.name}.json"))
    rows = table(run)
    print(_format(rows, run), file=sys.stderr)
    entries = run.cell.end_to_end + run.cell.per_layer + [{"name": n, "unit": "-"}
                                                          for n in METRICS]
    metrics = {k: v["value"] for k, v in harness.read_metrics(run, entries).items()}
    return {"correct": bool(checks) and all(v <= lim for _, v, lim in checks), "device": kind,
            "metrics": metrics, "window": {"units": run.units, "s": run.window_s},
            "span_slice": {"units": run.span_units, "s": run.span_s},
            "profiled": {"units": run.slice_units, "s": run.slice.window_s,
                         "busy_s": run.slice.busy_s},
            "memory_peak_bytes": run.memory_peak, "spans": rows,
            "breakdown": run.slice.breakdown(),
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}


def main(argv: list, t0_wall: float) -> int:
    ap = argparse.ArgumentParser(description="Run a one-card cell with its span slice.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    cell = harness.Cell(harness.load_manifest(), args.workload)
    if cell.chips != 1 or not torch.cuda.is_available():
        print(f"portbench.spans: {cell.name} needs one CUDA device and a one-card cell",
              file=sys.stderr)
        return 3
    run, checks = measure(harness.Context(cell, args.seed, "cuda", True), args.seconds, t0_wall)
    print(json.dumps(report(run, checks, torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    from portbench import run as _env  # noqa: F401  (the caches' paths, as run.py sets them)

    sys.exit(main(sys.argv[1:], T0))
