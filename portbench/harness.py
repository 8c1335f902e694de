"""The general part of the benchmark: find a cell's files by name, set
it up, measure its window, read its metrics, check its outputs and
print the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The configuration is ``configs/<config>.json``; the traffic mix is
``traffic/<traffic>.json``, whose ``driver`` names the module
``drivers/<driver>.py`` that runs that kind of traffic; the limits of
the cell's correctness check are ``limits/<cell>.json``; each metric is
``metrics/<metric>.py``, whose ``read(run)`` returns a number or None.

A driver module defines ``Driver(ctx)`` with:

* ``setup()``: build the system under test and warm up every shape the
  window uses (set-up time);
* ``unit()``: one closed-loop unit of work (a step, an episode, a train
  step) that returns once its results exist on the device;
* ``work``: {quantity: amount per unit}; ``shapes``: sizes the metrics
  read; ``counters()``: the program's own counters, read before and
  after the window and the traced slice;
* ``traced_slice()``: a bounded run of units under the profiler,
  returning how many it ran;
* ``release()``: drop the program's state (after the memory peak is
  read); ``check()``: compare what the window produced with the plain
  reference, as a list of ``(name, value, limit)``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Modules that no process of the benchmark may hold: the JAX stack and
# the JAX package (compared by whole top-level names).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pogema_tpu")
RANK_TIMEOUT_S = 900


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with its files loaded."""

    def __init__(self, manifest: dict, name: str):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        w = cells[name]
        self.name, self.chips = name, int(w["chips"])
        self.config_name, self.traffic_name = w["config"], w["traffic"]
        self.config = load_json("configs", w["config"])
        self.traffic = load_json("traffic", w["traffic"])
        self.limits = load_json("limits", name)
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name] if m["moves"] in e2e_names else [])]


class Context:
    """What a driver gets: the cell's files, the seed's streams, the
    device and, over several processes, the rank."""

    def __init__(self, cell: Cell, seed: int, device: str, trace: bool, rank: int = 0,
                 world: int = 1):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.device, self.trace = int(seed) % 2**64, device, trace
        self.rank, self.world = rank, world

    def _words(self, stream: int, n: int, dtype):
        return np.random.SeedSequence([self.seed, stream]).generate_state(n, dtype)

    def key(self, stream: int):
        """int64[2] threefry key words, a function of (seed, stream)."""
        import torch

        return torch.tensor(self._words(stream, 2, np.uint32).astype(np.int64),
                            device=self.device)

    def torch_seed(self, stream: int) -> int:
        return int(self._words(stream, 1, np.uint64)[0])

    def rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng(self._words(stream, 4, np.uint32))

    def sync(self):
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (one tiny broadcast)."""
        if self.world == 1:
            return flag
        import torch
        import torch.distributed as dist

        t = torch.tensor([1 if flag else 0], device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def max_over_ranks(self, value: float) -> float:
        return self._reduce(value, "max")

    def mean_over_ranks(self, value: float) -> float:
        return self._reduce(value, "sum") / self.world

    def _reduce(self, value, op):
        if self.world == 1:
            return value
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(value)], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
        return float(t.item())


class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def total(self, quantity: str):
        """Amount of ``quantity`` done in the window, or None."""
        per = self.work.get(quantity)
        return None if per is None else per * self.units


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def measure(ctx: Context, seconds: float, t0_wall: float, driver=None) -> tuple:
    """Set up, run the window and the traced slice, read the peak,
    release, check. Returns (Run, checks)."""
    import torch

    from portbench import trace as tr

    if driver is None:
        driver = load_module("drivers", ctx.traffic["driver"]).Driver(ctx)
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
    counters = _delta(driver.counters(), before)
    slice_, slice_counters, slice_units = None, {}, 0
    if ctx.trace:
        before = driver.counters()
        slices = []
        with tr.profiled("cuda" if ctx.device.startswith("cuda") else "cpu", slices):
            slice_units = driver.traced_slice()
        slice_, slice_counters = slices[0], _delta(driver.counters(), before)
    peak = (torch.cuda.max_memory_allocated() if ctx.device.startswith("cuda") else 0)
    peak = int(ctx.max_over_ranks(peak))
    run = Run(cell=ctx.cell, chips=ctx.world,
              setup_s=setup_s, window_s=window_s, units=len(durations),
              unit_seconds=durations, work=driver.work, shapes=driver.shapes,
              counters=counters, phases=getattr(driver, "phases", {}), slice=slice_,
              slice_counters=slice_counters, slice_units=slice_units, memory_peak=peak)
    if slice_ is not None:
        run.busy_s = ctx.mean_over_ranks(slice_.busy_s)
        run.busy_window_s = ctx.mean_over_ranks(slice_.window_s)
    driver.release()
    checks = driver.check()
    return run, checks


def read_metrics(run: Run, entries: list) -> dict:
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _number(value):
    """A compared number as JSON takes it: None where there was nothing
    to compare (an infinite reading)."""
    return value if math.isfinite(value) else None


def result_line(run: Run, checks: list, trace: bool, kind: str) -> dict:
    ok = [value <= limit for _, value, limit in checks]
    device = {"platform": "gpu", "kind": kind, "count": run.chips,
              "memory_peak_bytes": run.memory_peak}
    line = {"correct": bool(checks) and all(ok), "attempted": run.units,
            "failed": sum(not o for o in ok),
            "metrics": read_metrics(run, run.cell.per_layer if trace else run.cell.end_to_end),
            "device": device}
    if trace:
        device["busy_s"] = run.busy_s
        device["window_s"] = run.busy_window_s
        line["breakdown"] = run.slice.breakdown()
    line["checks"] = {name: {"value": _number(value), "limit": limit}
                      for name, value, limit in checks}
    return line


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(script: str, argv: list, chips: int, t0_wall: float) -> int:
    """One process per card over NCCL; rank 0 keeps this process's
    standard output, the others log under build/portbench/ranks/. Every
    process is waited for; one that fails stops the others."""
    port = _free_port()
    logdir = ROOT / "build" / "portbench" / "ranks"
    logdir.mkdir(parents=True, exist_ok=True)
    procs, logs = [], []
    for rank in range(chips):
        env = dict(os.environ, PORTBENCH_T0=repr(t0_wall), PORTBENCH_RANK=str(rank),
                   PORTBENCH_WORLD=str(chips), PORTBENCH_PORT=str(port), OMP_NUM_THREADS="2",
                   NCCL_SHM_DISABLE="1")
        if rank == 0:
            out = err = None
        else:
            log = open(logdir / f"rank{rank}.log", "w")
            logs.append(log)
            out, err = log, subprocess.STDOUT
        procs.append(subprocess.Popen([sys.executable, str(BENCH / script), *argv],
                                      env=env, stdout=out, stderr=err, cwd=str(ROOT)))
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes[1:]):
        for rank in range(1, chips):
            if codes[rank]:
                tail = (logdir / f"rank{rank}.log").read_text()[-3000:]
                print(f"portbench: rank {rank} exited {codes[rank]}:\n{tail}", file=sys.stderr)
    return next((c for c in codes if c), 0)


def join(cell: Cell, rank: int) -> int:
    """Join the cell's NCCL group as ``rank`` (one card each, the
    launcher's localhost port); the world's size, or 1 for a one-card
    cell."""
    if cell.chips == 1:
        return 1
    import datetime

    import torch
    import torch.distributed as dist

    world = int(os.environ["PORTBENCH_WORLD"])
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{os.environ['PORTBENCH_PORT']}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    return world


def _parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list, t0_wall: float) -> int:
    args = _parse(argv)
    cell = Cell(load_manifest(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), this machine has "
              f"{count}", file=sys.stderr)
        return 3
    rank = int(os.environ.get("PORTBENCH_RANK", "-1"))
    if cell.chips > 1 and rank < 0:
        return launch("run.py", argv, cell.chips, t0_wall)
    world = join(cell, rank)
    rank = max(rank, 0)
    ctx = Context(cell, args.seed, "cuda", bool(args.trace), rank, world)
    run, checks = measure(ctx, args.seconds, t0_wall)
    kind = torch.cuda.get_device_name(0)
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rank != 0:
        return 0
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    line = result_line(run, checks, bool(args.trace), kind)
    print(f"window: {run.units} units in {run.window_s:.3f} s, setup {run.setup_s:.3f} s, "
          f"unit seconds {[round(d, 4) for d in run.unit_seconds[:64]]}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
