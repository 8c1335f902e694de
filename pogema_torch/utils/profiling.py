"""Tracing and profiling helpers.

Counterpart of ``pogema_tpu/utils/profiling.py``, which wraps
``jax.profiler``: here regions are ``torch.profiler.record_function``
ranges (and NVTX ranges on a CUDA device, which Nsight reads), a trace
is a ``torch.profiler.profile`` written as a Chrome trace, and the
env-steps/s meter waits for the device before it reads the clock,
because CUDA launches return before the work is done.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_region(name: str):
    """Annotate a host-side region in profiler traces, and where a card
    is present also as an NVTX range."""
    cuda = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if cuda:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.nvtx.range_pop()


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
