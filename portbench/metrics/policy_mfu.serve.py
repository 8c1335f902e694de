"""The policy's forward FLOPs (from the weights' shapes) over the agent-
steps of the profiled slice, over the device seconds of the kernels
launched inside ``pogema.policy`` there and the bf16 peak, in %
(``portbench/spans.py``). None without spans in the profiled slice or
without device kernels (the CPU)."""

from portbench import peaks, spans, work


def read(run):
    seconds = spans.device_s(run, "pogema.policy")
    s = run.shapes
    if seconds is None or "embed" not in s:
        return None
    steps = run.slice_units * run.work["steps"]
    flops = work.policy_flops(s["W"], s["embed"], s["hidden"]) * s["N"] * s["B"] * steps
    return 100.0 * flops / seconds / (peaks.BF16_FLOPS * run.chips)
