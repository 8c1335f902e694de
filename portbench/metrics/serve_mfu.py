"""The policy's forward FLOPs (from the weights' shapes) times the
agent-steps served in the window, over the window's time and the bf16
peak, in %."""

from portbench import peaks, work


def read(run):
    steps = run.total("env_steps")
    s = run.shapes
    if steps is None or "embed" not in s:
        return None
    flops = work.policy_flops(s["W"], s["embed"], s["hidden"]) * s["N"] * steps
    return 100.0 * flops / run.window_s / (peaks.BF16_FLOPS * run.chips)
