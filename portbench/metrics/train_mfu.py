"""The FLOPs of the train steps of the window (rollout and bootstrap
forwards, forward and backward of every replayed agent-step) over
their time and the bf16 peak of the cards used, in %."""

from portbench import peaks, work


def read(run):
    s = run.shapes
    steps = run.total("train_steps")
    if not steps or "rollout" not in s:
        return None
    per_step = work.train_step_flops(work.policy_flops(s["W"], s["embed"], s["hidden"]),
                                     s["B"], s["N"], s["rollout"], s["epochs"])
    return 100.0 * per_step * steps / sum(run.unit_seconds) / (peaks.BF16_FLOPS * run.chips)
