"""The card's idle share over one whole traced regen cycle of train
steps: 1 - (union of device intervals / the cycle's wall time), in %,
from torch.profiler. The profiler slows the host, so the cycle's wall
time, and with it this share, reads higher than in the untraced
window."""


def read(run):
    if run.slice is None or "train_env_steps" not in run.work:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)
