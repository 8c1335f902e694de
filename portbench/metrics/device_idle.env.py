"""The card's idle share over a bounded steady slice of env steps or
served episodes: 1 - (union of device intervals / the slice's wall
time), in %, from torch.profiler. The profiler slows the host, so the
slice's wall time, and with it this share, reads higher than in the
untraced window."""


def read(run):
    if run.slice is None or "env_steps" not in run.work:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)
