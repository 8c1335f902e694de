"""B x T x the whole train steps of the window, over the time those
steps took (B: the global number of envs)."""


def read(run):
    steps = run.total("train_env_steps")
    return None if steps is None else steps / sum(run.unit_seconds)
