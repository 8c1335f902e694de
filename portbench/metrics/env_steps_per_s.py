"""Env-steps completed over the whole window (B per step) over the
window's time."""


def read(run):
    steps = run.total("env_steps")
    return None if steps is None else steps / run.window_s
