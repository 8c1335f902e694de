"""Env-steps of the served episodes completed over the whole window (B x
T per episode, its reset included) over the window's time."""


def read(run):
    steps = run.total("env_steps")
    return None if steps is None else steps / run.window_s
