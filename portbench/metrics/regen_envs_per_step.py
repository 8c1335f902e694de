"""Envs regenerated per step over the window: the program's counter
``PogemaCore._regen_reset.envs`` (the ended envs given a new world)
over the window's steps. With every env's episode cut at 128 steps it
reads about B / 128."""


def read(run):
    steps = run.total("steps")
    envs = run.counters.get("regen_envs")
    if not steps or envs is None:
        return None
    return envs / steps
