"""Passes of the collision fixpoint per env step over the window
(``collisions.fixpoint.passes``); each pass is one host sync."""


def read(run):
    steps = run.total("steps")
    passes = run.counters.get("fixpoint_passes")
    if not steps or passes is None:
        return None
    return passes / steps
