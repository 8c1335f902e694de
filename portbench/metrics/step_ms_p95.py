"""95th percentile of the time of every step of the window, each timed
until its observation exists (a sync), as a learner that reads it
would."""

import statistics


def read(run):
    if run.work.get("steps") != 1 or len(run.unit_seconds) < 20:
        return None
    return statistics.quantiles([s * 1e3 for s in run.unit_seconds], n=20)[18]
