"""Seconds of the learner's update per train step: the program's own
``phase_hook('update')``, with a sync at each phase end (traced run)."""


def read(run):
    update = run.phases.get("update")
    return None if not update else sum(update) / len(update)
