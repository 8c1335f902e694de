"""Mean host ms of the window's steps on which an episode ended, so that
``_regen_reset`` generated new worlds inside the step (timed in
``drivers/env_regen.py``, each to the sync the unit already makes)."""


def read(run):
    ends = run.phases.get("regen_step")
    if not ends:
        return None
    return 1e3 * sum(ends) / len(ends)
