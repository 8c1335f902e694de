"""Mean host ms of the window's steps that returned terminal
observations (``infos["final_obs"]``): the steps where episodes end,
timed in ``drivers/vector.py`` as the learner waits for them."""


def read(run):
    ends = run.phases.get("end_step")
    if not ends:
        return None
    return 1e3 * sum(ends) / len(ends)
