"""Set-up: from the start of the process (of the launcher, over several
cards) to the first timed unit: imports, the kernel cache, weights,
reset and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
