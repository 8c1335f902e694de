"""MB the rim copied from the card to the host per step over the window
(``fetch.bytes``, the program's counter of the bytes ``utils.host.fetch``
copied from CUDA tensors): the step's results on every step and the
ended envs' terminal observations on a step where episodes end."""


def read(run):
    steps = run.total("steps")
    copied = run.counters.get("fetch_bytes")
    if not steps or copied is None:
        return None
    return copied / steps / 1e6
