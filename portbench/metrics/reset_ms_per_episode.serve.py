"""Host ms inside ``pogema.reset`` (the batched reset: the generator's
stages and the ``placement_ok`` sync) per served episode of the span
slice (``portbench/spans.py``); None without a span slice."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "pogema.reset", 1)
