"""Host ms inside ``pogema.observe`` (both observations of a step: K1b,
or K1 and the channels) per env step of the span slice
(``portbench/spans.py``); None without a span slice."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "pogema.observe", run.work.get("steps"))
