"""Host ms inside ``pogema.collisions`` (propose and the resolver, the
fixpoint's host syncs included) per env step of the span slice
(``portbench/spans.py``); None without a span slice."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "pogema.collisions", run.work.get("steps"))
