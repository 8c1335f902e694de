"""Host ms inside ``pogema.autoreset`` (the cached select, its threefry
key advance included) per env step of the span slice
(``portbench/spans.py``); None without a span slice."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "pogema.autoreset", run.work.get("steps"))
