"""Host ms inside ``pogema.policy`` (one recurrent forward from the
state, K1b inside) per policy step (episodes x T) of the span slice
(``portbench/spans.py``); None without a span slice."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "pogema.policy", run.work.get("steps"))
