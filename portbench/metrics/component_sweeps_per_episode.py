"""Sweeps of the reset's min-label flood fill per served episode over the
window (``generator.connected_components.sweeps``); each sweep is one
host sync, and the slowest env of the batch sets their number."""


def read(run):
    sweeps = run.counters.get("sweeps")
    return None if sweeps is None or not run.units else sweeps / run.units
