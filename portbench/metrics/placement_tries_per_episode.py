"""Tries of the reset's placement retry loop per served episode over the
window (``generator.generate_env.tries``); each try draws maps, floods
them and places every agent again for the envs still unplaced."""


def read(run):
    tries = run.counters.get("tries")
    return None if tries is None or not run.units else tries / run.units
