"""``fixpoint_passes_per_step``'s reading in the served cells, where it moves
``serve_env_steps_per_s``."""

from portbench.harness import load_module

read = load_module("metrics", "fixpoint_passes_per_step").read
