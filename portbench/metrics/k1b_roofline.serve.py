"""``k1b_roofline``'s reading in the served cells, where it moves
``serve_env_steps_per_s``."""

from portbench.harness import load_module

read = load_module("metrics", "k1b_roofline").read
