"""The plain reference of the benchmark: POGEMA's env core (reset,
``priority`` collisions as the sequential rule, LifeLong goals, episode
metrics, auto-reset), the 'default' observation by direct window
slicing, the recurrent policy and its one-process PPO step, in plain
PyTorch. Resets and draws follow ``jax.random``'s threefry stream, as
``pogema_tpu`` draws them; ``portbench/tests/test_portbench_reference.py``
holds this package against ``pogema_tpu`` on the CPU. It imports
nothing of the measured program, and the harness gives it only the
inputs it gives the program (keys, actions, weights read from the
shipped ``.npz``), so it works out every reset, state, draw and
gradient again. Run it with TF32 off
(``portbench.reference.plain_precision``).
"""
