"""The port's evaluation examples ``examples/eval_lifelong_64_cuda.py``
and ``examples/eval_astar_cuda.py`` at a tiny size with ``--device
cpu``, against the JAX package's toolbox on the same environments: the
same metrics, exactly, for random, A* and the planner (the rims are
bit-equal); the PPO leg finite (a bf16 near-tie may flip a greedy action
between the two frameworks, ``tests/test_torch_toolbox.py``). The other
examples are in ``tests/test_torch_examples_cuda.py``.
"""

import contextlib
import io
import math
import os
import sys

import pogema_tpu.toolbox as jt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))


def _quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


def test_eval_lifelong_64_cuda():
    import eval_lifelong_64_cuda

    got, printed = _quiet(eval_lifelong_64_cuda.main,
                          ["--size", "10", "--agents", "3", "--steps", "12", "--device", "cpu",
                           os.path.join(ROOT, "pogema_torch", "weights", "ppo64.npz"), "5"])
    base = dict(size=10, density=0.3, num_agents=3, obs_radius=5, on_target="restart",
                max_episode_steps=12)
    for algo, extra in (("random", {}), ("A*", {"observation_type": "POMAPF"}),
                        ("Planner", {"observation_type": "MAPF"})):
        assert got[algo] == jt.evaluate(dict(base, **extra), algo=algo, seeds=[5])["env"], algo
    assert math.isfinite(got["PPO"]["avg_throughput"]) and printed.count('"algo"') == 4


def test_eval_astar_cuda_equals_the_jax_toolbox():
    import eval_astar_cuda

    got, printed = _quiet(eval_astar_cuda.main, ["--seeds", "0", "--device", "cpu"])
    assert got == jt.evaluate(eval_astar_cuda.ENVIRONMENTS, algo="A*", seeds=[0])
    assert set(got) == {"random-8", "random-16", "warehouse"} and '"warehouse"' in printed
