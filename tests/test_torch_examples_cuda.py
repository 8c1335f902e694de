"""The port's example scripts (``examples/*_cuda.py``; those of
``eval_lifelong_64`` and ``eval_astar`` are in
``test_torch_examples_eval_cuda.py``) at a tiny size with ``--device
cpu``, against the JAX package's scripts or toolbox where they take the
same arguments: the same numbers, exactly (A*,
random and the planner are bit-equal between the rims; the PPO legs are
held to be finite, since a bf16 near-tie may flip a greedy action
between the two frameworks, ``tests/test_torch_toolbox.py``).
"""

import contextlib
import io
import math
import os
import re
import sys

import pytest

from pogema_tpu import AnimationConfig as JaxAnimationConfig
from pogema_tpu import AnimationMonitor as JaxAnimationMonitor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))


def _quiet(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


def _import_jax_eval_ladder():
    """examples/eval_ladder.py, imported with JAX's compilation-cache
    setting left as the test run has it (the script points the cache
    at a directory of its own when it is imported)."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    import eval_ladder

    jax.config.update("jax_compilation_cache_dir", before)
    return eval_ladder


def test_eval_ladder_cuda_equals_the_jax_script(monkeypatch):
    import eval_ladder_cuda

    eval_ladder = _import_jax_eval_ladder()

    args = ["--agents", "4", "--size", "12", "--steps", "16", "--maps", "mixed", "--seeds", "3",
            "--algos", "random", "A*", "Planner"]
    got, _ = _quiet(eval_ladder_cuda.main, args + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["eval_ladder.py"] + args)
    want, _ = _quiet(eval_ladder.main)
    assert got == want and set(got) == {"random", "A*", "Planner"}
    ppo, printed = _quiet(eval_ladder_cuda.main, [
        "--agents", "4", "--size", "12", "--steps", "16", "--seeds", "3", "--algos", "PPO",
        "--ckpt", os.path.join(ROOT, "pogema_torch", "weights", "maze256.npz"),
        "--device", "cpu"])
    assert math.isfinite(ppo["PPO"]) and '"algo": "PPO"' in printed


def test_animate_cuda_equals_the_jax_monitor(tmp_path):
    import animate_cuda

    import pogema_tpu

    paths, _ = _quiet(animate_cuda.main, ["--out", str(tmp_path), "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == ["episode.svg", "episode_ego.svg",
                                                    "episode_static.svg", "planner_episode.svg"]
    # The first episode of examples/animate.py, through the JAX package.
    env = JaxAnimationMonitor(
        pogema_tpu.pogema_v0(pogema_tpu.GridConfig(seed=7, size=12, density=0.25, num_agents=4,
                                                   obs_radius=3, max_episode_steps=48,
                                                   observation_type="POMAPF")),
        JaxAnimationConfig(directory=str(tmp_path / "jax"), save_every_idx_episode=None))
    agent = pogema_tpu.BatchAStarAgent()
    obs, _ = env.reset()
    while True:
        obs, rew, term, trunc, infos = env.step(agent.act(obs))
        if all(t or tr for t, tr in zip(term, trunc)):
            break
    for name, cfg in (("episode.svg", None), ("episode_ego.svg", JaxAnimationConfig(egocentric_idx=0)),
                      ("episode_static.svg", JaxAnimationConfig(static=True))):
        assert open(tmp_path / name).read() == env.create_animation(cfg).render(), name
    assert open(tmp_path / "planner_episode.svg").read().startswith("<svg")


ARGS = ["--envs", "16", "--agents", "2", "--size", "8", "--obs-radius", "2", "--iters", "2",
        "--rollout-steps", "8", "--minibatches", "2", "--epochs", "1"]


def _lines(printed):
    """The per-iteration lines without their env-steps/s."""
    return [re.sub(r"\s+[\d,]+ env-steps/s$", "", line) for line in printed.splitlines()
            if line.startswith("iter")]


def test_train_torch_ppo_cuda_equals_the_jax_script():
    import train_torch_ppo
    import train_torch_ppo_cuda

    got, printed = _quiet(train_torch_ppo_cuda.main, ARGS + ["--device", "cpu"])
    want, printed_jax = _quiet(train_torch_ppo.main, ARGS + ["--cpu-env"])
    assert got == want and len(_lines(printed)) == 2
    assert _lines(printed) == _lines(printed_jax)


@pytest.mark.parametrize("maps", ["mixed", "mixed-maze"])
def test_train_ppo_cuda_takes_the_mixed_pools(maps):
    import train_ppo_cuda

    _, printed = _quiet(train_ppo_cuda.main, [
        "--device", "cpu", "--maps", maps, "--envs", "4", "--agents", "2", "--size", "8",
        "--obs-radius", "2", "--rollout-steps", "4", "--max-episode-steps", "8",
        "--embed", "16", "--hidden", "16", "--minibatches", "2", "--iters", "1"])
    assert "iter    0" in printed


def test_train_ppo_cuda_on_two_gloo_ranks():
    """examples/train_ppo_cuda.py under two gloo ranks (torchrun's
    environment), 2 iterations on the CPU: rank 0 prints every iteration
    and rank 1 nothing; the mesh splits the 8 envs over the ranks and
    gives the one-process run's numbers (reward per step and loss as
    printed, to 4 decimals)."""
    import train_ppo_cuda
    from torch_mesh_parity import spawn

    args = ["--device", "cpu", "--envs", "8", "--agents", "2", "--size", "8", "--obs-radius", "2",
            "--rollout-steps", "4", "--max-episode-steps", "8", "--embed", "16", "--hidden", "16",
            "--minibatches", "2", "--iters", "2"]
    outs = spawn([os.path.join(ROOT, "examples", "train_ppo_cuda.py")] + args, 2)
    _, alone = _quiet(train_ppo_cuda.main, args)

    def numbers(text):
        return re.findall(r"iter +(\d+) +reward/step (\S+) .* loss (\S+)", text)

    assert [n[0] for n in numbers(outs[0])] == ["0", "1"], outs[0]
    assert numbers(outs[1]) == []
    assert numbers(outs[0]) == numbers(alone), (outs[0], alone)
