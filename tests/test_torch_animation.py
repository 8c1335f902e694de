"""The port's SVG animation against pogema_tpu's, on the CPU.

The same seeded episode (the rims are bit-equal for the same config,
``tests/test_torch_envs.py``) driven by the same actions, recorded by
each package's ``AnimationMonitor``: the SVG text is equal, exactly, for
every drawing option, and the files a monitor saves at an episode's end
are equal too.
"""

import numpy as np
import pytest

import pogema_torch
import pogema_tpu
from pogema_torch.animation import AnimationConfig, AnimationMonitor
from pogema_tpu.animation import AnimationConfig as JaxAnimationConfig
from pogema_tpu.animation import AnimationMonitor as JaxAnimationMonitor

OPTIONS = {
    "plain": {},
    "egocentric": dict(egocentric_idx=1),
    "static": dict(static=True),
    "lines_no_border": dict(show_lines=True, show_border=False),
    "egocentric_lines": dict(egocentric_idx=0, show_lines=True, uid="ep"),
    "no_agents_no_targets": dict(show_agents=False, show_targets=False, uid="bare"),
}


def _monitors(on_target, directory):
    kw = dict(seed=7, size=10, density=0.25, num_agents=4, obs_radius=2, max_episode_steps=24,
              on_target=on_target)
    ours = AnimationMonitor(pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw), device="cpu"),
                            AnimationConfig(directory=str(directory / "port"), uid="run"))
    ref = JaxAnimationMonitor(pogema_tpu.pogema_v0(pogema_tpu.GridConfig(**kw)),
                              JaxAnimationConfig(directory=str(directory / "jax"), uid="run"))
    return ours, ref


@pytest.mark.parametrize("on_target", ["finish", "restart"])
def test_svg_equals_the_jax_monitor(on_target, tmp_path):
    ours, ref = _monitors(on_target, tmp_path)
    ours.reset()
    ref.reset()
    rng = np.random.default_rng(3)
    for _ in range(24):
        actions = rng.integers(0, 5, size=4).tolist()
        out, want = ours.step(actions), ref.step(actions)
        assert out[1] == want[1] and out[2] == want[2] and out[3] == want[3]
        if all(t or tr for t, tr in zip(out[2], out[3])):
            break
    for name, kw in OPTIONS.items():
        got = ours.create_animation(AnimationConfig(**kw)).render()
        assert got == ref.create_animation(JaxAnimationConfig(**kw)).render(), name
    # The monitor saved the finished episode by itself, under its uid.
    saved = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert saved == sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["run_1.svg"]
    assert (tmp_path / "port" / "run_1.svg").read_text() == (tmp_path / "jax" / "run_1.svg").read_text()
    path = ours.save_animation(str(tmp_path / "out" / "episode.svg"))
    assert open(path).read() == ours.create_animation().render()


def test_animation_needs_a_recorded_episode(tmp_path):
    ours, _ = _monitors("finish", tmp_path)
    with pytest.raises(RuntimeError, match="no episode recorded"):
        ours.create_animation()
    assert pogema_torch.AnimationMonitor is AnimationMonitor
    assert pogema_torch.AnimationConfig is AnimationConfig
