"""pogema_torch's config copy, state carrier and import boundary.

The port keeps its own copy of GridConfig / StaticConfig; these tests
hold the copy to the JAX package's, field by field, and check by AST
that no file of the port (nor chip_smoke.py) imports JAX or pogema_tpu.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import pogema_tpu.grid_config as jgc
import pogema_torch.grid_config as tgc
from pogema_torch.interop import state_from_numpy, state_to_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]

CONFIGS = [
    {},
    dict(size=64, num_agents=64, obs_radius=5, max_episode_steps=128,
         collision_system="priority", on_target="finish"),
    dict(size=12, density=0.1, num_agents=5, collision_system="soft", on_target="restart",
         observation_type="POMAPF", seed=3),
    dict(size=10, num_agents=3, collision_system="block_both", on_target="nothing",
         observation_type="MAPF", agents_xy=[[0, 0], [1, 1], [2, 2]],
         targets_xy=[[5, 5], [6, 6], [7, 7]]),
    dict(map=".A.#\n..#.\n#..a\n", obs_radius=2),
    dict(map=[[0, 1, 0], [0, 0, 0]], num_agents=2, max_episode_steps=7),
    dict(map="A.B\n...\nb.a", density=0.0),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_grid_config_matches_jax(kw):
    a, b = jgc.GridConfig(**kw), tgc.GridConfig(**kw)
    assert a.model_dump() == b.model_dump()
    sa, sb = a.to_static(), b.to_static()
    assert sa._key() == sb._key()
    assert (sa.padded_size, sa.window) == (sb.padded_size, sb.window)
    for layout in ("grid", "packed"):
        kv = {k: getattr(sa, k) for k in jgc.StaticConfig.__slots__}
        kv["obs_layout"] = layout
        assert jgc.StaticConfig(**kv)._key() == tgc.StaticConfig(**kv)._key()


@pytest.mark.parametrize("bad", [dict(size=1), dict(density=1.0), dict(num_agents=0),
                                 dict(obs_radius=0), dict(collision_system="x"),
                                 dict(on_target="x"), dict(observation_type="x"),
                                 dict(max_episode_steps=0), dict(agents_xy=[[0, 0]]),
                                 dict(map="Ab")])
def test_grid_config_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        jgc.GridConfig(**bad)
    with pytest.raises(ValueError):
        tgc.GridConfig(**bad)


def test_constants_and_parse_map():
    assert tgc.MOVES == jgc.MOVES and tgc.NUM_ACTIONS == jgc.NUM_ACTIONS
    assert (tgc.FREE, tgc.OBSTACLE) == (jgc.FREE, jgc.OBSTACLE)
    spec = "A.#\n.B.\n#ab"
    assert tgc.parse_map(spec) == jgc.parse_map(spec)
    with pytest.raises(AttributeError):
        tgc.GridConfig().to_static().size = 3


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = (sorted((ROOT / "pogema_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("*_cuda.py")))
    assert len(files) > 10
    names = {str(p.relative_to(ROOT)) for p in files}
    for must in ("pogema_torch/parallel/learner.py", "pogema_torch/parallel/rollout.py",
                 "pogema_torch/parallel/optim.py", "pogema_torch/utils/checkpoint.py",
                 "examples/train_ppo_cuda.py", "chip_smoke.py"):
        assert must in names, must
    for path in files:
        bad = {m for m in _imported_roots(path)} & {"jax", "jaxlib", "flax", "optax", "orbax",
                                                    "pogema_tpu"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_state_round_trip():
    rng = np.random.default_rng(0)
    b, n, p = 3, 4, 9
    arrays = {
        "obstacles": rng.integers(0, 2, (b, p, p)).astype(np.uint8),
        "agents_xy": rng.integers(0, p, (b, n, 2)).astype(np.int32),
        "targets_xy": rng.integers(0, p, (b, n, 2)).astype(np.int32),
        "target_queue": rng.integers(0, p * p, (b, n, 5)).astype(np.int16),
        "active": rng.integers(0, 2, (b, n)).astype(bool),
        "terminated": rng.integers(0, 2, (b, n)).astype(bool),
        "on_goal_ever": rng.integers(0, 2, (b, n)).astype(bool),
        "goals_achieved": rng.integers(0, 9, (b, n)).astype(np.int32),
        "step_count": rng.integers(0, 9, (b,)).astype(np.int32),
        "key": rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32),
        "placement_ok": np.ones(b, bool),
        "obstacle_nibbles": np.zeros((b, p, 3), np.float32),
    }
    state = state_from_numpy(arrays, "cpu")
    assert state.key.dtype == torch.int64 and state.target_queue.dtype == torch.int16
    back = state_to_numpy(state)
    assert set(back) == set(arrays) - {"obstacle_nibbles"}
    for k, v in back.items():
        np.testing.assert_array_equal(v, arrays[k].astype(v.dtype) if k == "key" else arrays[k])
        assert k == "key" or v.dtype == arrays[k].dtype
    arrays.pop("target_queue")
    assert state_from_numpy(arrays, "cpu").target_queue is None
