"""The port's map registry (``pogema_torch.maps``, a copy of
``pogema_tpu.maps``) on the CPU: the same names and every map equal, the
pools equal, the MovingAI round trip, and ``GridConfig(map_name=...)``
and map banks resetting bit-equal to the JAX package."""

import numpy as np
import pytest

import pogema_torch
import pogema_torch.maps as tm
import pogema_tpu
import pogema_tpu.maps as jm
from pogema_torch.grid_config import parse_map
from torch_parity import assert_host_equal, assert_states_equal, assert_trees_equal, make_cores


def _grid(spec):
    return np.asarray(parse_map(spec)[0], np.uint8)


def test_registry_equal():
    assert tm.list_maps() == jm.list_maps()
    kinds = {"maze", "warehouse", "city", "movingai", "random", "empty", "rooms"}
    assert kinds <= {n.split("-")[0] for n in tm.list_maps()}
    for name in tm.list_maps():
        np.testing.assert_array_equal(_grid(tm.get_map(name)), _grid(jm.get_map(name)),
                                      err_msg=name)
    with pytest.raises(KeyError, match="unknown map"):
        tm.get_map("no-such-map")


def test_register_map_is_per_package():
    tm.register_map("torch-only-3x3", "...\n.#.\n...")
    try:
        assert "torch-only-3x3" in tm.list_maps() and "torch-only-3x3" not in jm.list_maps()
        with pytest.raises(ValueError, match="already registered"):
            tm.register_map("torch-only-3x3", "...")
        cfg = pogema_torch.GridConfig(map_name="torch-only-3x3", num_agents=1, obs_radius=1)
        ref = pogema_tpu.GridConfig(map="...\n.#.\n...", num_agents=1, obs_radius=1)
        got = cfg.model_dump()
        assert got.pop("map_name") == "torch-only-3x3"
        assert got == {k: v for k, v in ref.model_dump().items() if k != "map_name"}
        assert cfg.map[1][1] == 1
    finally:
        del tm._REGISTRY["torch-only-3x3"]


def test_generators_and_pools_equal():
    for size, seed, braid in ((16, 0, 0.0), (21, 3, 0.15), (64, 1, 0.0)):
        assert tm.np_maze(size, seed=seed, braid=braid) == jm.np_maze(size, seed=seed, braid=braid)
    assert tm.np_warehouse(32) == jm.np_warehouse(32)
    assert tm.np_city(32, seed=2) == jm.np_city(32, seed=2)
    names = ["warehouse-16x16", "rooms-16x16"]
    assert_host_equal(jm.make_pool(names), tm.make_pool(names))
    assert_host_equal(jm.mixed_pool(16, k=8, seed=5), tm.mixed_pool(16, k=8, seed=5))
    assert_host_equal(jm.benchmark_pool(64), tm.benchmark_pool(64))
    with pytest.raises(ValueError, match="one size"):
        tm.make_pool(["warehouse-16x16", "empty-8x8"])
    with pytest.raises(ValueError, match="no built-in maps"):
        tm.benchmark_pool(17)


def test_movingai_roundtrip():
    grid = tm.np_city(32, seed=4)
    text = tm.to_movingai(grid)
    assert text == jm.to_movingai(grid)
    assert tm.load_movingai(text) == jm.load_movingai(text)
    np.testing.assert_array_equal(_grid(tm.load_movingai(text)), np.asarray(grid, np.uint8))


@pytest.mark.parametrize("name", ["warehouse-16x16", "bottleneck-8x8"])
def test_map_name_episode_bit_equal(name):
    kw = dict(seed=2, map_name=name, num_agents=6, obs_radius=2, max_episode_steps=12)
    je = pogema_tpu.pogema_v0(pogema_tpu.GridConfig(**kw))
    te = pogema_torch.pogema_v0(pogema_torch.GridConfig(**kw), device="cpu")
    assert te.grid_config.size == je.grid_config.size
    assert_host_equal(je.reset(), te.reset())
    np.testing.assert_array_equal(te.get_obstacles(), _grid(tm.get_map(name)))
    rng = np.random.default_rng(0)
    for _ in range(12):
        a = rng.integers(0, 5, size=6).tolist()
        assert_host_equal(je.step(a), te.step(a))


def test_map_bank_reset_bit_equal():
    bank = tm.make_pool(["warehouse-16x16", "rooms-16x16"])
    kw = dict(size=16, num_agents=6, obs_radius=2, max_episode_steps=8)
    jc, tc = make_cores(kw, 8, map_bank=bank)
    js, jo = jc.reset(5)
    ts, to = tc.reset(5)
    assert_states_equal(js, ts, "bank reset")
    assert_trees_equal(jo, to, "bank reset obs")
    inner = ts.obstacles.numpy()[:, 2:-2, 2:-2]
    picked = {int(np.argmax([(inner[b] == g).all() for g in bank])) for b in range(8)}
    assert picked == {0, 1}
