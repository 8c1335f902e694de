"""``PogemaVectorEnv`` at config C's widths on the card (4096 envs x 64
agents on 64x64 mazes, r = 5, packed f32 observations, cached auto-reset,
128-step episodes): one ending step, at which every env ends, hands back
terminal observations equal row for row to the pre-reset packed
observation, and the copy counters grow by what the shapes reckon.

Every test needs a CUDA device (marker ``cuda``) and skips without one.
This file imports no JAX, so the card's machine runs it as it is:
``python -m pytest --noconftest tests/test_torch_rim_vector_card.py``.
"""

import numpy as np
import pytest
import torch

from pogema_torch import GridConfig, PogemaVectorEnv
from pogema_torch.utils import host

GRID = dict(size=64, num_agents=64, obs_radius=5, max_episode_steps=128,
            collision_system="priority", on_target="finish")
B = 4096
N = GRID["num_agents"]
ROW = 3 * (2 * GRID["obs_radius"] + 1) ** 2  # 363 packed floats an agent
# Bytes one step copies to the host: the f32 observation, f32 rewards,
# bool terminated and truncated [B, N], bool done [B] and three f32
# episode metrics [B]; an ending step adds the terminal observations.
STEP_BYTES = B * N * ROW * 4 + B * N * 4 + 2 * B * N + B + 3 * B * 4
FINAL_BYTES = B * N * ROW * 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: config C's rim runs its kernels on the card")
    return "cuda"


@pytest.mark.cuda
def test_an_ending_step_at_config_c(card):
    assert STEP_BYTES == 382_259_200 and FINAL_BYTES == 380_633_088
    env = PogemaVectorEnv(GridConfig(**GRID), num_vec_envs=B, obs_layout="packed",
                          auto_reset_mode="cached", maze=True, device=card)
    env.reset(seed=2**31 + 7)
    rng = np.random.default_rng(7)
    for _ in range(GRID["max_episode_steps"] - 1):
        infos = env.step(rng.integers(0, 5, size=B * N, dtype=np.int32))[4]
        assert "final_obs" not in infos
    actions = rng.integers(0, 5, size=B * N, dtype=np.int32)
    # The pre-reset observation, by the core's step without auto-reset
    # from the same state.
    _, res, done, _ = env._core.step(env._state, torch.as_tensor(actions.reshape(B, N),
                                                                 device=card))
    want = res.observations.cpu().numpy().reshape(B * N, ROW)
    assert bool(done.all())
    copied, rows = host.fetch.bytes, PogemaVectorEnv._final_obs.rows
    obs, _, _, truncated, infos = env.step(actions)
    assert host.fetch.bytes - copied == STEP_BYTES + FINAL_BYTES
    assert PogemaVectorEnv._final_obs.rows - rows == B
    assert infos["_final_obs"].all() and truncated.all()
    final = infos["final_obs"]
    assert final.dtype == np.float32 and final.shape == (B * N, ROW)
    np.testing.assert_array_equal(final, want)
    assert obs.shape == (B * N, ROW) and not np.array_equal(obs, final)
