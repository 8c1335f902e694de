"""Checkpoint and resume of the port, and the weights' way back to flax.

Everything here is exact: a checkpoint stores tensors, so round trips,
resume == uninterrupted and the params' conversion are compared bit for
bit. The one comparison with the JAX package at a tolerance is the flax
tree of a port-trained model applied by the JAX module against the port's
own forward: 1e-5 (f32 model, f32 summation order).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pogema_torch import GridConfig, PogemaCore
from pogema_torch import parallel as tp
from pogema_torch.interop import (params_from_flax, params_to_flax, state_from_flax,
                                  unflatten_params)
from pogema_torch.models import init_embed_params, init_params, init_recurrent_params
from pogema_torch.utils.checkpoint import (checkpoint_exists, extract_params_from_state,
                                           restore_checkpoint, save_checkpoint)
from pogema_tpu import models as jm
from torch_parity import np_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = dict(seed=0, size=8, density=0.2, num_agents=2, obs_radius=2, max_episode_steps=8,
            on_target="restart")


def _fused_setup(num_envs=8, seed=1):
    core = PogemaCore(GridConfig(**GRID), num_envs=num_envs, auto_reset_mode="regen", device="cpu")
    ppo = tp.PPOConfig(rollout_steps=4, epochs=1, minibatches=2)
    model, _ = init_embed_params(torch.Generator().manual_seed(0), 5, embed=16, hidden=16)
    ts, tx = tp.init_fused_train_state(core, model, None, ppo, core.make_key(seed))
    return core, model, ppo, ts, tx


def test_env_state_roundtrip(tmp_path):
    core = PogemaCore(GridConfig(**dict(GRID, num_agents=3)), num_envs=4, device="cpu")
    state, _ = core.reset(0)
    state, *_ = core.step(state, torch.ones(4, 3, dtype=torch.int32))
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    assert os.path.isfile(path)  # one file per checkpoint
    fresh, _ = core.reset(1)  # another state of the same structure
    restored = restore_checkpoint(path, like=fresh)
    a, b = state.tensors(), restored.tensors()
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    s1, r1, *_ = core.step(state, torch.zeros(4, 3, dtype=torch.int32))
    s2, r2, *_ = core.step(restored, torch.zeros(4, 3, dtype=torch.int32))
    assert torch.equal(s1.agents_xy, s2.agents_xy) and torch.equal(r1.rewards, r2.rewards)
    # Without a template: plain containers of CPU tensors.
    plain = restore_checkpoint(path)
    assert isinstance(plain, dict) and plain["target_queue"].dtype == state.target_queue.dtype


@pytest.mark.parametrize("init,kw", [(init_params, dict(hidden=16, channels=2)),
                                     (init_embed_params, dict(embed=8, hidden=8)),
                                     (init_recurrent_params, dict(embed=8, hidden=8))],
                         ids=["conv", "fused", "recurrent"])
def test_params_roundtrip(tmp_path, init, kw):
    model, _ = init(torch.Generator().manual_seed(0), 5, **kw)
    params = tp.learner.params_of(model)
    path = str(tmp_path / "params")
    save_checkpoint(path, params)
    other, _ = init(torch.Generator().manual_seed(1), 5, **kw)
    restored = restore_checkpoint(path, like=tp.learner.params_of(other))
    assert set(restored) == set(params)
    for k in params:
        assert torch.equal(restored[k], params[k]), k
    with pytest.raises(ValueError, match="keys differ"):
        restore_checkpoint(path, like={"nope": torch.zeros(1)})


def test_overwrite_is_crash_safe(tmp_path):
    """Write-new-then-swap: a process killed at any point leaves a
    restorable checkpoint, the old or the new."""
    p = str(tmp_path / "ck")
    save_checkpoint(p, {"a": np.arange(3)})
    save_checkpoint(p, {"a": np.arange(3) * 2})  # overwrite
    assert restore_checkpoint(p)["a"].tolist() == [0, 2, 4]
    assert not os.path.exists(p + ".bak") and not os.path.exists(p + ".next")
    # A crash between the two swap renames: the main file gone, .bak
    # still there. Restore and the existence test fall back to it.
    os.rename(p, p + ".bak")
    assert checkpoint_exists(p)
    assert restore_checkpoint(p)["a"].tolist() == [0, 2, 4]
    # A new save from that state heals the layout.
    save_checkpoint(p, {"a": np.arange(3) * 3})
    assert restore_checkpoint(p)["a"].tolist() == [0, 3, 6]
    assert not os.path.exists(p + ".bak")
    assert not checkpoint_exists(str(tmp_path / "never_written"))


def test_recovery_save_promotes_next_before_bak_delete(tmp_path, monkeypatch):
    """In the post-crash state (main file absent, only .bak on disk) a
    new save renames .next into place BEFORE it removes .bak, so a kill
    inside the removal leaves the new checkpoint live."""
    p = str(tmp_path / "ck")
    save_checkpoint(p, {"a": np.arange(3)})
    os.rename(p, p + ".bak")

    real_remove = os.remove

    def dying_remove(path, *a, **kw):
        if path == p + ".bak":
            raise KeyboardInterrupt("kill while the .bak is removed")
        return real_remove(path, *a, **kw)

    monkeypatch.setattr("os.remove", dying_remove)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(p, {"a": np.arange(3) * 5})
    assert checkpoint_exists(p)
    monkeypatch.setattr("os.remove", real_remove)
    assert restore_checkpoint(p)["a"].tolist() == [0, 5, 10]


def test_full_train_state_roundtrip_and_extract_params(tmp_path):
    core, model, ppo, ts, tx = _fused_setup(num_envs=4)
    ts, _ = tp.make_fused_train_step(core, model, ppo, tx)(ts)  # non-zero moments and count
    state_path = str(tmp_path / "run_state")
    save_checkpoint(state_path, {"iter": np.int64(7), "ts": ts})
    _, _, _, fresh, _ = _fused_setup(num_envs=4, seed=2)
    saved = restore_checkpoint(state_path, like={"iter": np.int64(0), "ts": fresh})
    got = saved["ts"]
    assert int(saved["iter"]) == 7 and isinstance(got, tp.TrainState) and got.obs is None
    assert int(got.opt_state["count"]) == 2 and got.opt_state["count"].dtype == torch.int32
    assert torch.equal(got.key, ts.key) and got.key.dtype == torch.int64
    for k in ts.params:
        assert torch.equal(got.params[k], ts.params[k]), k
        assert torch.equal(got.opt_state["nu"][k], ts.opt_state["nu"][k]), k
    for k, v in ts.env_state.tensors().items():
        assert torch.equal(getattr(got.env_state, k), v), k

    params_path = str(tmp_path / "harvested")
    it, harvested = extract_params_from_state(state_path, params_path)
    assert it == 7 and set(harvested) == set(ts.params)
    reloaded = restore_checkpoint(params_path, like=ts.params)
    assert all(torch.equal(reloaded[k], ts.params[k]) for k in ts.params)
    with pytest.raises(ValueError, match="not a TrainState checkpoint"):
        extract_params_from_state(params_path)  # a params file is not a state file


@pytest.mark.parametrize("family", ["fused", "recurrent"])
def test_training_resume_equals_uninterrupted(tmp_path, family):
    """save -> restore into a FRESH state -> continue reproduces an
    uninterrupted run bit for bit: params, optimizer state, env state,
    hidden state and key all round-trip."""
    core = PogemaCore(GridConfig(**GRID), num_envs=8, auto_reset_mode="regen", device="cpu")
    ppo = tp.PPOConfig(rollout_steps=4, epochs=1, minibatches=2)
    gen = torch.Generator().manual_seed(0)
    if family == "fused":
        model, _ = init_embed_params(gen, 5, embed=16, hidden=16)
        init, make = tp.init_fused_train_state, tp.make_fused_train_step
    else:
        model, _ = init_recurrent_params(gen, 5, embed=16, hidden=16)
        init, make = tp.init_recurrent_train_state, tp.make_recurrent_train_step
    start = tp.learner.params_of(model)
    ts, tx = init(core, model, start, ppo, core.make_key(1))
    step = make(core, model, ppo, tx)
    ts_a = ts
    for _ in range(4):
        ts_a, _ = step(ts_a)
    ts_b = ts
    for _ in range(2):
        ts_b, _ = step(ts_b)
    path = str(tmp_path / "train_ckpt")
    save_checkpoint(path, ts_b)
    fresh, _ = init(core, model, start, ppo, core.make_key(2))
    ts_c = restore_checkpoint(path, like=fresh)
    for _ in range(2):
        ts_c, _ = step(ts_c)
    for k in ts_a.params:
        assert torch.equal(ts_a.params[k], ts_c.params[k]), k
        assert torch.equal(ts_a.opt_state["mu"][k], ts_c.opt_state["mu"][k]), k
        assert torch.equal(ts_a.opt_state["nu"][k], ts_c.opt_state["nu"][k]), k
    for k, v in ts_a.env_state.tensors().items():
        assert torch.equal(getattr(ts_c.env_state, k), v), k
    assert torch.equal(ts_a.key, ts_c.key)
    if family == "recurrent":
        assert ts_c.h.dtype == torch.bfloat16 and torch.equal(ts_a.h, ts_c.h)


@pytest.mark.parametrize("family", ["conv", "fused", "recurrent"])
def test_params_to_flax_inverts_params_from_flax(family):
    """``params_to_flax(params_from_flax(tree))`` is leaf-equal to the
    tree, and the JAX module accepts the flax tree of a port model."""
    key = jax.random.key(3)
    if family == "conv":
        _, params = jm.init_params(key, 5, hidden=16, channels=2)
    elif family == "fused":
        _, params = jm.init_embed_params(key, 5, embed=8, hidden=8)
    else:
        _, params = jm.init_recurrent_params(key, 5, embed=8, hidden=8)
    tree = np_tree(params)
    model, _ = params_from_flax(tree, torch.float32)
    back = params_to_flax(model)
    flat_a = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    flat_b = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        assert flat_b[k].dtype == np.float32 and flat_b[k].flags["C_CONTIGUOUS"], k
        np.testing.assert_array_equal(flat_b[k], flat_a[k], err_msg=k)
    # From a train state's params dict as well.
    back2 = params_to_flax(tp.learner.params_of(model))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(back2)))


def test_port_trained_policy_loads_on_the_jax_side():
    """Two train steps by the port, then the flax tree of the result
    through the JAX module's ``from_state``: the same logits and values
    as the port's own forward, within 1e-5 (f32 model)."""
    core = PogemaCore(GridConfig(**GRID), num_envs=8, auto_reset_mode="regen", device="cpu")
    ppo = tp.PPOConfig(rollout_steps=4, epochs=1, minibatches=2, lr=1e-2)
    model, _ = init_embed_params(torch.Generator().manual_seed(0), 5, embed=16, hidden=16,
                                 dtype=torch.float32)
    before = tp.learner.params_of(model)
    ts, tx = tp.init_fused_train_state(core, model, None, ppo, core.make_key(1))
    step = tp.make_fused_train_step(core, model, ppo, tx)
    for _ in range(2):
        ts, stats = step(ts)
    assert any(not torch.equal(before[k], ts.params[k]) for k in before)
    tree = params_to_flax(ts.params)
    st = ts.env_state
    jmodel = jm.EmbedActorCritic(window=5, embed=16, hidden=16, dtype=jnp.float32)
    want = jmodel.apply(jax.tree.map(jnp.asarray, tree), st.obstacles.numpy(), st.agents_xy.numpy(),
                        st.targets_xy.numpy(), st.active.numpy(),
                        method=jm.EmbedActorCritic.from_state)
    with torch.no_grad():
        got = model.from_state(st.obstacles, st.agents_xy, st.targets_xy, st.active)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5)


def _run_example(extra, cwd=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    base = [sys.executable, os.path.join(ROOT, "examples", "train_ppo_cuda.py"), "--device", "cpu",
            "--envs", "8", "--agents", "2", "--size", "8", "--obs-radius", "2",
            "--rollout-steps", "4", "--max-episode-steps", "8", "--on-target", "restart",
            "--embed", "16", "--hidden", "16", "--minibatches", "2"]
    return subprocess.run(base + extra, env=env, cwd=cwd, check=True, timeout=300,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True).stdout


@pytest.mark.parametrize("model", ["fused", "recurrent"])
def test_example_runner_resume_and_warm_start(tmp_path, model):
    """``examples/train_ppo_cuda.py --device cpu``: interrupted after 2
    iterations and resumed for 2 more == 4 uninterrupted iterations, on
    the final params; ``--init-params`` with ``--lr 0`` hands the source
    params through unchanged (relative checkpoint path, run elsewhere)."""
    m = ["--model", model]
    ckpt_a = str(tmp_path / "a")
    out = _run_example(m + ["--iters", "4", "--checkpoint", ckpt_a, "--log", str(tmp_path / "a.csv")])
    assert "iter    3" in out and "saved params to" in out
    rows = open(tmp_path / "a.csv").read().strip().splitlines()
    assert rows[0].startswith("iter,env_steps_per_s,") and len(rows) == 5
    ckpt_b = str(tmp_path / "b")
    _run_example(m + ["--iters", "2", "--checkpoint", ckpt_b, "--checkpoint-every", "2"])
    out = _run_example(m + ["--iters", "4", "--checkpoint", ckpt_b, "--checkpoint-every", "2",
                            "--resume"])
    assert "resumed from" in out and "at iter 2" in out
    pa, pb = restore_checkpoint(ckpt_a), restore_checkpoint(ckpt_b)
    assert set(pa) == set(pb) and len(pa) > 0
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    out = _run_example(m + ["--iters", "1", "--lr", "0", "--init-params", ckpt_a,
                            "--checkpoint", "c"], cwd=str(tmp_path))
    assert "warm-started params from" in out
    pc = restore_checkpoint(str(tmp_path / "c"))
    assert all(torch.equal(pa[k], pc[k]) for k in pa)


def test_example_runner_warm_starts_from_the_shipped_npz(tmp_path):
    """The config-D fine-tune command at a tiny size: ``--init-params``
    reads the committed flax ``.npz``, two train steps run in one call
    (``--steps-per-dispatch 2``), and with ``--lr 0`` the saved params
    are the shipped weights."""
    npz = os.path.join(ROOT, "pogema_torch", "weights", "rec128_ft.npz")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "train_ppo_cuda.py"), "--device", "cpu",
         "--model", "recurrent", "--embed", "128", "--hidden", "128", "--envs", "4", "--agents", "2",
         "--size", "8", "--rollout-steps", "4", "--max-episode-steps", "8", "--minibatches", "2",
         "--iters", "2", "--steps-per-dispatch", "2", "--lr", "0", "--init-params", npz,
         "--checkpoint", str(tmp_path / "ft")],
        env=env, check=True, timeout=300, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True).stdout
    assert "warm-started params from" in out and "iter    1" in out
    saved = restore_checkpoint(str(tmp_path / "ft"))
    with np.load(npz) as z:
        shipped = state_from_flax(unflatten_params({k: z[k] for k in z.files}))
    assert set(saved) == set(shipped)
    for k, v in shipped.items():
        np.testing.assert_array_equal(saved[k].numpy(), v, err_msg=k)


def test_example_runner_refuses_what_is_not_ported_and_needs_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    script = os.path.join(ROOT, "examples", "train_ppo_cuda.py")
    # The mixed map pools are ported (pogema_torch.maps): the runner takes them.
    out = subprocess.run([sys.executable, script, "--device", "cpu", "--maps", "mixed", "--envs",
                          "4", "--agents", "2", "--size", "8", "--obs-radius", "2",
                          "--rollout-steps", "4", "--max-episode-steps", "8", "--embed", "16",
                          "--hidden", "16", "--minibatches", "2", "--iters", "1"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "iter    0" in out.stdout, out.stderr[-2000:]
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, script, "--envs", "2", "--agents", "2", "--size", "8",
                              "--iters", "1"], env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "needs a CUDA device" in out.stderr
