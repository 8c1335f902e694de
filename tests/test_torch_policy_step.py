"""K8's CPU side: the plain version of the served recurrent step
(``RecurrentEmbedActorCritic.step_from_obs``) against the JAX module, the
rule that sends a call to K8 (``cuda_policy.engages``), the wrapper's
refusals (``ops/cuda_policy.py``) and the packed weights' layout, which
the kernel reads lane by lane.

The card side (K8 against the plain version, its launch counts) is
``test_torch_policy_card.py``.
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pogema_torch import GridConfig, PogemaCore
from pogema_torch.core import step as step_mod
from pogema_torch.core.obs import packed_observation
from pogema_torch.interop import load_policy, unflatten_params
from pogema_torch.models import init_recurrent_params
from pogema_torch.ops import cuda_policy
from pogema_torch.parallel import make_policy_evaluator
from pogema_tpu import models as jm

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "pogema_torch", "weights")
CHECKPOINTS = ("rec128_ft", "maze256")
CUDA = torch.device("cuda")  # a device object only: nothing is placed on it
# The plain version against flax on the shipped weights: h' equal, and
# logits and value (the f32 head, its sums in another order) within
# HEAD_TOL, relative where they exceed 1. Read on this test's states: h'
# equal, the head within 3.0e-6.
HEAD_TOL = 1e-4


@pytest.fixture(scope="module", params=CHECKPOINTS)
def checkpoint(request):
    return request.param


@pytest.fixture(scope="module")
def shipped(checkpoint):
    return load_policy(os.path.join(WEIGHTS, f"{checkpoint}.npz"), device="cpu")


def _states(window, steps=3, seed=0):
    """``steps`` env states of 4 envs x 8 agents on 16x16 at the model's
    radius, random moves between them."""
    core = PogemaCore(GridConfig(seed=0, size=16, density=0.3, num_agents=8,
                                 obs_radius=window // 2, max_episode_steps=32),
                      num_envs=4, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    state, _ = core.reset(seed, with_obs=False)
    out = []
    for _ in range(steps):
        actions = torch.randint(0, 5, (4, 8), generator=gen, dtype=torch.int32)
        state, _ = step_mod.step(core.cfg, state, actions, with_obs=False)
        out.append((state.obstacles, state.agents_xy, state.targets_xy, state.active))
    return out


def _flax(name):
    """The JAX module and its params from the shipped ``.npz``."""
    with np.load(os.path.join(WEIGHTS, f"{name}.npz")) as z:
        tree = unflatten_params({k: z[k] for k in z.files})
    p = tree["params"]
    return jm.RecurrentEmbedActorCritic(
        window=int(round(p["embed_kernel"].shape[1] ** 0.5)), embed=p["embed_kernel"].shape[2],
        hidden=p["gru"]["hr"]["kernel"].shape[1], dtype=jnp.bfloat16), tree


def _near(got, want, tol, where):
    """|got - want| <= tol, relative to |want| where that exceeds 1."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    err = float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())
    assert got.shape == want.shape and err <= tol, (where, err)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_plain_step_matches_flax_over_three_steps(checkpoint, shipped, mode):
    """On the CPU ``step_from_state`` is the plain version under either
    mode, bit for bit, and follows the JAX module's ``step_from_state``
    from the same weights, each side carrying its own h: h' bit-equal,
    logits and value within HEAD_TOL."""
    ctx = torch.no_grad if mode == "no_grad" else torch.inference_mode
    jmodel, params = _flax(checkpoint)
    h = shipped.initial_carry((4, 8))
    hj = jmodel.initial_carry((4, 8))
    for t, args in enumerate(_states(shipped.window)):
        with ctx():
            got = shipped.step_from_state(*args, h)
            plain = shipped.step_from_obs(packed_observation(shipped.window, *args), h)
        for a, b in zip(got, plain):
            assert a.dtype == b.dtype and torch.equal(a, b)
        hj, *want = jmodel.apply(params, *(a.numpy() for a in args), hj,
                                 method=jm.RecurrentEmbedActorCritic.step_from_state)
        h = got[0]
        _near(h, hj, 0.0, f"{checkpoint} step {t} h")
        for a, b, what in zip(got[1:], want, ("logits", "value")):
            _near(a, b, HEAD_TOL, f"{checkpoint} step {t} {what}")
    assert h.dtype == torch.bfloat16 and bool(h.abs().sum() > 0)


def _models():
    gen = torch.Generator().manual_seed(0)
    bf16, _ = init_recurrent_params(gen, 11)
    f32, _ = init_recurrent_params(gen, 11, dtype=torch.float32)
    narrow, _ = init_recurrent_params(gen, 11, embed=64, hidden=64)
    wide_window, _ = init_recurrent_params(gen, 13)
    sharded = copy.deepcopy(bf16)
    sharded.model_axis = "model"  # what models.tensor_parallel.shard_module sets
    return bf16, {"f32": f32, "64/64": narrow, "window 13": wide_window, "tensor-parallel": sharded}


def test_engages_only_in_inference_mode_on_cuda_for_bf16_128():
    bf16, refused = _models()
    with torch.inference_mode():
        assert cuda_policy.engages(bf16, CUDA)
        assert cuda_policy.engages(bf16, "cuda:0")
        assert not cuda_policy.engages(bf16, torch.device("cpu"))
        for name, model in refused.items():
            assert not cuda_policy.engages(model, CUDA), name
    with torch.no_grad():
        assert not cuda_policy.engages(bf16, CUDA)
    with torch.enable_grad():
        assert not cuda_policy.engages(bf16, CUDA)


def test_the_evaluator_runs_in_inference_mode():
    model, _ = init_recurrent_params(torch.Generator().manual_seed(0), 5, embed=16, hidden=16)
    seen = []
    step = model.step_from_state

    def spy(*args):
        seen.append(torch.is_inference_mode_enabled())
        return step(*args)

    model.step_from_state = spy
    core = PogemaCore(GridConfig(seed=0, size=8, num_agents=2, obs_radius=2,
                                 max_episode_steps=4), num_envs=2, device="cpu")
    make_policy_evaluator(core, model)(core.make_key(0))
    assert seen == [True] * 4


def test_cpu_calls_never_launch(shipped):
    before = cuda_policy.policy_cuda.launches
    h = shipped.initial_carry((4, 8))
    with torch.inference_mode():
        for args in _states(shipped.window, steps=2):
            h, _, _ = shipped.step_from_state(*args, h)
    assert cuda_policy.policy_cuda.launches == before


def test_wrapper_returns_the_plain_version_on_the_cpu(shipped):
    before = cuda_policy.policy_cuda.launches
    obs = packed_observation(shipped.window, *_states(shipped.window, steps=1)[0])
    h = torch.randn(4, 8, 128, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    with torch.inference_mode():
        got = cuda_policy.policy_step(shipped, obs, h)
        want = shipped.step_from_obs(obs, h)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cuda_policy.policy_cuda.launches == before


def _inputs(rows=6, k=363):
    obs = torch.zeros(rows, k)
    h = torch.zeros(rows, 128, dtype=torch.bfloat16)
    return obs, h


@pytest.mark.parametrize("case", ["obs f64", "h f32", "obs and h on two devices",
                                  "weights on another device", "obs not contiguous",
                                  "h not contiguous", "obs width", "h width", "h rows",
                                  "h misaligned"])
def test_wrapper_refuses(case):
    model, _ = _models()
    obs, h = _inputs()
    fault = TypeError if case in ("obs f64", "h f32") else ValueError
    if case == "obs f64":
        obs = obs.double()
    elif case == "h f32":
        h = h.float()
    elif case == "obs and h on two devices":
        h = h.to("meta")
    elif case == "weights on another device":
        obs, h = obs.to("meta"), h.to("meta")
    elif case == "obs not contiguous":
        obs = torch.zeros(363, 6).t()
    elif case == "h not contiguous":
        h = torch.zeros(128, 6, dtype=torch.bfloat16).t()
    elif case == "obs width":
        obs = torch.zeros(6, 300)
    elif case == "h width":
        h = torch.zeros(6, 64, dtype=torch.bfloat16)
    elif case == "h rows":
        h = torch.zeros(5, 128, dtype=torch.bfloat16)
    elif case == "h misaligned":
        h = torch.zeros(6 * 128 + 1, dtype=torch.bfloat16)[1:].view(6, 128)
    with pytest.raises(fault):
        cuda_policy.policy_step(model, obs, h)


@pytest.mark.parametrize("name", ["f32", "64/64", "window 13", "tensor-parallel"])
def test_wrapper_refuses_models_k8_does_not_take(name):
    model = _models()[1][name]
    k = 3 * model.window ** 2
    with pytest.raises(ValueError):
        cuda_policy.policy_step(model, torch.zeros(2, k),
                                torch.zeros(2, model.hidden, dtype=torch.bfloat16))


def _bf16_pairs(words):
    """int32 words -> bf16 values [..., 2], the low half first."""
    return torch.from_numpy(words.numpy().view(np.uint16).astype(np.int32) << 16).view(
        torch.float32).reshape(*words.shape, 2)


def test_packed_weights_are_what_each_lane_reads(shipped):
    """Read the packed words as ``csrc/policy.cu`` reads them (the stage,
    the 16 bytes of a lane, the word in them) and rebuild each weight."""
    words, aux = cuda_policy.pack_weights(shipped)
    assert words.shape == (cuda_policy.WEIGHT_WORDS,) and aux.shape == (cuda_policy.AUX_FLOATS,)
    vals = _bf16_pairs(words)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    k_e = 3 * shipped.window ** 2
    emb = torch.full((384, 128), float("nan"))
    for s in range(24):
        stage, local = divmod(s, 3)
        for p in range(8):
            for j in range(4):
                word = stage * 3072 + ((local * 8 + p) * 32 + lane) * 4 + j
                tile, half = 2 * p + j // 2, j % 2
                for e in range(2):
                    emb[16 * s + 2 * t + 8 * half + e, 8 * tile + g] = vals[word, e]
    want = shipped.embed_kernel.detach().to(torch.bfloat16).float().reshape(k_e, 128)
    assert torch.equal(emb[:k_e], want) and not emb[k_e:].any()
    for qi, q in enumerate(cuda_policy.GRU):
        got = torch.full((128, 128), float("nan"))
        for c in range(16):
            for sp in range(4):
                for j in range(4):
                    word = (8 + c) * 3072 + ((qi * 4 + sp) * 32 + lane) * 4 + j
                    s, half = 2 * sp + j // 2, j % 2
                    for e in range(2):
                        got[8 * c + g, 16 * s + 2 * t + 8 * half + e] = vals[word, e]
        assert torch.equal(got, shipped.gru[q].weight.detach().to(torch.bfloat16).float()), q
    biases = aux[:640].reshape(5, 128)
    for row, param in enumerate([shipped.embed_bias] + [shipped.gru[q].bias
                                                        for q in ("ir", "iz", "in", "hn")]):
        assert torch.equal(biases[row], param.detach().to(torch.bfloat16).float())
    head = aux[640:640 + 1024].reshape(128, 8)
    assert torch.equal(head[:, :6].t(), shipped.head_out.weight.detach())
    assert not head[:, 6:].any()
    assert torch.equal(aux[-8:-2], shipped.head_out.bias.detach()) and not aux[-2:].any()


def test_packed_weights_are_kept_until_a_parameter_changes():
    model, _ = _models()
    first = cuda_policy.weights(model)
    assert cuda_policy.weights(model)[0] is first[0]
    with torch.no_grad():
        model.gru["hz"].weight.mul_(2.0)
    second = cuda_policy.weights(model)
    assert second[0] is not first[0] and not torch.equal(second[0], first[0])
    model.head_out.bias = torch.nn.Parameter(torch.ones(6))
    third = cuda_policy.weights(model)
    assert torch.equal(third[1][-8:-2], torch.ones(6))
