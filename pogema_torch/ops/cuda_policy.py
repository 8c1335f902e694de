"""The served recurrent policy step in CUDA for Hopper: K8.

The kernel lives in ``csrc/policy.cu`` (design and bound in its source
note), is built with nvcc at first use and launched through
``ops/launch.py``. One launch does the whole of
``RecurrentEmbedActorCritic.step_from_state`` after the packed
observation: the embedding, its bias and ReLU, the GRU cell's six
products and gates, and the f32 head, with bf16 tensor-core products
summed in f32 and every bf16 rounding point of the plain version kept.
The plain version is the module's own composition,
``RecurrentEmbedActorCritic.step_from_obs``.

:func:`engages` is the rule that sends a ``step_from_state`` here. K8
sums in another order than the plain version, so it may only serve calls
whose results can never meet the plain version's in autograd: the
learner replays its rollout's steps under autograd and needs them
bit-equal to the rollout. A tensor made under ``torch.inference_mode``
can never enter autograd, so that mode, which the evaluator runs under,
is the property K8 keys on; :func:`takes` is the part of the rule that
concerns the model.

:func:`policy_step` returns the plain version for tensors on the CPU and
launches the kernel or raises for CUDA tensors. Either way it first
refuses what the kernel does not take (the model by :func:`takes`,
dtypes, shapes, contiguity, alignment, devices), so a caller's fault
shows on the CPU too. ``policy_cuda.launches`` counts the launches.

The kernel reads its weights in the order its lanes use them:
:func:`pack_weights` makes that copy once for each state of the model's
parameters and keeps it on the module, made again when a parameter is
replaced or changed in place (its ``_version``). Parameters that are
inference tensors carry no version: change them by replacing them.
"""

from __future__ import annotations

import torch

from ..grid_config import NUM_ACTIONS
from . import launch
from .launch import I32, PTR

# The widths K8 is written for, and the largest observation it reads
# (K = 3 * W * W <= 384: obs_radius up to 5).
WIDTH = 128
MAX_OBS = 384

# Sizes fixed by csrc/policy.cu: the packed weights in 32-bit words (24
# stages of 3072), and the f32 side buffer (five biases of 128, the head
# as [128, 8] and its bias padded to 8).
WEIGHT_WORDS = 24 * 3072
AUX_FLOATS = 5 * 128 + 128 * 8 + 8
GRU = ("ir", "iz", "in", "hr", "hz", "hn")

_F32, _BF16 = (torch.float32,), (torch.bfloat16,)


def takes(model) -> bool:
    """Whether K8 computes ``model``'s step: a recurrent model in bf16 at
    embed = hidden = 128, not tensor-parallel, with an observation of at
    most ``MAX_OBS`` entries."""
    return (model.model_axis is None and model.dtype == torch.bfloat16
            and model.embed == WIDTH and model.hidden == WIDTH
            and 3 * model.window * model.window <= MAX_OBS)


def engages(model, device) -> bool:
    """Whether a ``step_from_state`` of ``model`` on ``device`` goes to K8:
    under inference mode, on a CUDA device, for a model K8 :func:`takes`.
    Every other call takes the plain version."""
    return (torch.is_inference_mode_enabled() and torch.device(device).type == "cuda"
            and takes(model))


def pack_weights(model) -> tuple:
    """(int32[WEIGHT_WORDS], f32[AUX_FLOATS]) of a 128/128 recurrent
    model, on its device. The words are bf16 pairs, the lower k in the
    low half, as each lane's mma.sync B fragments (b0: k = 2t, 2t + 1 of
    column g; b1: k + 8; g = lane / 4, t = lane % 4) come in 16 bytes:

    - the embedding, K padded with zeros to 384: k-step s, n-tile pair p
      (units 16p to 16p + 15), lane, then [b0, b1] of n-tile 2p and of
      2p + 1; three k-steps (12 KB) a stage;
    - the GRU, one stage for each 8 units c: product q (ir, iz, in, hr,
      hz, hn), k-step pair sp, lane, then [b0, b1] of k-step 2sp and of
      2sp + 1.

    The side buffer holds the embedding's bias and the biases of ir, iz,
    in and hn, rounded to bf16 as the plain version adds them, then the
    head's f32 kernel transposed and its bias."""
    with torch.no_grad():
        w = model.window
        emb = model.embed_kernel.detach().to(torch.bfloat16).reshape(3 * w * w, -1)
        emb = torch.cat([emb, emb.new_zeros(MAX_OBS - emb.shape[0], emb.shape[1])])
        # k = 16s + 8half + 2t + e, n = 16p + 8jt + g
        emb = emb.reshape(24, 2, 4, 2, 8, 2, 8).permute(0, 4, 6, 2, 5, 1, 3)
        gru = torch.stack([model.gru[q].weight.detach().to(torch.bfloat16) for q in GRU])
        # n = 8c + g, k = 32sp + 16js + 8half + 2t + e
        gru = gru.reshape(6, 16, 8, 4, 2, 2, 4, 2).permute(1, 0, 3, 2, 6, 4, 5, 7)
        words = torch.cat([emb.reshape(-1), gru.reshape(-1)]).view(torch.int32)
        biases = [model.embed_bias] + [model.gru[q].bias for q in ("ir", "iz", "in", "hn")]
        head = model.head_out.weight.detach().float().t()
        aux = torch.cat([torch.cat(biases).detach().to(torch.bfloat16).float(),
                         torch.cat([head, head.new_zeros(128, 2)], 1).reshape(-1),
                         model.head_out.bias.detach().float(), head.new_zeros(2)])
    return words.contiguous(), aux.contiguous()


def _version(p) -> int:
    return -1 if p.is_inference() else p._version


def weights(model) -> tuple:
    """:func:`pack_weights` of ``model``, kept on the module until a
    parameter is replaced or changed in place."""
    key = tuple((p.data_ptr(), _version(p)) for p in model.parameters())
    kept = getattr(model, "_k8_weights", None)
    if kept is None or kept[0] != key:
        kept = (key, *pack_weights(model))
        model._k8_weights = kept
    return kept[1], kept[2]


def policy_cuda(words, aux, obs, h) -> tuple:
    """One K8 launch on checked CUDA inputs: obs f32[..., K], h
    bf16[..., 128]. Returns (new_h bf16[..., 128], out f32[..., 6])."""
    lead, k = obs.shape[:-1], obs.shape[-1]
    new_h = torch.empty((*lead, WIDTH), dtype=torch.bfloat16, device=obs.device)
    out = torch.empty((*lead, NUM_ACTIONS + 1), dtype=torch.float32, device=obs.device)
    rows = new_h.numel() // WIDTH
    if rows == 0:  # nothing to launch (and nothing counted)
        return new_h, out
    _K8(obs.device, obs.data_ptr(), k, h.data_ptr(), words.data_ptr(), aux.data_ptr(),
        new_h.data_ptr(), out.data_ptr(), rows)
    return new_h, out


class _Policy(launch.Kernel):
    """K8's launch entry, bound only where the kernel reads the layout that
    :func:`pack_weights` writes."""

    def bind(self):
        sizes = (launch.bind("policy", "pogema_policy_weight_words")(),
                 launch.bind("policy", "pogema_policy_aux_floats")())
        if sizes != (WEIGHT_WORDS, AUX_FLOATS):
            raise RuntimeError(f"csrc/policy.cu reads {sizes} weight words and side floats, "
                               f"the wrapper packs {(WEIGHT_WORDS, AUX_FLOATS)}")
        return super().bind()


_K8 = _Policy("policy", "pogema_policy", (PTR, I32) + (PTR,) * 5 + (I32,), "policy_kernel",
              policy_cuda)


def policy_step(model, obs: torch.Tensor, h: torch.Tensor) -> tuple:
    """K8. ``model``: a ``RecurrentEmbedActorCritic`` that K8
    :func:`takes`, window W; obs: the packed observation f32[..., 3*W*W];
    h: bf16[..., 128] with the same leading shape. Returns ``(new_h bf16[..., 128], logits
    f32[..., 5], value f32[...])``."""
    launch.check(("obs", obs, _F32), ("h", h, _BF16), ("embed_kernel", model.embed_kernel, _F32))
    if not takes(model):
        raise ValueError("K8 takes a bf16 recurrent model at embed = hidden = 128 with "
                         "3 * window**2 <= 384, not tensor-parallel")
    k = 3 * model.window * model.window
    if obs.dim() < 1 or obs.shape[-1] != k:
        raise ValueError(f"obs must be [..., {k}], got {tuple(obs.shape)}")
    if tuple(h.shape) != (*obs.shape[:-1], WIDTH):
        raise ValueError(f"h must be {[*obs.shape[:-1], WIDTH]}, got {tuple(h.shape)}")
    if h.data_ptr() % 16:
        raise ValueError("h must start on a 16-byte boundary")
    if obs.device.type == "cpu":
        return model.step_from_obs(obs, h)
    new_h, out = policy_cuda(*weights(model), obs, h)
    return new_h, out[..., :NUM_ACTIONS], out[..., NUM_ACTIONS]
