"""Helpers around the plain reference (``pogema_ref``): precision, the
reference's own reading of the shipped weights, exact comparison and
the controls (the reference with a guarantee broken or in a lower
precision) that the tests and the calibration put in the program's
place."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def plain_precision():
    """float32 products in float32: TF32 off for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def patched(patches):
    """Set ``(obj, attr, value)`` for the block, then restore."""
    patches = patches or []
    old = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, value in patches:
        setattr(obj, attr, value)
    try:
        yield
    finally:
        for obj, attr, value in reversed(old):
            setattr(obj, attr, value)


def mismatches(got: dict, want: dict) -> int:
    """Elements that differ between two dicts of tensors (a missing key
    or a shape that differs counts every element)."""
    bad = 0
    for k in set(got) | set(want):
        a, b = got.get(k), want.get(k)
        if a is None or b is None or a.shape != b.shape:
            bad += max(0 if a is None else a.numel(), 0 if b is None else b.numel(), 1)
            continue
        bad += int((a.to(b.device) != b).sum())
    return bad


def flax_leaves(leaves: dict) -> dict:
    """Flattened flax leaves (``{"params/gru/hn/kernel": array}``) as the
    flat {name: f32 array} of the reference's module: Dense kernels [in,
    out] become weights [out, in]."""
    out = {}
    for key, a in leaves.items():
        parts = key.split("/")[1:]
        a = np.asarray(a, np.float32)
        if parts[-1] == "kernel" and a.ndim == 2:
            parts[-1], a = "weight", a.T
        out[".".join(parts)] = np.ascontiguousarray(a)
    return out


def read_flax_npz(path) -> dict:
    """The shipped ``.npz`` (flattened flax leaves) as :func:`flax_leaves`."""
    with np.load(path) as z:
        return flax_leaves({k: z[k] for k in z.files})


def recurrent_model(path_or_leaves, device, dtype=torch.bfloat16):
    """The reference's recurrent policy with the shipped weights (a path
    to the ``.npz``) or with ``flax_leaves`` already read."""
    from .pogema_ref.models.recurrent import RecurrentEmbedActorCritic

    sd = (read_flax_npz(path_or_leaves) if isinstance(path_or_leaves, str)
          else path_or_leaves)
    _, ww, embed = sd["embed_kernel"].shape
    model = RecurrentEmbedActorCritic(int(round(ww ** 0.5)), embed, sd["gru.hr.weight"].shape[0],
                                      dtype)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return model.to(device).eval()


# -- planted variants ------------------------------------------------------


def one_pass_priority(obstacles, agents_xy, active, actions):
    """The control of the env cells: ``priority`` collisions resolved in
    one parallel pass, what a fixpoint cut to its first pass computes.
    Agent i moves if no later active agent stands on its target and no
    earlier active agent stays on it or, by that pass's own reckoning,
    moves onto it. It breaks the configuration's index-order guarantee
    wherever a chain of moves needs more than one pass."""
    from .pogema_ref.core.collisions import propose

    p = obstacles.shape[1]
    n = agents_xy.shape[1]
    desired, moving = propose(obstacles, agents_xy, active, actions)
    cur = agents_xy[..., 0].long() * p + agents_xy[..., 1].long()
    tgt = desired[..., 0].long() * p + desired[..., 1].long()
    idx = torch.arange(n, device=cur.device)
    act = active[:, None, :]
    later = (idx[None, :] > idx[:, None]) & act
    earlier = (idx[None, :] < idx[:, None]) & act
    on_cur = tgt[:, :, None] == cur[:, None, :]
    m0 = moving & ~(on_cur & later).any(dim=2)
    m0j = m0[:, None, :]
    onto = (tgt[:, :, None] == tgt[:, None, :]) & m0j
    blocked = (earlier & (onto | (on_cur & ~m0j))).any(dim=2)
    m = m0 & ~blocked
    return torch.where(m[..., None], desired, agents_xy)


def _fp8(w):
    """``w`` rounded to float8 e4m3 with one scale per tensor (its amax
    onto 448); the gradient passes straight through."""
    scale = w.detach().abs().max().clamp(min=1e-12) / 448.0
    q = (w.detach() / scale).to(torch.float8_e4m3fn).to(w.dtype) * scale
    return w + (q - w).detach()


def fp8_patches() -> list:
    """The control of a bfloat16 policy: the reference's products with
    every weight matrix in float8 e4m3 (activations stay bfloat16), the
    precision step below the configuration's. Patches for
    :func:`patched`."""
    from .pogema_ref.models import recurrent

    def dense(x, layer, dtype):
        y = torch.matmul(x.to(dtype).float(), _fp8(layer.weight.float()).t()).to(dtype)
        return y if layer.bias is None else y + layer.bias.to(dtype)

    def embed_obs(embed_kernel, bias, dtype, obs):
        kernel = _fp8(embed_kernel.float()).reshape(-1, embed_kernel.shape[-1])
        return (torch.matmul(obs.to(dtype).float(), kernel) + bias.float()).to(dtype)

    return [(recurrent, "dense", dense), (recurrent, "embed_obs", embed_obs)]
