"""State and policy weights to and from numpy: the carrier between the
JAX package and the port.

A JAX ``EnvState`` becomes a dict of numpy arrays on the JAX side (with
``jax.random.key_data(state.key)`` for the key); ``state_from_numpy``
turns such a dict into the port's state on any device, and
``state_to_numpy`` turns the port's state back for comparison.

Flax params (the ``{'params': ...}`` nest of a restored checkpoint)
become a policy module with ``params_from_flax``; ``load_policy`` reads
the same leaves from an ``.npz`` (``flatten_params`` writes one), so a
machine without JAX or orbax can load the shipped weights.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import FIELDS, EnvState


def state_from_numpy(arrays: dict, device) -> EnvState:
    """Build an EnvState from ``{field: np.ndarray}``. ``target_queue``
    may be missing or None; it keeps its own integer width (i16 or i32).
    Extra keys (such as ``obstacle_nibbles``) are ignored."""
    kw = {}
    for name, dtype in FIELDS.items():
        a = arrays.get(name)
        if a is None:
            if name != "target_queue":
                raise KeyError(f"state field {name!r} missing")
            kw[name] = None
            continue
        a = np.asarray(a)
        if name == "target_queue":
            dtype = torch.int16 if a.dtype == np.int16 else torch.int32
        if name == "key":
            a = a.astype(np.int64)
        kw[name] = torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()
    return EnvState(**kw)


def state_to_numpy(state: EnvState) -> dict:
    """``{field: np.ndarray}`` of every non-None leaf (key as int64 words)."""
    return {k: v.detach().cpu().numpy() for k, v in state.tensors().items()}


# -- policy weights ---------------------------------------------------------


def flatten_params(tree: dict, prefix: str = "") -> dict:
    """``{'params': {'gru': {'hn': {'kernel': a}}}}`` ->
    ``{'params/gru/hn/kernel': f32 array}``: the layout of the ``.npz``
    files that :func:`load_policy` reads."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_params(v, path + "/"))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def unflatten_params(flat) -> dict:
    """Inverse of :func:`flatten_params`."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return tree


def _linear_state(prefix: str, leaf: dict) -> dict:
    """A flax Dense ``{kernel [in, out], bias?}`` as Linear weight [out, in]."""
    out = {f"{prefix}.weight": np.asarray(leaf["kernel"]).T}
    if "bias" in leaf:
        out[f"{prefix}.bias"] = np.asarray(leaf["bias"])
    return out


def params_from_flax(tree: dict, dtype: torch.dtype = torch.bfloat16):
    """(module, state_dict) from the ``{'params': {...}}`` nest of numpy
    arrays that ``pogema_tpu.utils.checkpoint.restore_checkpoint`` gives.

    The family is inferred as the JAX toolbox does: ``embed_kernel`` with
    ``gru`` is the recurrent model, ``embed_kernel`` alone the
    feedforward one, anything else the conv model. Dense kernels
    [in, out] become Linear weights [out, in]; conv kernels HWIO become
    OIHW. ``dtype`` is the compute type of the module (weights stay f32).
    """
    from .models import ActorCritic, EmbedActorCritic, RecurrentEmbedActorCritic

    p = tree["params"] if "params" in tree else tree
    sd = {}
    if "embed_kernel" in p:
        ek = np.asarray(p["embed_kernel"])  # [3, W*W, E]
        window = int(round(ek.shape[1] ** 0.5))
        sd["embed_kernel"] = ek
        sd["embed_bias"] = np.asarray(p["embed_bias"])
        sd.update(_linear_state("head_out", p["head_out"]))
        if "gru" in p:
            hidden = int(np.asarray(p["gru"]["hr"]["kernel"]).shape[1])
            model = RecurrentEmbedActorCritic(window, int(ek.shape[2]), hidden, dtype)
            for name, leaf in p["gru"].items():
                sd.update(_linear_state(f"gru.{name}", leaf))
        else:
            hidden = int(np.asarray(p["trunk"]["kernel"]).shape[1])
            model = EmbedActorCritic(window, int(ek.shape[2]), hidden, dtype)
            sd.update(_linear_state("trunk", p["trunk"]))
    else:
        channels = int(np.asarray(p["conv1"]["kernel"]).shape[-1])
        trunk_in, hidden = np.asarray(p["trunk"]["kernel"]).shape
        window = int(round((trunk_in // channels) ** 0.5))
        model = ActorCritic(window, int(hidden), channels, dtype)
        for name in ("conv1", "conv2"):
            sd[f"{name}.weight"] = np.asarray(p[name]["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{name}.bias"] = np.asarray(p[name]["bias"])
        for name in ("trunk", "policy", "value"):
            sd.update(_linear_state(name, p[name]))
    state_dict = {k: torch.tensor(np.asarray(v), dtype=torch.float32) for k, v in sd.items()}
    model.load_state_dict(state_dict)  # strict: every leaf accounted for
    return model, state_dict


def load_policy(path_or_tree, device="cuda", dtype: torch.dtype = torch.bfloat16):
    """A policy module in eval mode on ``device`` from an ``.npz`` of
    flattened leaves (keys like ``params/gru/hn/kernel``, see
    :func:`flatten_params`) or from a ``{'params': ...}`` tree."""
    if isinstance(path_or_tree, dict):
        tree = path_or_tree
    else:
        with np.load(path_or_tree) as z:
            tree = unflatten_params({k: z[k] for k in z.files})
    model, _ = params_from_flax(tree, dtype)
    return model.to(device).eval()
