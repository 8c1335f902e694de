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
``params_to_flax`` goes the other way, so a policy trained by the port
loads in the JAX package.

The learner's state crosses likewise: ``train_state_from_numpy`` builds a
``TrainState`` or ``RecurrentTrainState`` from the numpy leaves of a JAX
one (params and Adam moments as flax nests), ``train_state_to_numpy``
turns the port's back.
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


def state_from_flax(tree: dict) -> dict:
    """A flax param nest (or a nest shaped like one: gradients, Adam
    moments) as the port's flat ``{name: f32 array}``: Dense kernels
    [in, out] become Linear weights [out, in], conv kernels HWIO become
    OIHW, biases and the ``embed_*`` leaves keep their layout, and the
    nesting becomes dotted names (``gru.hn.weight``)."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                out[f"{prefix}weight"] = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            else:
                out[f"{prefix}{k}"] = a
    walk(tree["params"] if "params" in tree else tree, "")
    return out


def state_to_flax(state: dict) -> dict:
    """Inverse of :func:`state_from_flax`: ``{'params': nest of numpy}``
    from the port's flat names (tensors or arrays)."""
    tree: dict = {}
    for name, v in state.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(
                a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T)
        else:
            node[leaf] = a
    return {"params": tree}


def params_to_flax(model_or_params) -> dict:
    """The ``{'params': {...}}`` nest of numpy arrays that the flax
    modules of ``pogema_tpu`` take, from a policy module of the port or
    from a train state's ``params`` dict: the inverse of
    :func:`params_from_flax`, so that a policy trained by the port loads
    on the JAX side unchanged."""
    if isinstance(model_or_params, dict):
        return state_to_flax(model_or_params)
    return state_to_flax(dict(model_or_params.named_parameters()))


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

    sd = state_from_flax(tree)
    if "embed_kernel" in sd:
        _, ww, embed = sd["embed_kernel"].shape  # [3, W*W, E]
        window = int(round(ww ** 0.5))
        if "gru.hr.weight" in sd:
            model = RecurrentEmbedActorCritic(window, embed, sd["gru.hr.weight"].shape[0], dtype)
        else:
            model = EmbedActorCritic(window, embed, sd["trunk.weight"].shape[0], dtype)
    else:
        channels = sd["conv1.weight"].shape[0]
        hidden, trunk_in = sd["trunk.weight"].shape
        window = int(round((trunk_in // channels) ** 0.5))
        model = ActorCritic(window, int(hidden), channels, dtype)
    state_dict = {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}
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


# -- learner state ----------------------------------------------------------


def opt_state_from_optax(adam: dict, device) -> dict:
    """The port's optimizer state from optax's ``ScaleByAdamState`` given
    as numpy: ``{"count": int, "mu": flax nest, "nu": flax nest}`` (of the
    chain ``clip_by_global_norm, adam`` only that element holds state)."""
    def moments(tree):
        return {k: torch.tensor(v, dtype=torch.float32, device=device)
                for k, v in state_from_flax(tree).items()}

    return {"count": torch.tensor(int(np.asarray(adam["count"])), dtype=torch.int32, device=device),
            "mu": moments(adam["mu"]), "nu": moments(adam["nu"])}


def opt_state_to_numpy(opt_state: dict) -> dict:
    """Inverse of :func:`opt_state_from_optax`: the moments as flax nests."""
    return {"count": opt_state["count"].cpu().numpy(),
            "mu": state_to_flax(opt_state["mu"]), "nu": state_to_flax(opt_state["nu"])}


def train_state_from_numpy(arrays: dict, device, h_dtype: torch.dtype = torch.bfloat16):
    """A ``TrainState`` (or, when ``arrays`` has ``"h"``, a
    ``RecurrentTrainState``) on ``device`` from numpy: ``params`` a flax
    nest, ``opt_state`` as :func:`opt_state_from_optax` takes it,
    ``env_state`` / ``initial_env_state`` as :func:`state_from_numpy`
    takes them, ``key`` the int64 key words, ``obs`` an array or None,
    ``h`` a float array cast to ``h_dtype``. This is how a test starts
    both packages from one JAX ``init_*_train_state``."""
    from .parallel.learner import RecurrentTrainState, TrainState

    common = dict(
        params={k: torch.tensor(v, dtype=torch.float32, device=device)
                for k, v in state_from_flax(arrays["params"]).items()},
        opt_state=opt_state_from_optax(arrays["opt_state"], device),
        env_state=state_from_numpy(arrays["env_state"], device),
        initial_env_state=state_from_numpy(arrays["initial_env_state"], device),
        key=torch.as_tensor(np.asarray(arrays["key"]).astype(np.int64), device=device))
    if "h" in arrays:
        h = torch.as_tensor(np.asarray(arrays["h"], np.float32), device=device).to(h_dtype)
        return RecurrentTrainState(h=h, **common)
    obs = arrays.get("obs")
    obs = None if obs is None else torch.as_tensor(np.asarray(obs), device=device)
    return TrainState(obs=obs, **common)


def train_state_to_numpy(ts) -> dict:
    """Inverse of :func:`train_state_from_numpy` (``h`` as float32)."""
    out = {"params": state_to_flax(ts.params), "opt_state": opt_state_to_numpy(ts.opt_state),
           "env_state": state_to_numpy(ts.env_state),
           "initial_env_state": state_to_numpy(ts.initial_env_state),
           "key": ts.key.cpu().numpy()}
    if hasattr(ts, "h"):
        out["h"] = ts.h.float().cpu().numpy()
    else:
        out["obs"] = None if ts.obs is None else ts.obs.float().cpu().numpy()
    return out
