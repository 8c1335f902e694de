"""Checkpoint and resume.

Counterpart of ``pogema_tpu/utils/checkpoint.py`` (orbax there). A
checkpoint is ONE file: ``torch.save`` of tensors inside plain containers
(dicts, lists, numbers, strings, None), read back with
``torch.load(weights_only=True)``, so loading one runs no pickled code.
Dataclasses (``EnvState``, ``TrainState``, ...) are saved as dicts of
their fields and numpy arrays as tensors; pass ``like`` to
:func:`restore_checkpoint` to get the original types, dtypes and device
back. Keys are int64 key words already and need no conversion.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def _to_plain(tree):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _to_plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_plain(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(tree))
    return tree


def _as_like(plain, like, where="checkpoint"):
    if like is None:
        if plain is not None:
            raise ValueError(f"{where}: saved a value where the template has None")
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        names = [f.name for f in dataclasses.fields(like)]
        if set(names) != set(plain):
            raise ValueError(f"{where}: fields differ: {sorted(set(names) ^ set(plain))}")
        return type(like)(**{n: _as_like(plain[n], getattr(like, n), f"{where}.{n}")
                             for n in names})
    if isinstance(like, dict):
        if set(like) != set(plain):
            raise ValueError(f"{where}: keys differ: {sorted(set(like) ^ set(plain), key=str)}")
        return {k: _as_like(plain[k], v, f"{where}[{k!r}]") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if len(like) != len(plain):
            raise ValueError(f"{where}: length {len(plain)} != {len(like)}")
        return type(like)(_as_like(p, v, f"{where}[{i}]")
                          for i, (p, v) in enumerate(zip(plain, like)))
    if isinstance(like, torch.Tensor):
        if tuple(plain.shape) != tuple(like.shape):
            raise ValueError(f"{where}: shape {tuple(plain.shape)} != {tuple(like.shape)}")
        return plain.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (np.ndarray, np.generic)):
        return plain.numpy().astype(like.dtype)
    return type(like)(plain)


def save_checkpoint(path: str, tree) -> None:
    """Save a tree (EnvState, TrainState, params dict, ...) to the file
    ``path``.

    Crash-safe overwrite: the new checkpoint is written whole to a
    sibling ``<path>.next`` first, then swapped in (the old one renamed
    to ``<path>.bak`` until the swap has landed). A process killed at
    ANY point leaves a complete checkpoint on disk, the old or the new."""
    path = os.path.abspath(path)
    new, bak = path + ".next", path + ".bak"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_to_plain(tree), new)
    if not os.path.exists(path):
        # Post-crash state (only .bak and/or .next exist): promote the
        # new file FIRST, so that a kill while the .bak goes cannot leave
        # only the unrecognised .next behind.
        os.rename(new, path)
        if os.path.exists(bak):
            os.remove(bak)
        return
    if os.path.exists(bak):
        os.remove(bak)
    os.rename(path, bak)
    os.rename(new, path)
    os.remove(bak)


def checkpoint_exists(path: str) -> bool:
    """True if ``path`` (or its crash-recovery ``.bak``) holds a
    restorable checkpoint."""
    path = os.path.abspath(path)
    return os.path.exists(path) or os.path.exists(path + ".bak")


def restore_checkpoint(path: str, like=None):
    """Restore a tree. Without ``like`` the plain containers come back
    with every tensor on the CPU. With ``like`` (a tree of the same
    structure, such as a fresh ``reset`` or ``init_*_train_state``) the
    result has its dataclass types, its dtypes and its device. Falls
    back to ``<path>.bak`` when the main file is missing (a crash between
    the swap renames of :func:`save_checkpoint`)."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".bak"):
        path = path + ".bak"
    plain = torch.load(path, map_location="cpu", weights_only=True)
    return plain if like is None else _as_like(plain, like)


def extract_params_from_state(state_path: str, params_path: str | None = None):
    """The model parameters out of a FULL train-state checkpoint (the
    ``<checkpoint>_state`` file of ``examples/train_ppo_cuda.py
    --checkpoint-every``, structure ``{"iter", "ts"}``), without the
    model or env that a ``like`` template would need.

    Returns ``(iter, params)``. With ``params_path`` the parameters are
    also saved there as a regular params checkpoint (what
    ``--init-params`` loads): the way to recover a policy from an
    interrupted run whose final params were never written."""
    tree = restore_checkpoint(state_path)
    if not (isinstance(tree, dict) and "ts" in tree and "iter" in tree):
        raise ValueError(
            f"{state_path} is not a TrainState checkpoint "
            f"(expected {{'iter', 'ts'}} structure, got "
            f"{sorted(tree) if isinstance(tree, dict) else type(tree)})")
    params = tree["ts"]["params"]
    it = int(tree["iter"])
    if params_path is not None:
        save_checkpoint(params_path, params)
    return it, params
