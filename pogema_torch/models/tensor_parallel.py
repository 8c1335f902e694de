"""Tensor parallelism over the ``'model'`` axis of a mesh.

The JAX package annotates the trunk and the GRU gates as sharded over
``'model'`` (``models.partition_params``) and lets GSPMD place the
collectives. Here each rank holds its slice of those layers
(``torch.nn.Linear`` keeps ``weight`` as ``[out, in]``, so flax's
``P(None, 'model')`` on the ``[in, out]`` kernel is a split of the
weight along dim 0) and the forward calls two collectives, each an
autograd function:

* :func:`copy_to_model` before a sharded layer: the identity forward;
  backward, the sum over ``'model'`` of the input's gradient, since each
  rank's slice of the layer gives only its share of it;
* :func:`gather_from_model` after one: the slices concatenated in rank
  order; backward, this rank's slice of the gradient. Every rank of the
  group computes the same loss from the gathered values, so a sum there
  (``torch.distributed.nn.functional.all_gather``'s backward) would make
  the gradients ``model`` times too large.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_gather_cat, all_reduce_sum, axis_size

# Parameters split over 'model' (dim 0 of the torch tensor), by the
# module a name goes through: the trunk Dense and the six GRU gates.
SHARDED_MODULES = ("trunk", "gru")


def is_sharded(name: str) -> bool:
    """Whether the parameter ``name`` (``'gru.hr.weight'``) is split over
    ``'model'``."""
    return any(part in SHARDED_MODULES for part in name.split(".")[:-1])


class ModelAxis:
    """The ``'model'`` axis of ``mesh`` as a forward pass sees it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.get_group("model")
        self.rank = mesh.get_local_rank("model")
        self.size = axis_size(mesh, "model")

    def slice(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part of ``x`` along ``dim``."""
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                             f"{self.size} model ranks")
        k = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * k, k)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_gather_cat(x, axis.group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.slice(g, -1).contiguous(), None


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` unchanged, with the backward summing its gradient over
    ``'model'``; the identity without an axis."""
    return x if axis is None else _Copy.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """The ranks' slices of the last axis, concatenated; the backward
    keeps this rank's slice. The identity without an axis."""
    return x if axis is None else _Gather.apply(x, axis)


def partition(params: dict, axis) -> dict:
    """``{name: tensor}`` -> this rank's slices of the sharded entries,
    the rest as they are."""
    return {k: axis.slice(v, 0).clone() if is_sharded(k) else v for k, v in params.items()}


def unpartition(params: dict, axis) -> dict:
    """Inverse of :func:`partition`: the sharded entries gathered over
    ``'model'`` (a collective call)."""
    return {k: all_gather_cat(v, axis.group, dim=0) if is_sharded(k) else v
            for k, v in params.items()}


@torch.no_grad()
def shard_module(model, mesh) -> None:
    """Make ``model`` tensor-parallel over ``mesh``'s ``'model'`` axis: its
    sharded parameters become this rank's slices (taken from the full
    ones it holds) and its forward calls the collectives. A mesh with one
    model rank changes nothing. Calling it again with the same mesh does
    nothing."""
    current = getattr(model, "model_axis", None)
    if current is not None:
        if current.mesh is not mesh:
            raise ValueError("the model is already sharded over another mesh")
        return
    if axis_size(mesh, "model") == 1:
        return
    axis = ModelAxis(mesh)
    for name, p in list(model.named_parameters()):
        if is_sharded(name):
            owner, attr = model.get_submodule(name.rsplit(".", 1)[0]), name.rsplit(".", 1)[1]
            setattr(owner, attr, torch.nn.Parameter(axis.slice(p.detach(), 0).clone()))
    model.model_axis = axis
