"""The device mesh over processes: one rank per card, launched by
``torchrun``.

Counterpart of ``pogema_tpu/parallel/mesh.py``. JAX runs one process
over many devices and XLA places the collectives of one global program;
here each rank is a process of its own that holds its slice of the
batch, and the learner and the models call the collectives themselves
(``torch.distributed``: NCCL between cards, gloo on the CPU).

Axes, as there:

* ``'data'``: env-batch data parallelism. A rank holds the envs ``[lo,
  hi)`` of its data coordinate (:func:`data_rows`), steps them, and the
  learner sums its gradients and statistics over ``'data'``.
* ``'model'``: tensor parallelism of the trunk and of the GRU gates
  (``models.partition_params``); the ranks of one model group hold the
  same envs.

The functions below count the bytes they move, per call, in
``all_reduce_sum.bytes`` and ``all_gather_cat.bytes`` (the tensor's
bytes for an all-reduce, the gathered result's for an all-gather).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

AXES = ("data", "model")


def _device_type(device) -> str:
    return torch.device(device).type


def initialize_distributed(backend=None, device="cuda", **kwargs) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), or the one that ``kwargs`` give
    ``init_process_group`` (``init_method``, ``rank``, ``world_size``).

    ``backend`` defaults to ``'nccl'`` for ``device='cuda'`` and
    ``'gloo'`` for ``'cpu'``; a backend that fails to start raises, no
    other is tried. On the card the rank's device is set to
    ``LOCAL_RANK`` first. Does nothing, and returns False, when the world
    has one process or a process group already exists; True when this
    call joined one."""
    if dist.is_initialized():
        return False
    world = int(kwargs.get("world_size", os.environ.get("WORLD_SIZE", "1")))
    if world <= 1:
        return False
    kind = _device_type(device)
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, **kwargs)
    return True


def make_mesh(data: int = -1, model: int = 1, devices=None, device="cuda"):
    """``DeviceMesh`` with dims ``('data', 'model')`` over all ranks (or
    the global ranks ``devices``, in mesh order). ``data=-1`` means "all
    remaining". A collective call: every rank of the world makes the
    same mesh.

    In a lone process with no process group, a world of one is set up
    first (nccl for ``device='cuda'``, gloo for ``'cpu'``), so that the
    same code runs on one card, as JAX's mesh does on one chip."""
    from torch.distributed.device_mesh import DeviceMesh

    kind = _device_type(device)
    if not dist.is_initialized():
        if kind == "cuda":  # the communicator's device, before the group exists
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", store=dist.HashStore(),
                                rank=0, world_size=1)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    if data == -1:
        if n % model:
            raise AssertionError((n, model))
        data = n // model
    if data * model != n:
        raise AssertionError(f"{data}x{model} != {n} devices")
    return DeviceMesh(kind, torch.tensor(ranks).reshape(data, model), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[AXES.index(axis)]


def data_rows(mesh, n: int) -> tuple:
    """``(lo, hi)``: the rows of a global batch of ``n`` that this rank
    holds, by its data coordinate (even shards, as ``P('data')``)."""
    d = axis_size(mesh, "data")
    if n % d:
        raise ValueError(f"a batch of {n} does not split evenly over {d} data ranks")
    lo = mesh.get_local_rank("data") * (n // d)
    return lo, lo + n // d


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _rows_of(x, mesh):
    if x.ndim == 0:
        return x
    lo, hi = data_rows(mesh, x.shape[0])
    return x[lo:hi].clone()


def shard_batch(tree, mesh):
    """This rank's rows of every tensor of ``tree`` (tensors, dicts,
    lists, dataclasses such as ``EnvState``) along the leading batch
    axis, by its data coordinate: sharded over ``'data'``, replicated
    over ``'model'``. Scalars are left as they are; key leaves ``[B, 2]``
    carry the batch axis and are split on it. The rows are copies, so
    the global batch can be freed."""
    return _tree_map(lambda x: _rows_of(x, mesh) if isinstance(x, torch.Tensor) else x, tree)


def global_batch_from_host(tree, mesh, device=None):
    """The multi-process form of :func:`shard_batch`: every rank holds
    the same host tree (numpy arrays or CPU tensors; a deterministic
    reset makes that cheap and safe) and moves only its own rows to
    ``device`` (default: the mesh's device type, the current card for
    'cuda')."""
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device("cpu"))

    def put(x):
        if not isinstance(x, torch.Tensor):
            if not hasattr(x, "shape"):
                return x
            x = torch.as_tensor(x)
        return _rows_of(x, mesh).to(device)

    return _tree_map(put, tree)


def batch_sharding(mesh) -> tuple:
    """The placements of a batch on ``mesh``: sharded on dim 0 over
    ``'data'``, replicated over ``'model'``."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh) -> tuple:
    """The placements of a tensor that every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


# -- collectives --------------------------------------------------------------


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group``, in a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    if dist.get_world_size(group) > 1:
        all_reduce_sum.bytes += out.numel() * out.element_size()
        dist.all_reduce(out, group=group)
    return out


all_reduce_sum.bytes = 0


# Types that neither gloo nor NCCL carry travel as a wider one.
_WIRE = {torch.bool: torch.uint8, torch.int16: torch.int32}


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The tensors ``x`` of the ranks of ``group``, in rank order,
    concatenated along ``dim``. An empty ``x`` gathers nothing: the
    caller's group then holds empty tensors of the same shape on every
    rank."""
    size = dist.get_world_size(group)
    if size == 1:
        return x
    shape = list(x.shape)
    shape[dim] *= size
    if x.numel() == 0:
        return x.new_empty(shape)
    src = x.to(_WIRE.get(x.dtype, x.dtype)).contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    all_gather_cat.bytes += out.numel() * out.element_size()
    return out.to(x.dtype)


all_gather_cat.bytes = 0


def gather_batch(tree, mesh):
    """Inverse of :func:`shard_batch`: every tensor of the rank-sharded
    ``tree`` all-gathered over ``'data'`` along its leading axis, so that
    each rank holds the global batch (what reading a global
    ``jax.Array`` on the host gives). Scalars are left as they are."""
    group = mesh.get_group("data")
    return _tree_map(lambda x: (all_gather_cat(x, group) if isinstance(x, torch.Tensor)
                                and x.ndim >= 1 else x), tree)
