"""Data-parallel training and coordinate-sharded decode on ``torch.distributed``.

Counterpart of ``enf_pde_tpu/parallel/mesh.py``. JAX places one program over a device
mesh and lets GSPMD insert the collectives; here there is one process per card (as
``torchrun`` starts them), and the collectives are explicit:

- **Training**: every rank holds the whole state and takes its rows of each global
  batch (``shard_batch``); the trainers all-reduce the gradient groups and the loss to
  their global means before the optimizers (``mean_over_ranks``), so each rank applies
  the same update. Random draws are taken at the global batch's shape on every rank and
  sliced to the rank's rows, so a world of W computes what one process computes on the
  whole batch.
- **Decoding**: the softmax is over latents, so coordinates are independent:
  ``sharded_decode`` decodes the rank's coordinate shard and ``all_gather``s the
  shards.

A ``Mesh`` is the process group with its rank, world size and device. Without an
initialised group it is a world of 1 that makes no collective call. The backend is
NCCL on cards and gloo on the CPU. Gloo reduces and broadcasts CUDA tensors but does
not gather them, so under gloo every collective stages its tensors through the CPU: a
rule chosen by the backend, never a retry after a failure.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_mesh",
    "data_sharding",
    "shard_batch",
    "replicate",
    "mean_over_ranks",
    "all_gather",
    "shard_train_step",
    "sharded_decode",
    "on_rank0",
]

# How long the other ranks wait while rank 0 works alone (data generation, the
# autodecoding baseline): hours, where a collective's own timeout is minutes.
RANK0_WAIT = datetime.timedelta(days=7)


@dataclass(frozen=True)
class Mesh:
    """A 1D data axis: ``group`` (None for a world of 1 without torch.distributed),
    this process's ``rank`` in it, the world ``size``, this rank's ``device`` and the
    group's ``backend``."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.backend == "gloo" else x


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of the initialised process group (``torchrun``, or a test's
    ``init_process_group``), or a world of 1 when there is none.

    ``device`` is this rank's device; by default the current card under NCCL, else the
    CPU (with no group: the card).
    """
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(None, 0, 1, torch.device(device or "cuda"))
    group = group or dist.group.WORLD
    backend = dist.get_backend(group)
    if device is None:
        device = f"cuda:{torch.cuda.current_device()}" if backend == "nccl" else "cpu"
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), torch.device(device),
                backend)


def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a leading axis of ``n``: the rank-th of ``size`` equal
    contiguous blocks. ``n`` must divide by the world size, as JAX's rule."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not divide over a world of {mesh.size} ranks")
    rows = n // mesh.size
    return slice(mesh.rank * rows, (mesh.rank + 1) * rows)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (a tensor, an array, or a tuple / list / dict
    of them), on the rank's device. Arrays are sliced before they are copied."""

    def take(x):
        x = x[data_sharding(mesh, len(x))]
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(mesh.device)

    return _tree_map(take, batch)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def replicate(tree, mesh: Mesh):
    """Broadcast every tensor of ``tree`` from rank 0, in place; returns ``tree``."""
    if mesh.group is None:
        return tree
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for x in _leaves(tree):
            staged = mesh._staged(x)
            dist.broadcast(staged, src=src, group=mesh.group)
            if staged is not x:
                x.copy_(staged)
    return tree


def mean_over_ranks(tensors: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """The mean over the ranks of each tensor (all of one dtype and device), in one
    all-reduce of their flat concatenation; returns new tensors, the inputs untouched."""
    tensors = list(tensors)
    if mesh.group is None or not tensors:
        return tensors
    flat = mesh._staged(torch.cat([t.detach().reshape(-1) for t in tensors]))
    dist.all_reduce(flat, group=mesh.group)
    flat = (flat / mesh.size).to(tensors[0].device)
    return [part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    if mesh.group is None:
        return x
    staged = mesh._staged(x.contiguous())
    parts = [torch.empty_like(staged) for _ in range(mesh.size)]
    dist.all_gather(parts, staged, group=mesh.group)
    return torch.cat(parts, dim=dim).to(x.device)


def shard_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """A ``(state, global_batch, **draws) -> (loss, state)`` step that runs ``step_fn``
    on this rank's rows. ``step_fn`` is a step of a trainer built with ``mesh=``, which
    all-reduces the gradients and the loss; the state is replicated by construction."""

    def step(state, batch, **kwargs):
        return step_fn(state, shard_batch(batch, mesh), **kwargs)

    return step


def sharded_decode(decode_fn: Callable, mesh: Mesh, dim: int = -2) -> Callable:
    """A full-field decode with the coordinate axis sharded across the ranks.

    Returns ``decode(coords, *args, **kwargs)``: ``coords`` [..., N, coord_dim] (the
    coordinate axis ``dim`` of ``coords``), of which the rank decodes its shard with
    ``decode_fn(shard, *args, **kwargs)``; the shards of the output are gathered along
    the same axis ``dim`` of the output. N must divide by the world size.
    """

    def decode(coords, *args, **kwargs):
        n = coords.shape[dim]
        rows = data_sharding(mesh, n)
        shard = coords.narrow(dim, rows.start, rows.stop - rows.start)
        return all_gather(decode_fn(shard, *args, **kwargs), mesh, dim)

    return decode


def on_rank0(fn: Callable, mesh: Optional[Mesh]):
    """Run ``fn`` on rank 0 only; the other ranks wait at a barrier of a gloo group of
    their own, whose timeout (``RANK0_WAIT``) outlasts hours of work. Returns what
    ``fn`` returns on rank 0 and None elsewhere."""
    if mesh is None or mesh.group is None:
        return fn()
    waiting = dist.new_group(backend="gloo", timeout=RANK0_WAIT)
    try:
        result = fn() if mesh.is_main else None
        dist.barrier(group=waiting)
    finally:
        dist.destroy_process_group(waiting)
    return result
