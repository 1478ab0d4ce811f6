"""Data parallelism over a ``torch.distributed`` process group: the
counterpart of the JAX package's ``data`` mesh axis
(``transeditor_tpu/parallel/mesh.py``).

Each process holds a replica of every module and 1/world of the global
batch.  The train step (``train/gan.py``) scales each loss to its local
share of the global mean and sums the gradients over processes with
``all_reduce_grads``, so every replica applies the global gradient.
Statistics of the whole batch (the path-length mean, the discriminator's
minibatch stddev) are summed across processes with the differentiable
``all_reduce_sum``, whose backward sums the gradients of every
process's loss.

The modules are not wrapped in ``DistributedDataParallel``: the step
takes its gradients with ``torch.autograd.grad``, and DDP's reducer
hooks fire only under ``.backward()``, so a DDP wrapper would reduce
nothing, silently.

The global batch is laid out for gradient accumulation: with K
microbatches, process r holds its contiguous 1/world of each global
microbatch (``local_rows``), so a microbatch step over the processes is
the one-process step on that global microbatch.

Under a (data, model) mesh (``parallel/mesh.py``) the batch is split
over the mesh's data axis, not over the world: each function takes the
``mesh`` and then works over its data group, whose ranks hold
different rows (the ranks of one model group hold the same rows).
Without a mesh the data axis is the whole process group.

Without a process group of more than one process
(``multihost.multi_process``), or on a mesh whose data axis is a single
rank, every function here is the identity (or the local mean) and runs
no collective.
"""

from __future__ import annotations

import itertools
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from transeditor_tpu_torch.parallel import multihost

# gradients go out in flat buckets of one dtype, each at most this many
# elements (64 MiB of float32)
BUCKET_ELEMENTS = 1 << 24


def data_axis(mesh=None) -> Tuple[int, int, Optional[object], bool]:
    """(size, this rank's index, process group, whether its collectives
    run) of the data axis: ``mesh``'s (``parallel/mesh.py::Mesh``), or
    without one the whole process group (group ``None``: the world)."""
    if mesh is None:
        return (multihost.process_count(), multihost.process_index(), None,
                multihost.multi_process())
    return mesh.n_data, mesh.data_index, mesh.data_group, mesh.data_active


def buckets(tensors: Sequence[torch.Tensor],
            indices: Optional[Iterable[int]] = None) -> List[List[int]]:
    """The indices of ``tensors`` (all, or ``indices``) in buckets of one
    device and dtype, each of at most ``BUCKET_ELEMENTS`` elements (or
    one larger tensor), in order."""
    groups: dict = {}
    for i in range(len(tensors)) if indices is None else indices:
        groups.setdefault((tensors[i].device, tensors[i].dtype),
                          []).append(i)
    out = []
    for idx in groups.values():
        bucket, size = [], 0
        for i in idx:
            if bucket and size + tensors[i].numel() > BUCKET_ELEMENTS:
                out.append(bucket)
                bucket, size = [], 0
            bucket.append(i)
            size += tensors[i].numel()
        out.append(bucket)
    return out


def all_reduce_grads(grads: List[torch.Tensor],
                     mesh=None) -> List[torch.Tensor]:
    """The sum of ``grads`` over the data axis (same order, shapes,
    dtypes).

    Gradients are packed into flat buckets of one dtype and device, each
    all-reduced once, then unpacked into new tensors."""
    _, _, group, active = data_axis(mesh)
    if not active:
        return grads
    out = list(grads)
    for bucket in buckets(grads):
        flat = torch.cat([grads[i].reshape(-1) for i in bucket])
        dist.all_reduce(flat, group=group)
        parts = flat.split([grads[i].numel() for i in bucket])
        for i, part in zip(bucket, parts):
            out[i] = part.view_as(grads[i])
    return out


def broadcast_module(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers into every process's
    ``module``, in place."""
    if not multihost.multi_process():
        return
    with torch.no_grad():
        for t in itertools.chain(module.parameters(), module.buffers()):
            dist.broadcast(t.data, src=0)


def all_reduce_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the data axis, differentiable to any order:
    its backward sums the incoming gradients over the axis, so a loss
    reaching the result on every rank counts once per rank.  Without a
    process group: ``x``."""
    _, _, group, active = data_axis(mesh)
    if not active:
        return x
    return dist_fn.all_reduce(x, group=group or dist.group.WORLD)


def global_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean of ``x`` over the global batch (every data rank holds the
    same number of rows), differentiable; the local mean without a
    process group."""
    n, _, _, active = data_axis(mesh)
    if not active:
        return x.mean()
    return all_reduce_sum(x.sum(), mesh) / (x.numel() * n)


def local_rows(t: torch.Tensor, n_accum: int = 1, mesh=None) -> torch.Tensor:
    """This data rank's rows of a global-batch tensor of ``n_accum``
    microbatches: its contiguous 1/n of each microbatch, in order.
    Data rank r's local microbatch k is then rows r*m .. r*m + m - 1 of
    global microbatch k (m rows a rank), the numbering the
    discriminator's minibatch stddev uses.  For ``n_accum`` 1: rows
    r*b .. r*b + b - 1.  With a data axis of one rank: ``t``."""
    n, index, _, _ = data_axis(mesh)
    if n == 1:
        return t
    if t.shape[0] % (n_accum * n):
        raise ValueError(f"a global batch of {t.shape[0]} does not split "
                         f"into {n_accum} microbatches over {n} "
                         f"data ranks")
    rows = t.reshape(n_accum, n, -1, *t.shape[1:])
    return rows[:, index].reshape(-1, *t.shape[1:])
