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

Without a process group of more than one process
(``multihost.multi_process``) every function here is the identity (or
the local mean) and runs no collective.
"""

from __future__ import annotations

import itertools
from typing import List

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from transeditor_tpu_torch.parallel import multihost

# gradients go out in flat buckets of one dtype, each at most this many
# elements (64 MiB of float32)
BUCKET_ELEMENTS = 1 << 24


def all_reduce_grads(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of ``grads`` over processes (same order, shapes, dtypes).

    Gradients are packed into flat buckets of one dtype and device, each
    all-reduced once, then unpacked into new tensors."""
    if not multihost.multi_process():
        return grads
    groups: dict = {}
    for i, g in enumerate(grads):
        groups.setdefault((g.device, g.dtype), []).append(i)
    buckets = []
    for idx in groups.values():
        bucket, size = [], 0
        for i in idx:
            if bucket and size + grads[i].numel() > BUCKET_ELEMENTS:
                buckets.append(bucket)
                bucket, size = [], 0
            bucket.append(i)
            size += grads[i].numel()
        buckets.append(bucket)
    out = list(grads)
    for bucket in buckets:
        flat = torch.cat([grads[i].reshape(-1) for i in bucket])
        dist.all_reduce(flat)
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


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over processes, differentiable to any order: its
    backward sums the incoming gradients over processes, so a loss
    reaching the result on every process counts once per process.
    Without a process group: ``x``."""
    if not multihost.multi_process():
        return x
    return dist_fn.all_reduce(x)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over the global batch (every process holds the same
    number of rows), differentiable; the local mean without a process
    group."""
    if not multihost.multi_process():
        return x.mean()
    return all_reduce_sum(x.sum()) / (x.numel() * dist.get_world_size())


def local_rows(t: torch.Tensor, n_accum: int = 1) -> torch.Tensor:
    """This process's rows of a global-batch tensor of ``n_accum``
    microbatches: its contiguous 1/world of each microbatch, in order.
    Process r's local microbatch k is then rows r*m .. r*m + m - 1 of
    global microbatch k (m rows a process), the numbering the
    discriminator's minibatch stddev uses.  For ``n_accum`` 1: rows
    r*b .. r*b + b - 1.  Without a process group: ``t``."""
    world = multihost.process_count()
    if world == 1:
        return t
    if t.shape[0] % (n_accum * world):
        raise ValueError(f"a global batch of {t.shape[0]} does not split "
                         f"into {n_accum} microbatches over {world} "
                         f"processes")
    rows = t.reshape(n_accum, world, -1, *t.shape[1:])
    return rows[:, multihost.process_index()].reshape(-1, *t.shape[1:])
