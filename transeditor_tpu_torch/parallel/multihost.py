"""Multi-process launch plumbing on ``torch.distributed``
(``transeditor_tpu/parallel/multihost.py``).

One process per card, as the reference launches them
(``torch.distributed.launch`` / ``torchrun``): ``initialize`` reads the
launcher's environment and joins the process group, NCCL on the card and
gloo when the caller asks for the CPU.  Every helper degrades to a no-op
for a single process, or a group of one, so one training entry point
serves both (``multi_process``).

Environment (set by ``torchrun``):
  * ``WORLD_SIZE``  - number of processes
  * ``RANK``        - this process's rank
  * ``LOCAL_RANK``  - this process's card on its host
  * ``MASTER_ADDR``, ``MASTER_PORT`` - rank 0's rendezvous address
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from transeditor_tpu_torch.device import resolve_device


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(device: str | torch.device | None = None) -> bool:
    """Join the process group described by the environment, then run
    :func:`warmup_collectives`; returns True if a group is (or already
    was) initialised, False when ``WORLD_SIZE`` is not set (nothing is
    done then).

    ``device`` (default "cuda") picks the backend: NCCL, after
    ``torch.cuda.set_device(LOCAL_RANK)``, or gloo for "cpu".
    """
    if dist.is_initialized():
        return True
    world = _env_int("WORLD_SIZE")
    if world is None:
        return False
    dev = resolve_device(device)
    rank = _env_int("RANK") or 0
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
               if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {', '.join(missing)} "
                           f"is not: launch with torchrun, or set them")
    addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    kw = {}
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK") or 0
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank, **kw)
    warmup_collectives()
    return True


def shutdown() -> None:
    """Leave the process group, if one is initialised."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _collective_device() -> torch.device:
    """The device the process group's collectives take tensors on."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def warmup_collectives() -> None:
    """One small all-reduce, checked.

    It creates the backend's communicators while every process is still
    in step from the rendezvous (NCCL and gloo set them up lazily, in
    the first collective, under a connection deadline that a peer still
    compiling or loading would otherwise eat into), and it makes a
    broken link fail here, with a clear message, instead of inside the
    first training step.
    """
    if not dist.is_initialized():
        return
    x = torch.ones(1, device=_collective_device())
    dist.all_reduce(x)
    total, world = float(x.item()), dist.get_world_size()
    if abs(total - world) > 0.5:
        raise RuntimeError(f"collective warm-up all-reduce returned {total}, "
                           f"expected {world}: the process group is "
                           f"unhealthy")


def multi_process() -> bool:
    """Whether a process group of more than one process is initialised.
    Every collective of the port (here, in ``data_parallel`` and in the
    discriminator) runs only then: in a group of one each would be the
    identity, and would still cost a launch and a synchronisation."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    """This process's rank (the reference ``get_rank()``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """World size (the reference ``get_world_size()``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """The rank-0 gate for logs, samples and checkpoints."""
    return process_index() == 0


def local_batch_size(global_batch: int, mesh=None) -> int:
    """This process's share of the global batch: 1/n of every global
    batch over the ``n`` ranks of the data axis (``mesh``'s, else the
    world's), as a DistributedSampler; the ranks of one model group load
    the same rows."""
    n = process_count() if mesh is None else mesh.n_data
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} data ranks")
    return global_batch // n


def synchronize() -> None:
    """Barrier across processes; a no-op for one process."""
    if multi_process():
        dist.barrier()


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack(list(t)) for t in zip(*trees))
    return np.stack([np.asarray(t) for t in trees])


def all_gather_host(data):
    """Every process's ``data`` (nested dicts / lists / tuples of arrays
    or numbers), each leaf stacked with a leading process axis (the
    reference's pickle ``all_gather``).  For one process: the length-1
    axis alone."""
    if not multi_process():
        return _stack([data])
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, data)
    return _stack(out)


def reduce_loss_dict(metrics: dict) -> dict:
    """The mean of each scalar over processes, on every process (the
    reference's ``reduce_loss_dict`` reduces to rank 0 only)."""
    if not multi_process():
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32)
                        .reshape(()).to(_collective_device())
                        for k in keys])
    dist.all_reduce(vals)
    vals = (vals / dist.get_world_size()).tolist()
    return dict(zip(keys, vals))


def any_flag(flag: bool) -> bool:
    """OR of a local flag over processes.

    A shutdown signal reaches each process on its own, so the loop never
    acts on its local flag: one process leaving while its peers are in
    the next step's collectives would hang them all.  Every process
    calls this at the same point of each step, and all see True at the
    same step.  For one process it costs nothing."""
    if not multi_process():
        return bool(flag)
    x = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_collective_device())
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return bool(x.item())


def broadcast_from_main(data):
    """Rank 0's ``data`` (any picklable value) on every process."""
    if not multi_process():
        return data
    box = [data]
    dist.broadcast_object_list(box, src=0)
    return box[0]
