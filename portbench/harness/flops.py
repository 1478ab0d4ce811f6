"""Useful FLOPs of a training step: the plain reference's step, counted by
``torch.utils.flop_counter``'s rules on the meta device.

The reference does no recomputation, so what it executes is the work the
step needs: the forwards, the backwards and the R1 / path-length double
backwards, every convolution, linear layer and attention product at 2
FLOPs a multiply-accumulate, and nothing elementwise (a grouped
convolution's weight gradient counted once, where the registry counts it
once per group).  On the meta device nothing is computed and nothing
allocated, so the count at full width takes seconds of host time.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from portbench.harness import weights
from portbench.reference import train as ref_train


CONV_BACKWARD = torch.ops.aten.convolution_backward


def conv_backward_flops(args, out) -> int:
    """``flop_registry``'s count of a convolution's backward, with the
    weight gradient of a grouped convolution divided by its groups: the
    registry counts that term as if every group's input met every group's
    output gradient, ``groups`` times the work (the reference runs each
    modulated convolution as one convolution with a group per sample)."""
    count = flop_registry[CONV_BACKWARD]
    a = list(args)
    grad_in, grad_w, grad_b = a[10]
    a[10] = [grad_in, False, grad_b]
    total = count(*a, out_val=out)
    if grad_w:
        a[10] = [False, True, False]
        total += count(*a, out_val=out) // a[9]
    return total


class CountFlops(TorchDispatchMode):
    """Sum ``flop_registry``'s count over every op dispatched inside, the
    grouped convolutions' weight gradients counted once (see
    ``conv_backward_flops``).  (``FlopCounterMode`` itself tracks modules
    with backward hooks that ``torch.autograd.grad(..., inputs=...)``
    refuses.)"""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._overloadpacket is CONV_BACKWARD and not kwargs:
            self.total += int(conv_backward_flops(args, out))
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.total += int(count(*args, **kwargs, out_val=out))
        return out


def draws(m: dict, batch: int, path_batch: int, device) -> dict:
    t, dim, size = m["n_tokens"], m["style_dim"], m["size"]

    def codes(n):
        return (torch.zeros(n, t, dim, device=device),
                torch.zeros(n, t, m["param_dim"], device=device))

    return {"d": codes(batch), "g": codes(batch),
            "path": (*codes(path_batch),
                     torch.zeros(path_batch, size, size, 3, device=device))}


def step_flops(m: dict, tcfg: dict, batch: int, path_batch: int, r1: bool,
               path: bool, device="meta") -> int:
    g, d = weights.templates(m, device)
    st = ref_train.init(g, d, tcfg)
    real = torch.zeros(batch, m["size"], m["size"], 3, dtype=torch.uint8,
                       device=device)
    dr = draws(m, batch, path_batch, device)
    with CountFlops() as c:
        ref_train.step(st, real, dr, tcfg, r1, path)
    return c.total


@functools.lru_cache(maxsize=16)
def _cached(key) -> int:
    m, tcfg, batch, path_batch, r1, path = key
    return step_flops(dict(m), dict(tcfg), batch, path_batch, r1, path)


def train_step_flops(m: dict, tcfg: dict, batch: int, path_batch: int,
                     r1: bool, path: bool) -> int:
    key = (tuple(sorted((k, v) for k, v in m.items()
                        if not isinstance(v, list))),
           tuple(sorted(tcfg.items())), batch, path_batch, r1, path)
    return _cached(key)
