"""Column-parallel compute on the mesh's ``model`` axis.

A layer whose output channels are split over a model group
(``parallel/mesh.py::param_partition_spec``) computes only its rank's
output slice from the full input, runs its per-channel epilogue on the
slice (demodulation, bias, activation; for an up-conv the
``fused_blur4`` pass), and gathers the slices back into the full
activation.  Every rank of the group holds the same rows and computes
the same loss, so three operations make the gradients right, each
differentiable to any order (R1 and the path-length regulariser take a
gradient of a gradient):

  * ``copy_in``: the identity; its backward sums the gradient over the
    model group (each rank's slice sees only its part of d loss / d
    input);
  * ``gather_out``: all-gathers the slices; its backward keeps this
    rank's slice of the gradient (every rank holds the whole gradient
    of the same loss; a sum would count it n times);
  * ``slice_of``: this rank's slice of a replicated tensor (a bias the
    epilogue applies to the slice); its backward all-gathers, so every
    rank holds the whole gradient, and a replicated tensor's gradient
    is summed over the data axis alone.

The backwards are each other's pair (copy with sum, gather with slice),
never a plain all-reduce or a plain slice: the second derivative of a
copy is a copy.  ``torch.distributed.nn.functional.all_reduce``, whose
backward all-reduces again, would count a regulariser's gradient
``n_model`` times, since every rank's cotangent is the whole one.

``axis`` is a ``parallel/mesh.py::Mesh``: its ``model_group``,
``n_model`` and ``model_index``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _group(axis):
    return axis.model_group or dist.group.WORLD


def _all_gather(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
    t = t.contiguous()
    buf = t.new_empty(axis.n_model * t.numel())
    dist.all_gather_into_tensor(buf, t.reshape(-1), group=_group(axis))
    return torch.cat(buf.view(axis.n_model, *t.shape).unbind(0), dim=dim)


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.axis), None


class _Sum(torch.autograd.Function):
    """The sum over the group of per-rank parts; the gradient of the
    (replicated) sum is every part's: the identity."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        out = x.clone()
        dist.all_reduce(out, group=_group(axis))
        return out

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.axis), None


class _Gather(torch.autograd.Function):
    """Every rank's slice concatenated; the gradient keeps this rank's."""

    @staticmethod
    def forward(ctx, y, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(y, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _Slice.apply(g, ctx.axis, ctx.dim), None, None


class _Slice(torch.autograd.Function):
    """This rank's slice of a replicated tensor; the gradient is every
    rank's slice gathered."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        size = t.shape[dim] // axis.n_model
        return t.narrow(dim, axis.model_index * size, size).clone()

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.axis, ctx.dim), None, None


def copy_in(x: torch.Tensor, axis) -> torch.Tensor:
    """``x``, whose gradient is summed over ``axis``'s model group."""
    return _Copy.apply(x, axis)


def gather_out(y: torch.Tensor, axis, dim: int = -1) -> torch.Tensor:
    """Every model rank's slice ``y`` concatenated along ``dim``, in rank
    order; the gradient keeps this rank's slice."""
    return _Gather.apply(y, axis, dim % y.dim())


def slice_of(t: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """This model rank's slice of the replicated ``t`` along ``dim``; the
    gradient is all-gathered back to ``t``'s shape."""
    return _Slice.apply(t, axis, dim % t.dim())
