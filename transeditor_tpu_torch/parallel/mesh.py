"""A (data, model) mesh of processes (``transeditor_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives.  Here the mesh is a layout of the process group that
``parallel/multihost.py`` joins (one process per card): rank r sits at
(r // n_model, r % n_model), as JAX's ``reshape(n_data, n_model)`` lays
out its devices.  The ranks of one row are a model group; the ranks of
one column a data group.

Axes:
  * ``data``: the batch.  Data ranks hold different rows of the global
    batch; gradients are summed over the data axis.
  * ``model``: the output-channel axis of wide kernels.  The ranks of a
    model group hold the same rows and draw the same latents.

``param_partition_spec`` is the JAX package's rule, applied to the
port's tensor layouts through the weight bridge's axis permutation
(``io/torch_export.py``): the output-channel axis of a large kernel
goes to ``model``, and with ``fsdp`` the largest remaining eligible
axis goes to ``data``.  ``ShardedParams`` keeps a module's parameters in
that layout between steps and gathers them for use: every rank stores
only its block of each sharded tensor, a step all-gathers the weights
over the data axis before it builds its graph (so they stay autograd
leaves and second order is untouched), reduce-scatters the gradients
over the data axis and steps the optimizer on the blocks.  On the model
axis the weights stay cut: each rank computes its output channels and
the slices are gathered (column-parallel compute,
``parallel/model_parallel.py``), so a rank's gradient of a model-sharded
weight is its slice's, and of every other tensor the whole.

``torch.distributed.fsdp`` is not used: the train step takes every
gradient with ``torch.autograd.grad``, and FSDP2's hooks reduce nothing
on that path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from transeditor_tpu_torch.parallel import multihost
from transeditor_tpu_torch.parallel.data_parallel import (all_reduce_grads,
                                                          buckets)


@dataclasses.dataclass
class Mesh:
    """This rank's place on a (data, model) mesh.

    ``data_group`` / ``model_group``: the process groups of this rank's
    data and model axes (``None``: the world, when the axis spans it).
    ``force``: run the data axis's collectives and apply its sharding
    rule even with one rank (JAX's rule is the identity there); it lets
    one card run the FSDP step's all-gathers and reduce-scatters in a
    group of one.  ``Mesh(n_data, n_model)`` without groups serves
    ``param_partition_spec``, which reads only the shape."""

    n_data: int
    n_model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    force: bool = False

    @property
    def data_active(self) -> bool:
        """Whether collectives over the data axis run."""
        return self.force or self.n_data > 1

    @property
    def model_active(self) -> bool:
        """Whether the model axis cuts tensors (more than one rank)."""
        return self.n_model > 1


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                force: bool = False) -> Mesh:
    """The (data, model) mesh over the process group (the world; one
    process without a group).  ``n_data`` defaults to world // n_model,
    and ``n_data * n_model`` must be the world size.  Every rank must
    call it, in the same order as any other group creation: it creates
    the axes' process groups."""
    world, rank = multihost.process_count(), multihost.process_index()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs "
                         f"{n_data * n_model} processes, the group has "
                         f"{world}")
    data_group = model_group = None
    if n_data > 1 and n_model > 1:
        # every rank creates every group, in one order
        for i in range(n_data):
            g = dist.new_group(list(range(i * n_model, (i + 1) * n_model)))
            if i == rank // n_model:
                model_group = g
        for j in range(n_model):
            g = dist.new_group(list(range(j, world, n_model)))
            if j == rank % n_model:
                data_group = g
    return Mesh(n_data, n_model, rank // n_model, rank % n_model,
                data_group, model_group, force)


# --------------------------------------------------------------------------
# the partition rule

_MAPPING = re.compile(r"mapping_network\.\d+\.(weight|bias)$")


def _jax_layout(name: str, shape: Tuple[int, ...]):
    """(the JAX leaf's shape, the port dim of each of its axes, or None)
    for a port parameter: the inverse of the weight bridge's transposes
    (``io/torch_export.py``).  A token mapping's layers are one stacked
    JAX leaf, [n, in, out] and [n, out]; its token axis (n = 16) is
    below every ``min_size`` the rule is used with, so it stands here at
    size 1 and never takes a mesh axis."""
    leaf = name.rsplit(".", 1)[-1]
    if _MAPPING.search(name):
        if leaf == "weight":                 # [out, in] of [n, in, out]
            return (1, shape[1], shape[0]), (None, 1, 0)
        return (1, shape[0]), (None, 0)      # [out] of [n, out]
    if leaf == "weight" and len(shape) == 5:  # [1, O, I, kh, kw] <- HWIO
        return (shape[3], shape[4], shape[2], shape[1]), (3, 4, 2, 1)
    if leaf == "weight" and len(shape) == 4:  # [O, I, kh, kw] <- HWIO
        return (shape[2], shape[3], shape[1], shape[0]), (2, 3, 1, 0)
    if leaf == "weight" and len(shape) == 2:  # [out, in] <- [in, out]
        return (shape[1], shape[0]), (1, 0)
    if len(shape) == 4 and shape[0] == shape[2] == shape[3] == 1:
        return (shape[1],), (1,)             # ToRGB bias [1, 3, 1, 1] <- [3]
    if shape == (1,) and leaf == "weight":
        return (), ()                        # noise weight <- scalar
    return tuple(shape), tuple(range(len(shape)))


def _jax_rule(shape: Tuple[int, ...], mesh: Mesh, min_size: int,
              fsdp: bool) -> list:
    """``transeditor_tpu/parallel/mesh.py::param_partition_spec`` on a
    JAX leaf shape (with ``mesh.force`` standing for a data axis of more
    than one rank)."""
    n_model, n_data = mesh.n_model, mesh.n_data
    spec = [None] * len(shape)
    if (mesh.model_active and len(shape) >= 2 and shape[-1] >= min_size
            and shape[-1] % n_model == 0):
        spec[-1] = "model"
    if fsdp and mesh.data_active and len(shape) >= 2:
        # the largest remaining eligible axis; ties to the lowest
        for ax in sorted(range(len(shape)), key=lambda a: -shape[a]):
            if (spec[ax] is None and shape[ax] >= min_size
                    and shape[ax] % n_data == 0):
                spec[ax] = "data"
                break
    return spec


def param_partition_spec(name: str, tensor, mesh: Mesh, min_size: int = 256,
                         fsdp: bool = False) -> Tuple[Optional[str], ...]:
    """The mesh axis (``"data"``, ``"model"`` or ``None``) of each dim of
    the port parameter ``name`` (its state-dict key) of full shape
    ``tensor.shape``: JAX's decision for the same logical tensor.

    The output-channel axis of a kernel of at least ``min_size`` takes
    ``model`` on a model axis of more than one rank: dim 0 of
    ``EqualLinear.weight`` [out, in] and ``EqualConv2d.weight``
    [O, I, k, k], dim 1 of ``ModulatedConv2d.weight`` [1, O, I, k, k].
    With ``fsdp`` on a data axis of more than one rank, the largest
    remaining axis of at least ``min_size`` that the axis divides takes
    ``data``, ties going to the lowest JAX axis.  Biases, the noise
    weight and small tensors stay replicated."""
    shape = tuple(tensor.shape)
    jax_shape, dims = _jax_layout(name, shape)
    spec = [None] * len(shape)
    for axis, dim in zip(_jax_rule(jax_shape, mesh, min_size, fsdp), dims):
        if axis is not None:
            spec[dim] = axis
    return tuple(spec)


# --------------------------------------------------------------------------
# sharded parameters

def _all_gather(shards: Sequence[torch.Tensor], dims: Sequence[int],
                indices: List[int], n: int, group) -> dict:
    """{i: the ``n`` ranks' ``shards[i]`` concatenated along ``dims[i]``}
    for ``i`` in ``indices``, in buckets of one all-gather each."""
    out = {}
    for bucket in buckets(shards, indices):
        flat = torch.cat([shards[i].reshape(-1) for i in bucket])
        buf = flat.new_empty(n * flat.numel())
        dist.all_gather_into_tensor(buf, flat, group=group)
        buf = buf.view(n, -1)
        off = 0
        for i in bucket:
            k = shards[i].numel()
            parts = buf[:, off:off + k].reshape(n, *shards[i].shape)
            out[i] = torch.cat(parts.unbind(0), dim=dims[i])
            off += k
    return out


def _reduce_scatter(grads: Sequence[torch.Tensor], dims: Sequence[int],
                    indices: List[int], n: int, group) -> dict:
    """{i: this rank's block of the sum over the ``n`` ranks of
    ``grads[i]``, cut into ``n`` along ``dims[i]``}, in buckets of one
    reduce-scatter each."""
    out = {}
    for bucket in buckets(grads, indices):
        rows = torch.cat([torch.stack([c.reshape(-1) for c in
                                       grads[i].chunk(n, dims[i])])
                          for i in bucket], dim=1)      # [n, bucket]
        mine = rows.new_empty(rows.shape[1])
        dist.reduce_scatter_tensor(mine, rows.reshape(-1), group=group)
        off = 0
        for i in bucket:
            shape = list(grads[i].shape)
            shape[dims[i]] //= n
            k = grads[i].numel() // n
            out[i] = mine[off:off + k].view(shape)
            off += k
    return out


class ShardedParams:
    """A module's parameters laid out on ``mesh`` by
    ``param_partition_spec`` (from their full shapes, when built).

    ``shard_()`` replaces each sharded parameter's data by this rank's
    block: its model slice (``model_index`` of ``n_model`` along the
    ``model`` dim), then its data slice of that.  ``gather_()`` sets the
    full tensors back from every rank's blocks (a collective: every rank
    calls it at the same point) and ``release_()`` returns to the
    blocks; between the two the module computes as an unsharded one.
    The ``Parameter`` objects stay the same, so an optimizer built on
    them steps the blocks, and its moments are blocks too."""

    def __init__(self, module: torch.nn.Module, mesh: Mesh,
                 min_size: int = 256, fsdp: bool = False):
        self.mesh = mesh
        named = list(module.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.full_shapes = [tuple(p.shape) for p in self.params]
        specs = [param_partition_spec(n, p, mesh, min_size, fsdp)
                 for n, p in named]
        self.model_dims = [s.index("model") if "model" in s else None
                           for s in specs]
        self.data_dims = [s.index("data") if "data" in s else None
                          for s in specs]
        self.specs = specs
        # the module whose forward reads each parameter
        self.owners = [module.get_submodule(n.rpartition(".")[0])
                       for n in self.names]
        self._blocks: Optional[list] = None

    @property
    def sharded(self) -> List[int]:
        """Indices of the parameters split over some axis."""
        return [i for i, s in enumerate(self.specs) if any(s)]

    def block(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``, a tensor of parameter ``i``'s
        full shape (a parameter, a gradient or an Adam moment)."""
        m = self.mesh
        if self.model_dims[i] is not None:
            full = full.chunk(m.n_model, self.model_dims[i])[m.model_index]
        if self.data_dims[i] is not None:
            full = full.chunk(m.n_data, self.data_dims[i])[m.data_index]
        return full

    def shard_(self) -> None:
        """Keep only this rank's block of every sharded parameter (an
        owned copy: the full tensor is freed)."""
        with torch.no_grad():
            for i in self.sharded:
                self.params[i].data = self.block(
                    i, self.params[i].data).clone(
                        memory_format=torch.contiguous_format)

    def gather(self, blocks: Sequence[torch.Tensor],
               model: bool = True) -> List[torch.Tensor]:
        """The tensors of ``blocks`` (one a parameter, in parameter order,
        each in that parameter's layout) all-gathered over the data axis,
        then, with ``model``, over the model axis to full tensors.  A
        collective."""
        m = self.mesh
        out = list(blocks)
        data = [i for i in self.sharded if self.data_dims[i] is not None]
        for i, t in _all_gather(out, self.data_dims, data, m.n_data,
                                m.data_group).items():
            out[i] = t
        if model:
            cut = [i for i in self.sharded
                   if self.model_dims[i] is not None]
            for i, t in _all_gather(out, self.model_dims, cut, m.n_model,
                                    m.model_group).items():
                out[i] = t
        return out

    def gather_(self, column: bool = False) -> None:
        """Set every parameter to its full tensor (no-op if gathered).
        With ``column`` a parameter cut on the model axis keeps its model
        slice and its module computes column-parallel (``model_axis``
        set) until ``release_``."""
        if self._blocks is not None or not self.sharded:
            return
        self._blocks = [p.data for p in self.params]
        with torch.no_grad():
            for p, full in zip(self.params,
                               self.gather(self._blocks, not column)):
                p.data = full
        if column:
            for i in self.sharded:
                if self.model_dims[i] is not None:
                    self.owners[i].model_axis = self.mesh

    def release_(self) -> None:
        """Return every parameter to its block, dropping the gathered
        copies (no-op if not gathered)."""
        if self._blocks is None:
            return
        for p, b in zip(self.params, self._blocks):
            p.data = b
        for owner in self.owners:
            if getattr(owner, "model_axis", None) is not None:
                owner.model_axis = None
        self._blocks = None

    @contextlib.contextmanager
    def gathered(self) -> Iterator[None]:
        """The full parameters inside the block (a collective on entry),
        the module computing as an unsharded one."""
        self.gather_()
        try:
            yield
        finally:
            self.release_()

    def reduce(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's block of the sum over the data axis of each
        gradient taken in column mode (``gather_(column=True)``: a
        model-sharded parameter's gradient is its model slice's), a
        collective.  Data-sharded gradients are reduce-scattered, the
        rest all-reduced, each in buckets."""
        m = self.mesh
        out = list(grads)
        scatter = [i for i in range(len(out))
                   if self.data_dims[i] is not None]
        rest = [i for i in range(len(out)) if self.data_dims[i] is None]
        for i, g in zip(rest, all_reduce_grads([out[i] for i in rest],
                                               m)):
            out[i] = g
        for i, g in _reduce_scatter(out, self.data_dims, scatter, m.n_data,
                                    m.data_group).items():
            out[i] = g
        return out

    def shard_optimizer_(self, opt: torch.optim.Optimizer) -> None:
        """Cut the optimizer's per-parameter tensors of full shape (Adam's
        moments) to this rank's blocks, as ``shard_`` cuts the
        parameters."""
        for i in self.sharded:
            st = opt.state.get(self.params[i], {})
            for k, v in st.items():
                if torch.is_tensor(v) and tuple(v.shape) == \
                        self.full_shapes[i]:
                    st[k] = self.block(i, v).clone(
                        memory_format=torch.contiguous_format)

    def full_optimizer_state(self, opt: torch.optim.Optimizer
                             ) -> dict:
        """``opt.state_dict()`` with every sharded moment gathered to its
        full shape (a collective), as an unsharded run's."""
        sd = opt.state_dict()
        index = {id(p): i for i, p in enumerate(
            q for g in opt.param_groups for q in g["params"])}
        order = [index[id(p)] for p in self.params]
        keys = sorted({k for i in order if i in sd["state"]
                       for k, v in sd["state"][i].items()
                       if torch.is_tensor(v) and v.dim() > 0})
        for k in keys:
            blocks = [sd["state"].get(i, {}).get(k, p.data)
                      for i, p in zip(order, self.params)]
            for i, full in zip(order, self.gather(blocks)):
                if i in sd["state"] and k in sd["state"][i]:
                    sd["state"][i] = dict(sd["state"][i], **{k: full})
        return sd


def local_bytes(tensors) -> int:
    """Bytes of ``tensors`` as this rank holds them."""
    return sum(t.numel() * t.element_size() for t in tensors)
