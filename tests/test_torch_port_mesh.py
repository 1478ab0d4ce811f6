"""The port's (data, model) mesh (``transeditor_tpu_torch/parallel/
mesh.py``) and the sharded train step, on the CPU.

One process: ``param_partition_spec`` gives the JAX package's decision
(``transeditor_tpu/parallel/mesh.py``, on its 8 virtual CPU devices) for
every parameter of a small G and D, each JAX axis carried to the port's
dim through the weight bridge itself (``io/torch_export.py``, probed
with index arrays), on meshes (4, 2), (8, 1) and (1, 8) at ``min_size``
32 and 256, with and without ``fsdp``; ``--fsdp`` at one rank is the
identity, bit for bit, as JAX's ``n_data > 1`` makes it.

Gloo processes (``tests/torch_port_mesh_worker.py``, one spawn of 2
ranks and one of 4 for the module, side by side): a ``--fsdp`` R1 + path
+ spatial step on 2 ranks and a step on a (2 data, 2 model) mesh, with
and without ``fsdp`` (column-parallel: each rank blurs its half of the
channels), equal the one-process step
(``tests/torch_port_dist_worker.py::train_case``) within 1e-5 of each
tensor's largest value (the data-parallel tests' standard, the dist worker's
``check_train``): parameters, g_ema, both Adam moments, the path means
and the metrics.  Each rank holds exactly 1/n of every sharded tensor
at rest.  A checkpoint written under 2-rank FSDP has the one-process
format: it loads in one process equal to the one-process state, and a
step from it, in one process or again under FSDP, equals two
one-process steps.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.io.torch_port import (discriminator_params_from_torch,
                                           generator_params_from_torch)
from transeditor_tpu.parallel import mesh as jax_mesh

import torch_port_dist_worker as dw
import torch_port_mesh_worker as mw
from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.io.checkpoint import restore_train_state
from transeditor_tpu_torch.io.torch_export import (
    discriminator_state_dict_from_jax, generator_state_dict_from_jax)
from transeditor_tpu_torch.models.discriminator import Discriminator
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.parallel.data_parallel import local_rows
from transeditor_tpu_torch.parallel.mesh import (Mesh, create_mesh,
                                                 param_partition_spec)
from transeditor_tpu_torch.train.gan import init_state, make_train_step
from torch_port_threads import torch_worker_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_MODEL = dict(size=16, style_dim=64, param_dim=64, max_channels=64,
                  n_trans=1)
MESHES = [(4, 2), (8, 1), (1, 8)]


# ------------------------------------------------- the partition rule

def _port_specs_from_jax(tree, to_sd, names, jmesh, min_size, fsdp):
    """{port name: the JAX rule's spec of its leaf, carried to port dims
    by probing the bridge ``to_sd`` with index arrays}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    leaves = [np.asarray(leaf) for _, leaf in flat]
    paths = [path for path, _ in flat]

    def probe(fill):
        return to_sd(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [fill(i, x) for i, x in enumerate(leaves)]))

    owner = probe(lambda i, x: np.full(x.shape, i + 1, np.float32))
    ndim = max(x.ndim for x in leaves)
    axes = [probe(lambda i, x, a=a: (np.indices(x.shape)[a]
                                     if a < x.ndim else np.zeros(x.shape))
                  .astype(np.float32)) for a in range(ndim)]
    out = {}
    for name in names:
        i = int(owner[name].reshape(-1)[0]) - 1
        port = [None] * owner[name].dim()
        if i < 0:           # no JAX leaf (a noise weight without noise)
            out[name] = tuple(port)
            continue
        spec = jax_mesh.param_partition_spec(paths[i], leaves[i], jmesh,
                                             min_size, fsdp)
        for a, s in enumerate(tuple(spec)):
            if s is None:
                continue
            got = axes[a][name].numpy()
            dims = [d for d in range(got.ndim) if got.shape[d] > 1
                    and np.array_equal(got, np.indices(got.shape)[d])]
            assert len(dims) == 1, (name, a, dims)
            port[dims[0]] = s
        out[name] = tuple(port)
    return out


@pytest.fixture(scope="module")
def spec_models():
    cfg = ModelConfig(**SPEC_MODEL)
    g = Generator(cfg, device="cpu", seed=0)
    d = Discriminator(cfg, device="cpu", seed=1)
    jcfg = JaxConfig(**SPEC_MODEL)
    gsd = {k: v.numpy() for k, v in g.state_dict().items()}
    dsd = {k: v.numpy() for k, v in d.state_dict().items()}
    return [
        (g, generator_params_from_torch(gsd, jcfg),
         lambda t: generator_state_dict_from_jax(t, cfg)),
        (d, discriminator_params_from_torch(dsd, jcfg),
         lambda t: discriminator_state_dict_from_jax(t, cfg)),
    ]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("min_size", [32, 256])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_param_partition_spec_is_the_jax_rule(spec_models, shape, min_size,
                                               fsdp):
    jmesh = jax_mesh.create_mesh(*shape)
    n_sharded = 0
    for module, tree, to_sd in spec_models:
        named = dict(module.named_parameters())
        want = _port_specs_from_jax(tree, to_sd, list(named), jmesh,
                                    min_size, fsdp)
        for name, p in named.items():
            got = param_partition_spec(name, p, Mesh(*shape), min_size,
                                       fsdp)
            assert got == want[name], (name, tuple(p.shape), got,
                                       want[name])
            n_sharded += any(got)
    # the small models' output channels (<= 64) reach only min_size 32,
    # and D's first linear (1,024 inputs) takes fsdp at either
    if (shape[1] > 1 and min_size == 32) or (fsdp and shape[0] > 1):
        assert n_sharded > 0


def test_create_mesh_of_one_process():
    m = create_mesh()
    assert (m.n_data, m.n_model, m.data_index, m.model_index) == (1, 1, 0, 0)
    assert not m.data_active and not m.model_active
    with pytest.raises(ValueError, match="needs 2 processes"):
        create_mesh(n_model=2, n_data=1)


def test_model_group_ranks_read_the_same_rows():
    """rank r of a (2, 2) mesh is data rank r // 2: ranks 0, 1 read rows
    0-3 of a global batch of 8, ranks 2, 3 rows 4-7."""
    t = torch.arange(8)
    for rank in range(4):
        m = Mesh(2, 2, rank // 2, rank % 2)
        want = list(range(4 * (rank // 2), 4 * (rank // 2) + 4))
        assert local_rows(t, mesh=m).tolist() == want


def test_fsdp_at_one_rank_is_the_identity():
    cfg, tcfg, real, draws = dw.train_inputs()
    got = []
    for fsdp in (False, True):
        state = init_state(cfg, tcfg, seed=0, device="cpu")
        step = make_train_step(cfg, tcfg, device="cpu", fsdp=fsdp)
        state, metrics = step(state, real, torch.Generator(),
                              do_d_reg=True, do_g_reg=True,
                              do_spatial_reg=True, draws=draws)
        assert state.sharding is None
        got.append(mw.state_out(state, metrics))
    for k, v in got[0].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, got[1][k]), k
        else:
            assert v == got[1][k], k


# ----------------------------------------------------- gloo processes

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(out, world, cases):
    out.mkdir()
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_port_mesh_worker.py"),
             str(out), "cpu", cases], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _collect(out, procs):
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: every rank's results}: 2 ranks (fsdp, ckpt) and 4 ranks
    (model) spawned together."""
    root = tmp_path_factory.mktemp("mesh")
    two = _spawn(root / "w2", 2, "fsdp,ckpt")
    four = _spawn(root / "w4", 4, "model")
    return {2: _collect(root / "w2", two), 4: _collect(root / "w4", four),
            "dir": root / "w2"}


@pytest.fixture(scope="module")
def single():
    return dw.train_case()


def _check_all(rank_results, key, want):
    for r, got in enumerate(rank_results):
        try:
            dw.check_train(got[key]["state"], want)
        except AssertionError as e:
            raise AssertionError(f"rank {r}: {e}") from None


def test_fsdp_step_two_ranks_equals_one(ranks, single):
    _check_all(ranks[2], "fsdp", single)


@pytest.mark.parametrize("fsdp", [0, 1])
def test_model_axis_step_four_ranks_equals_one(ranks, single, fsdp):
    _check_all(ranks[4], f"model_fsdp{fsdp}", single)


@pytest.mark.parametrize("fsdp", [0, 1])
def test_model_axis_blurs_channel_slices(ranks, fsdp):
    """Column-parallel compute: every up-conv's ``fused_blur4`` (forward,
    adjoint and recompute) runs on this rank's half of its 32 output
    channels, never on all of them."""
    for got in ranks[4]:
        assert got[f"model_fsdp{fsdp}"]["blur_channels"] == {16}


@pytest.mark.parametrize("world,key,share", [
    (2, "fsdp", 0.5), (4, "model_fsdp0", 0.5), (4, "model_fsdp1", 0.25)])
def test_each_rank_holds_its_share_at_rest(ranks, world, key, share):
    """Every sharded tensor's block is exactly 1/n of it; at (2, 2) with
    ``fsdp`` most are cut on both axes."""
    for got in ranks[world]:
        b = got[key]["bytes"]
        mw.check_at_rest(b)
        assert share <= b["held"] / b["full"] < 2 * share, b
        assert b["total"] < b["full"] + b["total"] - b["held"], b


def test_fsdp_checkpoint_loads_and_resumes_in_one_process(ranks, single):
    cfg, tcfg, real, draws = dw.train_inputs()
    state = init_state(cfg, tcfg, seed=9, device="cpu")
    state, step_no = restore_train_state(str(ranks["dir"] / "ckpt"), state)
    assert step_no == 0 and state.step == 1 and state.sharding is None
    got = mw.state_out(state)
    for k, w in single.items():
        if isinstance(w, torch.Tensor):
            top = float(w.abs().max())
            floor = dw.ZERO_GRAD.get(k.rsplit(".", 1)[-1], 0.0)
            assert float((got[k] - w).abs().max()) <= \
                dw.TRAIN_REL * top + floor, k
    step = make_train_step(cfg, tcfg, device="cpu")
    state, metrics = step(state, real, torch.Generator(), do_d_reg=True,
                          do_g_reg=True, do_spatial_reg=True, draws=draws)
    dw.check_train(mw.state_out(state, metrics), mw.single_two_steps())


def test_one_process_checkpoint_resumes_under_fsdp(ranks):
    """The ``ckpt`` case: the FSDP ranks restore the file (one-process
    format) into a fresh state, shard it and step: two one-process
    steps."""
    want = mw.single_two_steps()
    for r, got in enumerate(ranks[2]):
        try:
            dw.check_train(got["ckpt"], want)
        except AssertionError as e:
            raise AssertionError(f"rank {r}: {e}") from None
