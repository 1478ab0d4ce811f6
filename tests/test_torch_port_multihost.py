"""The port's process-group plumbing (``parallel/``) on the CPU.

Single process: the helpers degrade to no-ops without a process group,
as ``tests/test_multihost.py`` pins for the JAX package.

Two processes on gloo (``tests/torch_port_dist_worker.py``, spawned
once for the module): the helpers across processes; the
discriminator's minibatch stddev at global batches 8 and 12, whose
strided groups span both processes, against the single-process result
(value and gradient, 1e-6); and one R1 + path + spatial train step at
size 16 on global batch 8 split 4 / 4, in one pass and in two
microbatches, with the whole batch's draws sliced per rank
(``data_parallel.local_rows``), against the single-process step on the
whole batch:
the JAX package's contract that a data-parallel step is the global-batch
step (``tests/test_multihost_2proc.py``).  The path regularisers take
``batch // path_batch_shrink`` of the GLOBAL batch, as that step does:
with 3 rows a process and shrink 2 the path batch of 3 cannot be split
over the 2 processes, and building or running the step raises
(``worker.path_batch_case``).  Parameters, g_ema and both
Adam moments agree to 1e-5 of each tensor's largest magnitude, the two
path-length means to 1e-6 relative (the checks and tolerances are the
worker's, ``check_stddev`` / ``check_train``).  The two processes sum in
another order than one, so nothing here is bit-exact.

The step runs at lr 0, so that every phase of both runs sees the same
weights and each Adam moment holds that phase's gradient: at lr > 0
Adam moves a parameter by about lr whatever the size of its gradient,
so a gradient at rounding level (an attention key bias, whose gradient
is 0 in exact arithmetic: softmax ignores a shift) moves by lr in a
random direction.  Those gradients are held to 1e-8 (1e-16 for the
second moment), as in ``tests/torch_port_train_oracle.py``.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_dist_worker as worker
from transeditor_tpu_torch.parallel import data_parallel, multihost
from transeditor_tpu_torch.train.gan import (init_state, local_path_batch,
                                             make_train_step)
from torch_port_threads import torch_worker_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both processes' results (one spawn for the module)."""
    out = tmp_path_factory.mktemp("dist")
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="2",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_port_dist_worker.py"),
             str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def single_train():
    return {k: worker.train_case(grad_accum=k) for k in worker.GRAD_ACCUM}


# ---------------------------------------------------------- one process

def test_single_process_degradation(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert multihost.process_index() == 0
    assert multihost.process_count() == 1
    assert multihost.is_main() is True
    assert multihost.local_batch_size(16) == 16


def test_distributed_helper_degradation():
    multihost.synchronize()
    out = multihost.all_gather_host({"a": np.arange(3.0)})
    assert out["a"].shape == (1, 3)
    red = multihost.reduce_loss_dict({"d": torch.tensor(2.5), "g": 1.0})
    assert red == {"d": 2.5, "g": 1.0}
    assert multihost.broadcast_from_main("seed") == "seed"
    assert multihost.any_flag(True) is True
    assert multihost.any_flag(False) is False


def test_data_parallel_is_the_identity_without_a_group():
    grads = [torch.ones(3), torch.zeros(2, 2, dtype=torch.float64)]
    assert data_parallel.all_reduce_grads(grads) is grads
    x = torch.arange(4.0)
    assert data_parallel.all_reduce_sum(x) is x
    assert float(data_parallel.global_mean(x)) == 1.5
    m = torch.nn.Linear(2, 2)
    before = [p.clone() for p in m.parameters()]
    data_parallel.broadcast_module(m)
    assert all(torch.equal(a, b) for a, b in zip(before, m.parameters()))


def test_a_group_of_one_runs_no_collective(monkeypatch):
    import torch.distributed as dist

    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    assert multihost.initialize(device="cpu")
    try:
        assert dist.is_initialized() and not multihost.multi_process()
        calls = []
        for name in ("all_reduce", "broadcast", "barrier"):
            monkeypatch.setattr(dist, name,
                                lambda *a, name=name, **k: calls.append(name))
        grads = [torch.ones(3), torch.zeros(2, 2, dtype=torch.float64)]
        assert data_parallel.all_reduce_grads(grads) is grads
        x = torch.arange(4.0)
        assert data_parallel.all_reduce_sum(x) is x
        assert float(data_parallel.global_mean(x)) == 1.5
        data_parallel.broadcast_module(torch.nn.Linear(2, 2))
        multihost.synchronize()
        assert multihost.reduce_loss_dict({"d": 2.0}) == {"d": 2.0}
        y = torch.randn(8, 4, 4, 8, generator=torch.Generator().manual_seed(0))
        got = worker.minibatch_stddev(y)
        assert got.shape == (8, 4, 4, 9)
        assert calls == []
    finally:
        multihost.shutdown()


def test_initialize_needs_the_rendezvous_address(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.initialize(device="cpu")


# -------------------------------------------------------- two processes

def test_helpers_across_two_processes(ranks):
    for r, got in enumerate(ranks):
        h = got["helpers"]
        assert (h["rank"], h["count"], h["is_main"]) == (r, 2, r == 0)
        assert h["local_batch"] == 4
        assert h["reduced"] == {"a": 1.5, "b": 2.0}
        assert h["any_one"] is True and h["any_none"] is False
        assert h["broadcast"] == {"seed": 100}
        np.testing.assert_array_equal(h["gathered_x"], [[0, 0], [1, 1]])
        np.testing.assert_array_equal(h["gathered_n"][0], [0, 1])
        np.testing.assert_array_equal(h["gathered_n"][1], [0, 10])


@pytest.mark.parametrize("batch", worker.STDDEV_BATCHES)
def test_minibatch_stddev_across_two_processes(ranks, batch):
    want = worker.stddev_case(batch)
    worker.check_stddev(ranks, batch, want)
    # the groups span both processes: rank 0's own samples alone would
    # give other stddevs
    alone = worker.minibatch_stddev(
        ranks[0]["stddev"][batch]["out"][..., :8])[..., 8]
    assert not torch.allclose(alone, want["out"][:batch // 2, ..., 8])


def test_train_step_two_processes_equals_one(ranks, single_train):
    for r, got in enumerate(ranks):
        try:
            worker.check_train(got["train"][1], single_train[1])
        except AssertionError as e:
            raise AssertionError(f"rank {r}: {e}") from None


def test_accumulated_step_two_processes_equals_one(ranks, single_train):
    """grad_accum 2: each process holds its half of each global
    microbatch (``local_rows``), so the stddev groups, the D outputs and
    the gradients are the one-process step's."""
    for r, got in enumerate(ranks):
        try:
            worker.check_train(got["train"][2], single_train[2])
        except AssertionError as e:
            raise AssertionError(f"rank {r}: {e}") from None


def test_uneven_path_batch_raises_on_two_processes(ranks):
    """Local batch 3, shrink 2, 2 processes: the one-process step on the
    global batch of 6 takes 3 path samples, which 2 processes cannot
    hold evenly; the step raises naming the path batch, before it runs
    (the even case above matches the one-process step)."""
    for r, got in enumerate(ranks):
        pb = got["path_batch"]
        worker.check_path_batch(pb)
        for key in ("build", "step"):
            assert "(6 // path_batch_shrink 2 = 3)" in pb[key], (r, pb)


@pytest.mark.parametrize("world,local,want", [
    (1, 3, 1), (1, 1, 1), (2, 4, 2), (4, 2, 1), (2, 3, None),
    (2, 1, None), (4, 3, None)])
def test_local_path_batch_is_a_share_of_the_global_path_batch(
        world, local, want):
    """shrink 2; None: the global path batch does not split evenly."""
    if want is None:
        with pytest.raises(ValueError, match="does not split evenly"):
            local_path_batch(local * world, 2, world)
    else:
        assert local_path_batch(local * world, 2, world) == want


@pytest.mark.parametrize("n_accum,want", [
    (1, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (2, [[0, 1, 4, 5], [2, 3, 6, 7]])])
def test_local_rows_hold_each_process_share_of_each_microbatch(
        monkeypatch, n_accum, want):
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    for rank in range(2):
        monkeypatch.setattr(multihost, "process_index", lambda: rank)
        got = data_parallel.local_rows(torch.arange(8), n_accum)
        assert got.tolist() == want[rank]


def test_train_step_uses_both_halves_of_the_batch(single_train):
    """The single-process reference itself differs from a step on half
    the batch, so the comparison above would catch a lost half."""
    cfg, tcfg, real, draws = worker.train_inputs()
    single_train = single_train[1]
    half = {k: tuple(t[:t.shape[0] // 2] for t in v)
            for k, v in draws.items()}
    tcfg4 = dataclasses.replace(tcfg, batch_size=4)
    state = init_state(cfg, tcfg4, seed=0, device="cpu")
    state, _ = make_train_step(cfg, tcfg4, device="cpu")(
        state, real[:4], torch.Generator(), do_d_reg=True, do_g_reg=True,
        do_spatial_reg=True, draws=half)
    for tag, module, opt in (("g", state.g, state.opt_g),
                             ("d", state.d, state.opt_d)):
        w = single_train[f"{tag}.convs.0.0.weight.exp_avg" if tag == "d"
                         else f"{tag}.to_rgbs.0.conv.weight.exp_avg"]
        p = (module.convs[0][0].weight if tag == "d"
             else module.to_rgbs[0].conv.weight)
        got = opt.state[p]["exp_avg"]
        assert float((got - w).abs().max()) > 1e-3 * float(w.abs().max())
