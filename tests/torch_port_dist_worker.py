"""One process of the port's multi-process checks, the cases it shares
with the single-process reference, and the comparison of the two.

Run with torchrun's environment (WORLD_SIZE, RANK, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), an output directory and a device:

    python tests/torch_port_dist_worker.py OUT_DIR [cpu|cuda]
    torchrun --nproc_per_node 4 tests/torch_port_dist_worker.py OUT cuda

Each process joins the group (gloo on the CPU, NCCL on the card), runs
the multihost helpers, the discriminator's minibatch stddev at global
batches 8 and 12, and one R1 + path + spatial train step at size 16 on
global batch 8, in one pass and in two microbatches (each rank takes
its share of the batch and of the draws), checks that a local batch of
3 with ``path_batch_shrink`` 2 raises (its global path batch does not
split over the processes), and writes what it got to
``OUT_DIR/rank<r>.pt``.  Then, in one
process without a group:

    python tests/torch_port_dist_worker.py --compare OUT_DIR [cpu|cuda]

runs the same cases on the whole batch and holds every rank's results
to them (``check_stddev``, ``check_train``, as
tests/test_torch_port_multihost.py does for 2 gloo processes).  On the
card cuDNN is made deterministic for both.  Imports no JAX.
"""

import json
import os
import sys

import numpy as np
import torch

from transeditor_tpu_torch.config import ModelConfig, TrainConfig
from transeditor_tpu_torch.models.discriminator import minibatch_stddev
from transeditor_tpu_torch.parallel import multihost
from transeditor_tpu_torch.parallel.data_parallel import local_rows
from transeditor_tpu_torch.train.gan import init_state, make_train_step

MODEL = dict(size=16, style_dim=32, param_dim=32, max_channels=32, n_trans=1)
# lr 0: see tests/test_torch_port_multihost.py
TRAIN = dict(batch_size=8, spatial_regu=True, regu_space="p+", lr=0.0)
# microbatches a step: at 2 the one-process step's microbatch k is global
# rows 4k .. 4k + 3, each process holding two of them
GRAD_ACCUM = (1, 2)
STDDEV_BATCHES = (8, 12)
STDDEV_TOL = 1e-6
TRAIN_REL = 1e-5         # of each tensor's largest magnitude
MEAN_REL = 1e-6          # the two path-length means
# a gradient that is 0 in exact arithmetic (an attention key bias:
# softmax ignores a shift) is rounding noise in both runs
ZERO_GRAD = {"exp_avg": 1e-8, "exp_avg_sq": 1e-16}


def my_rows(t: torch.Tensor) -> torch.Tensor:
    """This process's slice of a global-batch tensor."""
    return local_rows(t)


def stddev_case(batch: int, device: str = "cpu") -> dict:
    """minibatch_stddev on this process's rows of a seeded global batch,
    and the gradient of a seeded weighted sum of its output."""
    rng = np.random.RandomState(batch)
    x = torch.from_numpy(rng.randn(batch, 4, 4, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(batch, 4, 4, 9).astype(np.float32))
    xl = my_rows(x).to(device).requires_grad_(True)
    out = minibatch_stddev(xl)
    grad, = torch.autograd.grad((out * my_rows(w).to(device)).sum(), xl)
    return {"out": out.detach().cpu(), "grad": grad.cpu()}


def train_inputs(grad_accum: int = 1):
    """The global batch and draws of the step (seeded, numpy)."""
    cfg = ModelConfig(**MODEL)
    tcfg = TrainConfig(**TRAIN, grad_accum=grad_accum)
    rng = np.random.RandomState(5)
    b, pb = tcfg.batch_size, tcfg.batch_size // tcfg.path_batch_shrink

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    zp = (cfg.n_tokens, cfg.style_dim)
    img = (pb, cfg.size, cfg.size, 3)
    draws = {"d": (t(b, *zp), t(b, *zp)), "g": (t(b, *zp), t(b, *zp)),
             "path": (t(pb, *zp), t(pb, *zp), t(*img) / cfg.size),
             "spatial": (t(pb, *zp), t(pb, *zp), t(*img) / cfg.size)}
    real = torch.from_numpy(rng.randint(0, 256, (b, cfg.size, cfg.size, 3))
                            .astype(np.uint8))
    return cfg, tcfg, real, draws


def train_case(device: str = "cpu", grad_accum: int = 1) -> dict:
    """One R1 + path + spatial step on this process's rows of the global
    batch (``local_rows``: with microbatches, its share of each), from
    the seeded init; the whole state afterwards (on the CPU)."""
    cfg, tcfg, real, draws = train_inputs(grad_accum)
    state = init_state(cfg, tcfg, seed=0, device=device)
    step = make_train_step(cfg, tcfg, device=device)
    state, metrics = step(state, local_rows(real, grad_accum),
                          torch.Generator(device),
                          do_d_reg=True, do_g_reg=True, do_spatial_reg=True,
                          draws=draws)
    out = {"metrics": multihost.reduce_loss_dict(metrics),
           "mean_path_length": float(state.mean_path_length),
           "mean_spatial_path_length":
               float(state.mean_spatial_path_length)}
    for tag, module, opt in (("g", state.g, state.opt_g),
                             ("d", state.d, state.opt_d)):
        for name, p in module.named_parameters():
            out[f"{tag}.{name}"] = p.detach().cpu()
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{tag}.{name}.{key}"] = opt.state[p][key].cpu()
    for name, p in state.g_ema.named_parameters():
        out[f"g_ema.{name}"] = p.detach().cpu()
    return out


def path_batch_case(device: str = "cpu") -> dict:
    """A local batch of 3 rows a process with ``path_batch_shrink`` 2:
    the global path batch (3 * world // 2) does not split evenly over
    the processes.  Building the step for that global batch raises, and
    a step built for batch 8 raises on 3 rows before it changes the
    state.  Returns the two messages and whether the state was left as
    it was."""
    cfg = ModelConfig(**MODEL)
    world = multihost.process_count()
    out = {}
    try:
        make_train_step(cfg, TrainConfig(batch_size=3 * world),
                        device=device)
    except ValueError as e:
        out["build"] = str(e)
    tcfg = TrainConfig(batch_size=8)
    state = init_state(cfg, tcfg, seed=0, device=device)
    before = [p.detach().clone() for p in state.g.parameters()]
    _, _, real, _ = train_inputs()
    try:
        make_train_step(cfg, tcfg, device=device)(
            state, real[:3], torch.Generator(device), do_g_reg=True)
    except ValueError as e:
        out["step"] = str(e)
    out["untouched"] = state.step == 0 and all(
        torch.equal(a, b) for a, b in zip(before, state.g.parameters()))
    return out


def helpers_case() -> dict:
    rank = multihost.process_index()
    gathered = multihost.all_gather_host(
        {"x": np.full((2,), rank, np.float32), "n": [rank, 10 * rank]})
    multihost.synchronize()
    return {
        "rank": rank, "count": multihost.process_count(),
        "is_main": multihost.is_main(),
        "local_batch": multihost.local_batch_size(8),
        "reduced": multihost.reduce_loss_dict({"a": float(rank + 1),
                                               "b": torch.tensor(2.0)}),
        "any_one": multihost.any_flag(rank == 1),
        "any_none": multihost.any_flag(False),
        "broadcast": multihost.broadcast_from_main({"seed": 100 + rank}),
        "gathered_x": gathered["x"], "gathered_n": gathered["n"],
    }


def check_stddev(ranks: list, batch: int, want: dict) -> None:
    """Every rank's stddev output and gradient, concatenated in rank
    order, against the single-process ones; raises AssertionError."""
    for key in ("out", "grad"):
        got = torch.cat([r["stddev"][batch][key] for r in ranks])
        torch.testing.assert_close(got, want[key], rtol=STDDEV_TOL,
                                   atol=STDDEV_TOL,
                                   msg=f"{key} at batch {batch}")


def check_path_batch(got: dict) -> None:
    """One rank's ``path_batch_case``: building and running the step both
    raised, naming the path batch, and the state was left as it was."""
    for key in ("build", "step"):
        assert "path-length batch" in got.get(key, ""), (key, got)
        assert "does not split evenly" in got[key], (key, got)
    assert got["untouched"], got


def check_train(got: dict, want: dict) -> float:
    """One rank's step against the single-process step; raises
    AssertionError, else returns the worst error over its tensor's
    largest magnitude (tensors at the rounding floor left out)."""
    assert set(got) == set(want)
    for key in ("mean_path_length", "mean_spatial_path_length"):
        np.testing.assert_allclose(got[key], want[key], rtol=MEAN_REL,
                                   err_msg=key)
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    worst = 0.0
    for k, w in want.items():
        if not isinstance(w, torch.Tensor):
            continue
        floor = ZERO_GRAD.get(k.rsplit(".", 1)[-1], 0.0)
        top = float(w.abs().max())
        err = float((got[k] - w).abs().max())
        assert err <= TRAIN_REL * top + floor, \
            f"{k}: {err} > {TRAIN_REL * top + floor}"
        if err > floor:
            worst = max(worst, err / top)
    return worst


def compare(out_dir: str, device: str) -> None:
    """Hold every rank file in ``out_dir`` to the single-process cases;
    prints one JSON line."""
    if device == "cuda":
        torch.backends.cudnn.deterministic = True
    files = sorted(f for f in os.listdir(out_dir) if f.startswith("rank"))
    ranks = [torch.load(os.path.join(out_dir, f), weights_only=False)
             for f in files]
    for r in ranks:
        check_path_batch(r["path_batch"])
    for b in STDDEV_BATCHES:
        check_stddev(ranks, b, stddev_case(b, device))
    worst = 0.0
    for k in GRAD_ACCUM:
        want = train_case(device, k)
        worst = max(worst, *(check_train(r["train"][k], want)
                             for r in ranks))
    print(json.dumps({"ranks": len(ranks), "device": device,
                      "worst_train_rel": worst,
                      "reduced": [r["helpers"]["reduced"] for r in ranks]}))


def main(out_dir: str, device: str) -> None:
    torch.set_num_threads(2)
    if device == "cuda":
        torch.backends.cudnn.deterministic = True
    assert multihost.initialize(device=device)
    try:
        got = {"helpers": helpers_case(),
               "path_batch": path_batch_case(device),
               "stddev": {b: stddev_case(b, device) for b in STDDEV_BATCHES},
               "train": {k: train_case(device, k) for k in GRAD_ACCUM}}
        torch.save(got, os.path.join(
            out_dir, f"rank{multihost.process_index()}.pt"))
        multihost.synchronize()
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "cpu")
    else:
        main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "cpu")
