"""One process of the port's (data, model) mesh checks, and the
comparison with one process.

Run with torchrun's environment (WORLD_SIZE, RANK, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), an output directory, a device and the cases:

    python tests/torch_port_mesh_worker.py OUT_DIR [cpu|cuda] CASES
    torchrun --nproc_per_node 4 tests/torch_port_mesh_worker.py OUT cuda \\
        fsdp,model,ckpt,eval

CASES, comma-separated (any world size the case's mesh fits):

  * ``fsdp``: one R1 + path + spatial step at size 16 on global batch 8
    (``tests/torch_port_dist_worker.py``'s inputs and draws, lr 0) on a
    (world, 1) mesh with ``fsdp``, the state sharded at ``min_size`` 32
    (the widths are 32: at JAX's 256 nothing here would shard);
  * ``model``: the same step on a (world / 2, 2) mesh, with and without
    ``fsdp``: column-parallel compute, each rank's up-convs running
    ``fused_blur4`` on its half of the channels;
  * ``ckpt``: the ``fsdp`` step, its checkpoint (gathered, rank 0
    writes), and a second step from that file restored into a fresh
    state and sharded again;
  * ``eval``: ``evaluate_fid``, ``evaluate_prdc`` and
    ``evaluate_lpips_diversity`` with ``mesh=`` on a (world, 1) mesh,
    with small seeded feature nets in place of InceptionV3, VGG16 and
    LPIPS;
  * ``timing`` (for cards): R1 + path steps of ``ModelConfig()`` (256px,
    f32) on global batch 16, at (world, 1) without ``fsdp`` (plain data
    parallelism), at (world, 1) with it, and at (world / 2, 2) with and
    without it: ms a step (host clock between synchronisations, after a
    warm step), peak memory and the bytes each rank holds at rest.

Each rank writes what it got (every state gathered to full tensors, and
the bytes each rank holds at rest) to ``OUT_DIR/rank<r>.pt``.  Then, in
one process without a group:

    python tests/torch_port_mesh_worker.py --compare OUT_DIR [cpu|cuda]

runs the one-process cases and holds every rank's results to them (the
checks ``tests/test_torch_port_mesh.py`` and
``tests/test_torch_port_evaluator.py`` make for gloo ranks), and prints
one JSON line.  Imports no JAX.
"""

import json
import os
import sys
import time

import numpy as np
import torch

import torch_port_dist_worker as dw
from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.data.dataset import ArraySource
from transeditor_tpu_torch.io.checkpoint import (full_state_dicts,
                                                 host_copy,
                                                 restore_train_state,
                                                 save_train_state)
from transeditor_tpu_torch.metrics import evaluator
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.ops import fused_blur
from transeditor_tpu_torch.parallel import multihost
from transeditor_tpu_torch.parallel.data_parallel import local_rows
from transeditor_tpu_torch.parallel.mesh import create_mesh, local_bytes
from transeditor_tpu_torch.train.gan import (init_state, make_train_step,
                                             shard_state)

MIN_SIZE = 32
EVAL_REL = 1e-5
EVAL = dict(n_fid=20, batch=8, n_images=8, pair_chunk=7, lpips_batches=2,
            n_prdc=12)


def state_out(state, metrics=None) -> dict:
    """The whole state as ``dw.train_case`` returns it (full tensors on
    the CPU; a sharded state is gathered, a collective)."""
    full = full_state_dicts(state)
    out = {"mean_path_length": float(state.mean_path_length),
           "mean_spatial_path_length":
               float(state.mean_spatial_path_length)}
    if metrics is not None:
        out["metrics"] = multihost.reduce_loss_dict(metrics)
    for tag, module in (("g", state.g), ("d", state.d)):
        names = [n for n, _ in module.named_parameters()]
        opt_state = full[f"{tag}_optim"]["state"]
        for i, name in enumerate(names):
            out[f"{tag}.{name}"] = full[tag][name].detach().cpu().clone()
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{tag}.{name}.{key}"] = opt_state[i][key].cpu().clone()
    for name, _ in state.g_ema.named_parameters():
        out[f"g_ema.{name}"] = full["g_ema"][name].detach().cpu().clone()
    return out


def at_rest(state) -> dict:
    """Bytes this rank holds of params, g_ema and moments, in all and of
    the sharded tensors, with the full size of those and the share each
    should hold (1 / the ranks of its axes)."""
    sh = state.sharding
    held = full = want = 0.0
    for layout, opt in ((sh.g, state.opt_g), (sh.d, state.opt_d),
                        (sh.g_ema, None)):
        m = layout.mesh
        for i in layout.sharded:
            p = layout.params[i]
            n = ((m.n_model if layout.model_dims[i] is not None else 1)
                 * (m.n_data if layout.data_dims[i] is not None else 1))
            tensors = [p.data] + ([] if opt is None else [
                opt.state[p][k] for k in ("exp_avg", "exp_avg_sq")])
            size = int(np.prod(layout.full_shapes[i])) * 4 * len(tensors)
            held += local_bytes(tensors)
            full += size
            want += size / n
    total = local_bytes(
        [p.data for m in (state.g, state.d, state.g_ema)
         for p in m.parameters()]
        + [v for opt in (state.opt_g, state.opt_d)
           for st in opt.state.values() for k, v in st.items()
           if k != "step"])
    return {"held": held, "full": full, "want": want, "total": total}


def mesh_step(device: str, n_model: int, fsdp: bool, state=None,
              blur_channels=None):
    """One step of the dist worker's case on a (world / n_model, n_model)
    mesh, the state sharded at ``MIN_SIZE``; (state, metrics).  The
    channel count of every ``fused_blur4`` call (kernel launch or, on the
    CPU, its plain version) is added to ``blur_channels``."""
    cfg, tcfg, real, draws = dw.train_inputs()
    mesh = create_mesh(n_model=n_model)
    if state is None:
        state = init_state(cfg, tcfg, seed=0, device=device)
    shard_state(state, mesh, fsdp, min_size=MIN_SIZE)
    step = make_train_step(cfg, tcfg, device=device, mesh=mesh, fsdp=fsdp)
    blur = fused_blur._blur

    def seen(x, *args):
        blur_channels.add(x.shape[-1])
        return blur(x, *args)

    if blur_channels is not None:
        fused_blur._blur = seen
    try:
        return step(state, local_rows(real, mesh=mesh),
                    torch.Generator(device), do_d_reg=True, do_g_reg=True,
                    do_spatial_reg=True, draws=draws)
    finally:
        fused_blur._blur = blur


def single_two_steps(device: str = "cpu") -> dict:
    """Two steps of the dist worker's case in one process, the second on
    the same batch and draws."""
    cfg, tcfg, real, draws = dw.train_inputs()
    state = init_state(cfg, tcfg, seed=0, device=device)
    step = make_train_step(cfg, tcfg, device=device)
    for _ in range(2):
        state, metrics = step(state, real, torch.Generator(device),
                              do_d_reg=True, do_g_reg=True,
                              do_spatial_reg=True, draws=draws)
    return state_out(state, metrics)


def ckpt_case(out_dir: str, device: str) -> dict:
    """The fsdp step, its checkpoint, and a second sharded step from the
    file restored into a fresh state."""
    state, metrics = mesh_step(device, 1, True)
    ckpt = os.path.join(out_dir, "ckpt")
    entries = full_state_dicts(state)           # every rank: a collective
    if multihost.is_main():
        save_train_state(ckpt, 0, host_copy(entries))
    multihost.synchronize()
    cfg, tcfg, _, _ = dw.train_inputs()
    fresh = init_state(cfg, tcfg, seed=7, device=device)
    fresh, _ = restore_train_state(ckpt, fresh)
    state, metrics = mesh_step(device, 1, True, state=fresh)
    return state_out(state, metrics)


class _Features(torch.nn.Module):
    """A small seeded stand-in for a feature net: NHWC images in [-1, 1]
    -> [B, 16]."""

    def __init__(self, seed: int):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.conv = torch.nn.Conv2d(3, 8, 3, stride=2)
        self.fc = torch.nn.Linear(8 * 4, 16)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)

    def forward(self, x):
        y = torch.relu(self.conv(x.permute(0, 3, 1, 2)))
        y = torch.nn.functional.adaptive_avg_pool2d(y, 2)
        return self.fc(y.flatten(1))


def eval_case(device: str, mesh=None) -> dict:
    """The three protocols at a small size, on ``mesh`` or one process."""
    e = EVAL
    cfg = ModelConfig(size=16, style_dim=32, param_dim=32, max_channels=32,
                      n_trans=1)
    g = Generator(cfg, device=device, seed=3).eval()
    inc, vgg, lp = (_Features(s).to(device).eval() for s in (1, 2, 3))

    def lpips(a, b):
        return (lp(a) - lp(b)).pow(2).mean(dim=1)

    rng = np.random.RandomState(0)
    real_mean = rng.randn(16)
    a = rng.randn(16, 16)
    real_cov = a @ a.T / 16 + np.eye(16)
    real = ArraySource(rng.randint(0, 256, (e["n_prdc"], 16, 16, 3))
                       .astype(np.uint8))
    return {
        "fid": evaluator.evaluate_fid(g, inc, real_mean, real_cov,
                                      n_samples=e["n_fid"],
                                      batch=e["batch"], mesh=mesh),
        "prdc": evaluator.evaluate_prdc(g, vgg, real, n_samples=e["n_prdc"],
                                        batch=e["batch"], mesh=mesh),
        "lpips": evaluator.evaluate_lpips_diversity(
            g, lpips, n_images=e["n_images"], n_batches=e["lpips_batches"],
            pair_chunk=e["pair_chunk"], mesh=mesh),
    }


def check_eval(got: dict, want: dict,
               protocols=("fid", "prdc", "lpips")) -> float:
    """One rank's eval values against one process's; the worst relative
    error.  Raises AssertionError."""
    flat = []
    for key in protocols:
        if isinstance(want[key], dict):
            flat += [(f"{key}.{k}", got[key][k], v)
                     for k, v in want[key].items()]
        else:
            flat.append((key, got[key], want[key]))
    worst = 0.0
    for name, g, w in flat:
        err = abs(g - w) / max(abs(w), 1e-12)
        assert err <= EVAL_REL, f"{name}: {g} vs {w} ({err:.3g})"
        worst = max(worst, err)
    return worst


def check_at_rest(b: dict) -> None:
    """Each sharded tensor's block is exactly its 1/n, and something is
    sharded."""
    assert b["full"] > 0, b
    assert b["held"] == b["want"], b


TIMED_STEPS = 3


def timing_case(device: str) -> dict:
    """ms a full-width R1 + path step on each mesh layout, and memory
    (the cases before it run with cuDNN deterministic; this one not)."""
    from transeditor_tpu_torch.config import TrainConfig

    cfg, tcfg = ModelConfig(), TrainConfig(batch_size=16)
    out = {}
    # cuDNN's own algorithm choice, as a training run makes it
    torch.backends.cudnn.deterministic = False
    for name, n_model, fsdp in (("dp", 1, False), ("fsdp", 1, True),
                                ("model", 2, False),
                                ("model_fsdp", 2, True)):
        mesh = create_mesh(n_model=n_model)
        state = init_state(cfg, tcfg, seed=0, device=device)
        full = local_bytes([p for m in (state.g, state.d, state.g_ema)
                            for p in m.parameters()])
        step = make_train_step(cfg, tcfg, device=device, mesh=mesh,
                               fsdp=fsdp)
        rng = np.random.RandomState(mesh.data_index)
        real = torch.from_numpy(rng.randint(
            0, 256, (16 // mesh.n_data, cfg.size, cfg.size, 3))
            .astype(np.uint8))
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for k in range(TIMED_STEPS + 1):
            multihost.synchronize()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, _ = step(state, real, torch.Generator(device)
                            .manual_seed(k), do_d_reg=True, do_g_reg=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        rest = (at_rest(state) if state.sharding is not None
                else {"total": full + local_bytes(
                    [v for opt in (state.opt_g, state.opt_d)
                     for st in opt.state.values() for k, v in st.items()
                     if k != "step"])})
        out[name] = {"ms": ms[1:], "warm_ms": ms[0],
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "bytes_at_rest": rest["total"]}
        del state, step
        torch.cuda.empty_cache()
    return out


def run_cases(out_dir: str, device: str, cases) -> dict:
    got = {}
    if "fsdp" in cases:
        state, m = mesh_step(device, 1, True)
        got["fsdp"] = {"state": state_out(state, m), "bytes": at_rest(state)}
    if "model" in cases:
        for fsdp in (False, True):
            channels = set()
            state, m = mesh_step(device, 2, fsdp, blur_channels=channels)
            got[f"model_fsdp{int(fsdp)}"] = {"state": state_out(state, m),
                                             "bytes": at_rest(state),
                                             "blur_channels": channels}
    if "ckpt" in cases:
        got["ckpt"] = ckpt_case(out_dir, device)
    if "eval" in cases:
        got["eval"] = eval_case(device, create_mesh())
    if "timing" in cases:
        got["timing"] = timing_case(device)
    return got


def compare(out_dir: str, device: str) -> None:
    """Hold every rank file in ``out_dir`` to the one-process cases;
    prints one JSON line."""
    if device == "cuda":
        torch.backends.cudnn.deterministic = True
    files = sorted(f for f in os.listdir(out_dir) if f.startswith("rank"))
    ranks = [torch.load(os.path.join(out_dir, f), weights_only=False)
             for f in files]
    one = dw.train_case(device)
    two = single_two_steps(device) if "ckpt" in ranks[0] else None
    ev = eval_case(device) if "eval" in ranks[0] else None
    worst, report = {}, {}
    timing = [r.pop("timing") for r in ranks if "timing" in r]
    for r in ranks:
        for key, case in r.items():
            if key == "eval":
                e = check_eval(case, ev)
            elif key == "ckpt":
                e = dw.check_train(case, two)
            else:
                e = dw.check_train(case["state"], one)
                check_at_rest(case["bytes"])
                report[key] = case["bytes"]["held"] / case["bytes"]["full"]
            worst[key] = max(worst.get(key, 0.0), e)
    if timing:
        # the slowest rank's median step, the largest peak and rest
        report["timing"] = {
            k: {"ms": max(sorted(t[k]["ms"])[len(t[k]["ms"]) // 2]
                          for t in timing),
                "peak_gib": max(t[k]["peak_bytes"] for t in timing) / 2**30,
                "rest_gib": max(t[k]["bytes_at_rest"] for t in timing)
                / 2**30}
            for k in timing[0]}
    print(json.dumps({"ranks": len(ranks), "device": device,
                      "worst_rel": worst, "held_share": report}))


def main(out_dir: str, device: str, cases) -> None:
    # on the CPU the ranks share one machine with the test workers
    torch.set_num_threads(1 if device == "cpu" else 2)
    if device == "cuda":
        torch.backends.cudnn.deterministic = True
    assert multihost.initialize(device=device)
    try:
        got = run_cases(out_dir, device, cases)
        torch.save(got, os.path.join(
            out_dir, f"rank{multihost.process_index()}.pt"))
        multihost.synchronize()
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "cpu")
    else:
        main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "cpu",
             (sys.argv[3] if len(sys.argv) > 3 else "fsdp,ckpt").split(","))
