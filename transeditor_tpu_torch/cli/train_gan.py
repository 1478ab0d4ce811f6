"""GAN training CLI (``transeditor_tpu/cli/train_gan.py``; the
reference's train_spatial_query.py).

One process, on one card:
  python -m transeditor_tpu_torch.cli.train_gan DATA_DIR --exp_name run1 \\
      --batch 16 --size 256 [--iter 800000] [--resume out/run1/checkpoint]

N processes, one card each (data parallel; ``--batch`` is the global
batch, each process loads 1/N of it):
  torchrun --nproc_per_node N -m transeditor_tpu_torch.cli.train_gan ...

``--fsdp`` shards the large parameters, g_ema and the Adam moments over
the processes (``parallel/mesh.py``); with one process it changes
nothing.  As in the JAX package, the ``model`` axis has no flag: it is
reached through ``train(mesh=create_mesh(n_model=...))``.

DATA_DIR: an LMDB written by ``cli/prepare_data.py`` (``data.mdb`` in it,
or ``--lmdb``), else a folder of PNG / JPEG images.  ``--device cpu``
trains on the CPU (gloo between processes).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from transeditor_tpu_torch.cli.common import (add_model_flags,
                                              model_config_from_args)
from transeditor_tpu_torch.config import ModelConfig, TrainConfig
from transeditor_tpu_torch.data.dataset import (ImageFolderSource,
                                                make_train_iterator)
from transeditor_tpu_torch.data.native import NativeLMDBLoader
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.io.checkpoint import restore_train_state
from transeditor_tpu_torch.parallel import multihost
from transeditor_tpu_torch.parallel.mesh import create_mesh
from transeditor_tpu_torch.train.gan import init_state
from transeditor_tpu_torch.train.loop import train


def build_configs(args) -> tuple[ModelConfig, TrainConfig]:
    cfg = model_config_from_args(args)
    tcfg = TrainConfig(
        total_steps=args.iter,
        batch_size=args.batch,
        lr=args.lr,
        r1_gamma=args.r1,
        d_reg_every=args.d_reg_every,
        g_reg_every=args.g_reg_every,
        path_regularize=args.path_regularize,
        path_batch_shrink=args.path_batch_shrink,
        grad_accum=args.grad_accum,
        spatial_regu=args.spatial_regu,
        spatial_path_regularize=args.spatial_path_regularize,
        regu_space=args.regu_space,
        n_sample=args.n_sample,
        seed=args.seed,
    )
    return cfg, tcfg


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("path", type=str)
    p.add_argument("--exp_name", type=str, default="test")
    p.add_argument("--iter", type=int, default=800_000)
    p.add_argument("--batch", type=int, default=16,
                   help="global batch, split over the processes")
    p.add_argument("--n_sample", type=int, default=64)
    p.add_argument("--r1", type=float, default=10.0)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--d_reg_every", type=int, default=16)
    p.add_argument("--g_reg_every", type=int, default=4)
    p.add_argument("--path_regularize", type=float, default=2.0)
    p.add_argument("--path_batch_shrink", type=int, default=2)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split the D/G losses over K sequential "
                        "microbatches (an activation-memory knob; the "
                        "averaged gradient is exact)")
    p.add_argument("--spatial_regu", action="store_true")
    p.add_argument("--spatial_path_regularize", type=float, default=2.0)
    p.add_argument("--regu_space", type=str, default="p+")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="out")
    p.add_argument("--lmdb", action="store_true",
                   help="read PATH as an LMDB with the native loader")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint dir to resume from (latest step)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard large params, g_ema and the Adam moments "
                        "over the processes (ZeRO/FSDP; several processes "
                        "only)")
    p.add_argument("--wandb", action="store_true",
                   help="log scalars to wandb if installed")
    p.add_argument("--log_every", type=int, default=50,
                   help="steps between logged metrics (each log waits "
                        "for the step)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (one card per process) or cpu")
    add_model_flags(p)
    return p


def main(argv: Optional[List[str]] = None):
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    # one process per card, from torchrun's environment; before any
    # other work, as the reference's WORLD_SIZE-triggered init
    joined = multihost.initialize(dev)
    if joined:
        print(f"process {multihost.process_index()}/"
              f"{multihost.process_count()}", flush=True)
    try:
        return _run(args, dev)
    finally:
        if joined:
            multihost.shutdown()


def _run(args, dev):
    cfg, tcfg = build_configs(args)
    # the data axis: every process here (the model axis has no flag)
    mesh = create_mesh()
    local_batch = multihost.local_batch_size(tcfg.batch_size, mesh)
    host_kw = dict(host_index=mesh.data_index, host_count=mesh.n_data)
    if args.lmdb or os.path.exists(os.path.join(args.path, "data.mdb")):
        # uint8 frames, normalised on the device; decoding fans out over
        # the host's cores
        data = NativeLMDBLoader(args.path, local_batch, cfg.size,
                                seed=tcfg.seed, as_uint8=True,
                                workers=max(1, (os.cpu_count() or 2) - 1),
                                **host_kw)
    else:
        data = make_train_iterator(ImageFolderSource(args.path),
                                   local_batch, cfg.size, seed=tcfg.seed,
                                   normalize=False, **host_kw)
    try:
        state, start_step = None, 0
        if args.resume:
            template = init_state(cfg, tcfg, seed=tcfg.seed, device=dev)
            state, ckpt_step = restore_train_state(args.resume, template)
            # checkpoint N holds the state after step N: continue at N + 1
            start_step = ckpt_step + 1
            if multihost.is_main():
                print(f"resumed from step {ckpt_step} -> continuing at "
                      f"{start_step}", flush=True)
        return train(cfg, tcfg, data, out_dir=args.out_dir,
                     exp_name=args.exp_name, state=state,
                     start_step=start_step, device=dev,
                     log_every=args.log_every, use_wandb=args.wandb,
                     mesh=mesh, fsdp=args.fsdp)
    finally:
        data.close()


if __name__ == "__main__":
    main()
