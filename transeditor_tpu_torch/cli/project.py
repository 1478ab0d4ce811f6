"""Optimisation-inversion CLI (``transeditor_tpu/cli/project.py``; the
reference's projector_optimization.py).

Usage, on the card:
  python -m transeditor_tpu_torch.cli.project --ckpt 790000.pt \\
      --dataset_dir images/ [--step 10000] [--batch 8] \\
      [--lpips_weights lpips_vgg.pt] [--device cuda]

Writes ``origin_i.png``, ``project_i.png``, ``latents.npy`` (z+) and
``param.npy`` (p+) to ``--output_dir``.  The images are inverted
``--batch`` at a time; the last batch is padded to ``--batch`` with
repeats of its last image, and the padded rows are dropped.  Batch ``i``
draws from a generator seeded with its first image's index.
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch

from transeditor_tpu_torch.cli.common import (add_model_flags,
                                              model_config_from_args)
from transeditor_tpu_torch.data.dataset import ImageFolderSource
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.invert.projector import (ProjectorConfig,
                                                    estimate_latent_stats,
                                                    project)
from transeditor_tpu_torch.io.checkpoint import load_reference_generator
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.utils.image import save_png, to_uint8
from transeditor_tpu_torch.zoo.lpips import LPIPS, load_lpips_params


def load_lpips(path: str | None, device: torch.device) -> LPIPS:
    """The VGG LPIPS of ``path`` (a richzhang or StarGAN-v2 state dict),
    or a random one, with a warning, when no path is given."""
    lpips = LPIPS(net="vgg", device=device)
    if path:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        lpips.load_state_dict(load_lpips_params(sd, net="vgg"), strict=True)
    else:
        warnings.warn("no --lpips_weights given; using random LPIPS "
                      "(inversion quality will be poor)")
    return lpips


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--step", type=int, default=10_000)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--mse", type=float, default=0.0)
    p.add_argument("--noise_regularize", type=float, default=1e5)
    p.add_argument("--use_noise", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--truncation", type=float, default=1.0)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--output_dir", type=str,
                   default="./projection/optimization")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    add_model_flags(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_config_from_args(args)
    g = Generator(cfg, device=dev)
    g.load_state_dict(load_reference_generator(args.ckpt, cfg), strict=True)
    g.eval()
    lpips = load_lpips(args.lpips_weights, dev)

    pcfg = ProjectorConfig(steps=args.step, lr=args.lr,
                           mse_weight=args.mse,
                           noise_regularize=args.noise_regularize,
                           optimize_noise=args.use_noise,
                           truncation=args.truncation)

    os.makedirs(args.output_dir, exist_ok=True)
    source = ImageFolderSource(args.dataset_dir)
    stats = estimate_latent_stats(g, seed=0, truncation=args.truncation)

    all_z, all_p = [], []
    for start in range(0, len(source), args.batch):
        idx = list(range(start, min(start + args.batch, len(source))))
        imgs = np.stack([source.get(i, cfg.size) for i in idx])
        n_real = len(idx)
        if n_real < args.batch:
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], args.batch - n_real, 0)])
        target = imgs.astype(np.float32) / 127.5 - 1.0
        res = project(g, lpips, target, pcfg, seed=start, stats=stats,
                      device=dev)
        for k, i in enumerate(idx):
            save_png(os.path.join(args.output_dir, f"origin_{i}.png"),
                     to_uint8(target)[k])
            save_png(os.path.join(args.output_dir, f"project_{i}.png"),
                     to_uint8(res["image"])[k])
        all_z.append(res["z_plus"][:n_real])
        all_p.append(res["p_plus"][:n_real])
        print(f"[{idx[-1] + 1}/{len(source)}] final perceptual "
              f"{res['perceptual_trace'][-1]:.4f}", flush=True)

    np.save(os.path.join(args.output_dir, "latents.npy"),
            np.concatenate(all_z))
    np.save(os.path.join(args.output_dir, "param.npy"),
            np.concatenate(all_p))


if __name__ == "__main__":
    main()
