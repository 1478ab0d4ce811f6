"""pSp encoder training CLI (``transeditor_tpu/cli/train_encoder.py``; the
reference's psp_spatial_train.py).

Usage, on the card:
  python -m transeditor_tpu_torch.cli.train_encoder --ckpt 790000.pt \\
      --dataset_dir train_imgs/ --test_dataset_dir val_imgs/ \\
      [--max_steps 500000] [--lpips_weights alex.pth] \\
      [--arcface model_ir_se50.pth] [--device cuda]

``--ckpt`` is a reference ``.pt`` bundle whose ``g_ema`` is the frozen
decoder.  Writes to ``--exp_dir``: ``logs/metrics.jsonl``, a validation
grid ``val_{step:06d}.png`` (4 images over their 4 inversions) and
``best_model.pt`` whenever the validation loss (up to 64 images of
``--test_dataset_dir``, at steps 0, ``val_interval``, ...) falls, and
``ckpt_{step:06d}.pt`` every ``save_interval`` steps from step > 0
(``io/checkpoint.py::save_coach_state``).  Without ``--lpips_weights``
the AlexNet LPIPS is random (a warning says so); without ``--arcface``
the ID loss is off (a warning says so).
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch

from transeditor_tpu_torch.cli.common import (add_model_flags,
                                              model_config_from_args)
from transeditor_tpu_torch.data.dataset import (ImageFolderSource,
                                                make_train_iterator)
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.io.checkpoint import (load_reference_generator,
                                                 save_coach_state)
from transeditor_tpu_torch.io.zoo_port import load_arcface
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.models.psp import PSPModel
from transeditor_tpu_torch.train.coach import (CoachConfig,
                                               make_arcface_id_loss,
                                               make_coach)
from transeditor_tpu_torch.train.loop import MetricLogger
from transeditor_tpu_torch.utils.image import make_grid, save_png
from transeditor_tpu_torch.zoo.lpips import LPIPS, load_lpips_params


def load_alex_lpips(path: str | None, device: torch.device) -> LPIPS:
    """The AlexNet LPIPS of ``path``, or a random one with a warning."""
    lpips = LPIPS(net="alex", device=device)
    if path:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        lpips.load_state_dict(load_lpips_params(sd, net="alex"), strict=True)
    else:
        warnings.warn("no --lpips_weights given; using random LPIPS weights")
    return lpips


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True, help="decoder .pt bundle")
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--test_dataset_dir", required=True)
    p.add_argument("--exp_dir", type=str, default="./psp_out")
    p.add_argument("--max_steps", type=int, default=500_000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lpips_lambda", type=float, default=0.8)
    p.add_argument("--id_lambda", type=float, default=0.1)
    p.add_argument("--l2_lambda", type=float, default=1.0)
    p.add_argument("--w_norm_lambda", type=float, default=0.0)
    p.add_argument("--use_fake_lambda", type=float, default=0.0)
    p.add_argument("--fake_every", type=int, default=10,
                   help="fake-guidance cadence (psp_training_options.py:86)")
    p.add_argument("--val_interval", type=int, default=2500)
    p.add_argument("--save_interval", type=int, default=10_000)
    p.add_argument("--optim_name", type=str, default="ranger")
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--arcface", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    add_model_flags(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_config_from_args(args)
    decoder = Generator(cfg, device=dev)
    decoder.load_state_dict(load_reference_generator(args.ckpt, cfg),
                            strict=True)
    decoder.eval()
    lpips = load_alex_lpips(args.lpips_weights, dev)

    id_loss = None
    if args.arcface and args.id_lambda > 0:
        id_loss = make_arcface_id_loss(load_arcface(args.arcface).to(dev))
    elif args.id_lambda > 0:
        warnings.warn("--arcface not given; disabling the ID loss")
        args.id_lambda = 0.0

    latent_avg = PSPModel(None, decoder).estimate_latent_avg(
        torch.Generator(dev).manual_seed(1))

    ccfg = CoachConfig(
        max_steps=args.max_steps, batch_size=args.batch_size,
        learning_rate=args.learning_rate, optim_name=args.optim_name,
        lpips_lambda=args.lpips_lambda, id_lambda=args.id_lambda,
        l2_lambda=args.l2_lambda, w_norm_lambda=args.w_norm_lambda,
        use_fake_lambda=args.use_fake_lambda, fake_every=args.fake_every,
        val_interval=args.val_interval, save_interval=args.save_interval)

    init_fn, train_step, eval_step, fake_step = make_coach(
        cfg, ccfg, decoder, lpips, id_loss, latent_avg)
    state = init_fn(seed=2)

    train_src = ImageFolderSource(args.dataset_dir)
    val_src = ImageFolderSource(args.test_dataset_dir)
    train_iter = make_train_iterator(train_src, ccfg.batch_size, cfg.size)
    os.makedirs(args.exp_dir, exist_ok=True)
    logger = MetricLogger(os.path.join(args.exp_dir, "logs"), log_every=50)
    fake_rng = torch.Generator(dev).manual_seed(3)

    try:
        for step in range(ccfg.max_steps):
            real = torch.from_numpy(next(train_iter)).to(dev)
            state, logs, inv = train_step(state, real)
            if ccfg.use_fake_lambda > 0 and step % ccfg.fake_every == 0:
                state, _ = fake_step(state, rng=fake_rng)
            if step % 50 == 0:
                logger.log(step, logs)
            if step % ccfg.val_interval == 0:
                val_losses = []
                for i in range(0, min(len(val_src), 64), ccfg.batch_size):
                    imgs = np.stack([val_src.get(j, cfg.size) for j in
                                     range(i, min(i + ccfg.batch_size,
                                                  len(val_src)))])
                    vimgs = torch.from_numpy(
                        imgs.astype(np.float32) / 127.5 - 1.0).to(dev)
                    vlogs, vinv = eval_step(state, vimgs)
                    val_losses.append(float(vlogs["loss"]))
                val_loss = float(np.mean(val_losses))
                logger.log(step, {"val_loss": val_loss})
                grid = make_grid(np.concatenate(
                    [vimgs[:4].cpu().numpy(),
                     vinv[:4].float().cpu().numpy()]), nrow=4)
                save_png(os.path.join(args.exp_dir, f"val_{step:06d}.png"),
                         grid)
                if val_loss < state.best_val_loss:
                    state.best_val_loss = val_loss
                    save_coach_state(os.path.join(args.exp_dir,
                                                  "best_model.pt"), state)
            if step % ccfg.save_interval == 0 and step > 0:
                save_coach_state(os.path.join(args.exp_dir,
                                              f"ckpt_{step:06d}.pt"), state)
    finally:
        train_iter.close()
        logger.close()


if __name__ == "__main__":
    main()
