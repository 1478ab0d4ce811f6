"""Checkpoint evaluation CLI (``transeditor_tpu/cli/evaluate.py``; the
metrics/evaluate_query.py analogue).

Usage, on the card:
  python -m transeditor_tpu_torch.cli.evaluate \\
      --ckpt out/run/checkpoint/790000.pt \\
      --fid --inception_stats inception_ffhq.pkl \\
      --inception_weights pt_inception.pth \\
      [--lpips --lpips_weights lpips_alex.pt] \\
      [--ppl --ppl_lpips_weights lpips_vgg.pt] \\
      [--prdc --real_data imgs/ --vgg16_weights vgg16.pth] \\
      [--dataset ffhq] [--device cuda]

With --ckpt_dir, evaluates every checkpoint and reports the best FID.
The flags, defaults (a bfloat16 generator) and JSON lines are the JAX
CLI's, plus ``--device``, with one difference by design: ``--ppl``
decodes PPL's endpoints through a float32 copy of the generator whatever
``--dtype`` is.  PPL's steps of eps = 1e-4 lie under a bfloat16 ulp of
nearly every code element, so bfloat16 decodes differ by rounding jumps
and the score measures rounding; FID and LPIPS diversity keep
``--dtype``.  A network without its weights flag is the
port's seeded random one, with the JAX CLI's warning (the JAX CLI's are
flax's, which the port cannot reproduce); codes are drawn from
``torch.Generator``s, not ``jax.random``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

import torch

from transeditor_tpu_torch.cli.calc_stats import load_inception, open_source
from transeditor_tpu_torch.cli.common import (add_model_flags,
                                              model_config_from_args)
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.io.checkpoint import load_reference_generator
from transeditor_tpu_torch.metrics.evaluator import (evaluate_checkpoint,
                                                     evaluate_prdc,
                                                     load_real_stats)
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.zoo.lpips import load_lpips


def load_vgg16(path, device):
    from transeditor_tpu_torch.zoo.backbones import VGG16Fc7, load_vgg16_fc7
    if path:
        return load_vgg16_fc7(path).to(device)
    print("WARNING: random VGG16 (pass --vgg16_weights)")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return VGG16Fc7().to(device).eval()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--dataset", type=str, default="ffhq",
                   choices=["ffhq", "celeba_hq"])
    p.add_argument("--fid", action="store_true")
    p.add_argument("--lpips", action="store_true")
    p.add_argument("--ppl", action="store_true")
    p.add_argument("--prdc", action="store_true")
    p.add_argument("--real_data", type=str, default=None,
                   help="real image folder/LMDB (needed for --prdc)")
    p.add_argument("--vgg16_weights", type=str, default=None)
    p.add_argument("--prdc_samples", type=int, default=50_000)
    p.add_argument("--fid_samples", type=int, default=None)
    p.add_argument("--lpips_batches", type=int, default=1000)
    p.add_argument("--ppl_samples", type=int, default=10_000)
    p.add_argument("--ppl_slerp", action="store_true",
                   help="spherical interpolation in PPL "
                        "(evaluate_query.py use_slerp)")
    p.add_argument("--inception_stats", type=str, default=None)
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="AlexNet LPIPS ckpt for the diversity metric")
    p.add_argument("--lpips_backbone", type=str, default=None,
                   help="torchvision alexnet state dict when "
                        "--lpips_weights is heads-only")
    p.add_argument("--ppl_lpips_weights", type=str, default=None,
                   help="richzhang net-lin VGG ckpt for PPL")
    p.add_argument("--ppl_lpips_backbone", type=str, default=None,
                   help="torchvision vgg16 state dict when "
                        "--ppl_lpips_weights is heads-only")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    add_model_flags(p, dtype_default="bfloat16")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_config_from_args(args)
    # reference protocol: 69k samples FFHQ / 29k CelebA-HQ
    fid_samples = args.fid_samples or (69_000 if args.dataset == "ffhq"
                                       else 29_000)

    inception = real_stats = None
    if args.fid:
        assert args.inception_stats, "--fid needs --inception_stats"
        real_stats = load_real_stats(args.inception_stats)
        inception = load_inception(args.inception_weights, dev)

    # two different perceptual nets, per the reference protocol:
    # diversity scores with AlexNet LPIPS, PPL with net-lin VGG
    lpips = ppl_lpips = None
    if args.lpips:
        lpips = load_lpips(args.lpips_weights, "alex", dev,
                           args.lpips_backbone, seed=1)
        if not args.lpips_weights:
            print("WARNING: random alex-LPIPS (pass --lpips_weights)")
    if args.ppl:
        ppl_lpips = load_lpips(args.ppl_lpips_weights, "vgg", dev,
                               args.ppl_lpips_backbone, seed=2)
        if not args.ppl_lpips_weights:
            print("WARNING: random vgg-LPIPS (pass --ppl_lpips_weights)")

    ckpts = [args.ckpt] if args.ckpt else sorted(
        glob.glob(os.path.join(args.ckpt_dir, "*.pt")))
    g = Generator(cfg, device=dev).eval()
    g_ppl = g                  # PPL in float32 whatever --dtype is
    if args.ppl and cfg.dtype != "float32":
        g_ppl = Generator(dataclasses.replace(cfg, dtype="float32"),
                          device=dev).eval()
    best_fid, best_ckpt = float("inf"), None
    results = []
    for ck in ckpts:
        state = load_reference_generator(ck, cfg)
        g.load_state_dict(state, strict=True)
        if g_ppl is not g:
            g_ppl.load_state_dict(state, strict=True)
        report = evaluate_checkpoint(
            g, inception=inception, real_stats=real_stats, lpips=lpips,
            ppl_lpips=ppl_lpips, do_fid=args.fid, do_lpips=args.lpips,
            do_ppl=args.ppl, fid_samples=fid_samples,
            lpips_batches=args.lpips_batches, ppl_samples=args.ppl_samples,
            batch=args.batch, ppl_slerp=args.ppl_slerp, ppl_g=g_ppl)
        out = {"ckpt": ck, "fid": report.fid, "lpips": report.lpips,
               "ppl": report.ppl}
        if args.prdc:
            assert args.real_data, "--prdc needs --real_data"
            src = open_source(args.real_data)
            vgg = load_vgg16(args.vgg16_weights, dev)
            out["prdc"] = evaluate_prdc(g, vgg, src,
                                        n_samples=args.prdc_samples,
                                        batch=args.batch)
            print(json.dumps({"prdc": out["prdc"]}), flush=True)
        print(json.dumps(out), flush=True)
        results.append(out)
        if report.fid is not None and report.fid < best_fid:
            best_fid, best_ckpt = report.fid, ck
    if args.fid and len(ckpts) > 1:
        print(json.dumps({"best_fid": best_fid, "best_ckpt": best_ckpt}))
    return results


if __name__ == "__main__":
    main()
