"""Semantic editing CLI (``transeditor_tpu/cli/edit.py``; the
edit_all_{noinversion,inversion}_* analogue).

Two phases (reference our_interfaceGAN/edit_all_noinversion_ffhq.py):
  1. boundary: score --num_sample random decodes with an attribute
     classifier, train Z+/P+ SVM boundaries (cached as .npy);
  2. edit: move samples (or --encoded_z/--encoded_p real-image
     inversions) along the boundaries over per-attribute distances and
     save re-scored strips to <out_dir>/<attr>/<es>_<ec>_<seed>/<space>/.

Usage, on the card:
  python -m transeditor_tpu_torch.cli.edit --ckpt 790000.pt \\
      --attribute age --classifier_ckpt age_sd.pth --num_sample 150000 \\
      --style_distance 3 --content_distance 7 --out_dir edits/ \\
      [--device cuda]

The flags and defaults are the JAX CLI's, plus ``--device``.  Without
``--classifier_ckpt`` the classifier is random, drawn from a
``torch.Generator`` seeded 0 (the JAX CLI draws flax's initialisers from
``PRNGKey(0)``, which the port cannot reproduce).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from transeditor_tpu_torch.cli.common import (add_model_flags,
                                              model_config_from_args)
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.edit.celebahq_classifier import CELEBAHQ_ATTRIBUTES
from transeditor_tpu_torch.edit.classifiers import (
    load_scorer_from_checkpoint, make_attribute_scorer, random_classifier)
from transeditor_tpu_torch.edit.presets import sweep_preset
from transeditor_tpu_torch.edit.sweep import (collect_scored_latents,
                                              edit_sample,
                                              make_strip_decoder,
                                              run_noinversion_sweep,
                                              save_strips,
                                              train_dual_boundaries)
from transeditor_tpu_torch.io.checkpoint import load_reference_generator
from transeditor_tpu_torch.models.generator import Generator


def load_scorer(args, device: torch.device):
    """The ``--classifier_ckpt`` scorer of ``--attribute``, or a random
    one (with the JAX CLI's warning) drawn from a generator seeded 0."""
    if args.classifier_ckpt:
        return load_scorer_from_checkpoint(args.attribute,
                                           args.classifier_ckpt, device)
    print("WARNING: no --classifier_ckpt; using a randomly initialised "
          "classifier (boundaries will be meaningless).")
    net = random_classifier(args.attribute, torch.Generator().manual_seed(0))
    return make_attribute_scorer(args.attribute, net, device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--attribute", type=str, default="age",
                   help="age/gender/pose (FFHQ DEX) or a CelebA "
                        "attribute name")
    p.add_argument("--attribute_index", type=int, default=None,
                   help="index into the 40-entry CelebA-HQ attribute "
                        "registry (reference edit_all_*_celebahq.py)")
    p.add_argument("--classifier_ckpt", type=str, default=None)
    p.add_argument("--num_sample", type=int, default=150_000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--ratio", type=float, default=0.02)
    p.add_argument("--steps", type=int, default=61)
    p.add_argument("--style_distance", type=float, default=3.0)
    p.add_argument("--content_distance", type=float, default=7.0)
    p.add_argument("--config", type=str, default=None,
                   help="JSON sweep config {style_end_distance: [...], "
                        "content_end_distance: [...], seed: [lo, hi]} "
                        "(the reference's config_noinversion/*.json), or "
                        "'preset' / 'preset+seeds' to use the built-in "
                        "per-attribute table (edit/presets.py; +seeds "
                        "adds the reference's seed.json 0..99 grid)")
    p.add_argument("--n_edit_samples", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--truncation", type=float, default=1.0)
    p.add_argument("--out_dir", type=str, default="./edits")
    p.add_argument("--retrain_boundary", action="store_true")
    p.add_argument("--latent_store", choices=("auto", "ram", "memmap"),
                   default="auto",
                   help="where the scored-latent accumulator lives; "
                        "'auto' spills to a tempfile memmap once the "
                        "two trees exceed --latent_mem_budget_gb (the "
                        "150k-sample protocol needs ~10 GB)")
    p.add_argument("--latent_mem_budget_gb", type=float, default=1.0)
    p.add_argument("--encoded_z", type=str, default=None,
                   help="encoder-inverted z+ npy (inversion variant)")
    p.add_argument("--encoded_p", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    add_model_flags(p, dtype_default="bfloat16")
    args = p.parse_args(argv)
    if (args.encoded_z is None) != (args.encoded_p is None):
        p.error("--encoded_z and --encoded_p must be given together")
    if args.attribute_index is not None:
        if not 0 <= args.attribute_index < len(CELEBAHQ_ATTRIBUTES):
            p.error(f"--attribute_index must be in [0, "
                    f"{len(CELEBAHQ_ATTRIBUTES) - 1}]")
        args.attribute = CELEBAHQ_ATTRIBUTES[args.attribute_index]

    dev = resolve_device(args.device)
    cfg = model_config_from_args(args)
    g = Generator(cfg, device=dev)
    g.load_state_dict(load_reference_generator(args.ckpt, cfg), strict=True)
    g.eval()
    scorer = load_scorer(args, dev)

    os.makedirs(args.out_dir, exist_ok=True)
    zb_file = os.path.join(args.out_dir,
                           f"boundary_{args.attribute}_z.npy")
    pb_file = os.path.join(args.out_dir,
                           f"boundary_{args.attribute}_p.npy")
    if os.path.exists(zb_file) and not args.retrain_boundary:
        boundaries = {"z": np.load(zb_file), "p": np.load(pb_file)}
    else:
        z_flat, p_flat, scores = collect_scored_latents(
            g, scorer, n_samples=args.num_sample,
            batch=args.batch, truncation=args.truncation, seed=args.seed,
            store=args.latent_store,
            mem_budget_bytes=int(args.latent_mem_budget_gb * (1 << 30)),
            progress=lambda n: print(f"scored {n}/{args.num_sample}",
                                     flush=True) if n % 6400 == 0 else None)
        boundaries = train_dual_boundaries(z_flat, p_flat, scores,
                                           chosen_ratio=args.ratio,
                                           seed=args.seed, device=dev)
        np.save(zb_file, boundaries["z"])
        np.save(pb_file, boundaries["p"])

    # sweep combos: explicit flags, or the reference's JSON config
    # (style/content end-distance grids x seed range)
    combos = [(args.style_distance, args.content_distance, args.seed)]
    if args.config:
        if args.config in ("preset", "preset+seeds"):
            c = sweep_preset(args.attribute,
                             attribute_index=args.attribute_index,
                             inversion=args.encoded_z is not None,
                             with_seeds=args.config == "preset+seeds")
            if c is None:
                p.error(f"no built-in preset for attribute "
                        f"{args.attribute!r}; pass a JSON --config")
        else:
            with open(args.config) as f:
                c = json.load(f)
        seeds = range(*c.get("seed", [args.seed, args.seed + 1]))
        combos = [(es, ec, s)
                  for s in seeds
                  for es in c.get("style_end_distance",
                                  [args.style_distance])
                  for ec in c.get("content_end_distance",
                                  [args.content_distance])]

    for e_s, e_c, seed in combos:
        _run_one(args, g, scorer, boundaries, e_s, e_c, seed)
    print("edit sweep done")


def _run_one(args, g, scorer, boundaries, style_distance, content_distance,
             seed):
    edit_dir = os.path.join(
        args.out_dir, args.attribute,
        f"{style_distance}_{content_distance}_{seed}")
    if args.encoded_z:
        # inversion variant: edit real-image latents
        z = np.load(args.encoded_z)
        p_codes = np.load(args.encoded_p)
        decode = make_strip_decoder(g, scorer)
        for i in range(min(len(z), args.n_edit_samples)):
            strips = edit_sample(decode, z[i], p_codes[i], boundaries,
                                 style_distance, content_distance,
                                 args.steps)
            save_strips(strips, edit_dir, i, args.attribute)
    else:
        run_noinversion_sweep(
            g, scorer, boundaries, edit_dir, args.attribute,
            style_distance, content_distance,
            n_edit_samples=args.n_edit_samples, steps=args.steps,
            seed=seed, truncation=args.truncation)


if __name__ == "__main__":
    main()
