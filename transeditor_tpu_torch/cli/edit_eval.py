"""Edit-quality evaluation CLI (``transeditor_tpu/cli/edit_eval.py``; the
editing_evaluate / calculate_score / editing_evaluate_id analogue).

Re-scores saved edit strips (from cli/edit.py) with one or more
attribute classifiers, then reports per-space disentanglement ratios
(drift of interest attributes / drift of the edited attribute),
score correlations, boundary cosines, and optional ArcFace ID
preservation vs the strip's center frame.

Usage, on the card:
  python -m transeditor_tpu_torch.cli.edit_eval \\
      --strips_dir edits/age/3.0_7.0_0 --edited_attr age \\
      --classifier age=age_sd.pth gender=gender_sd.pth \\
      [--arcface ir_se50.pth] [--boundaries edits/boundary_age_z.npy ...] \\
      [--device cuda]

Frames are read with ``utils/image.py::load_png`` (no PIL).
``--id_inception WEIGHTS`` reports ID drift in InceptionV3 pool3 space
from a pytorch-fid checkpoint; without a path it raises ``ValueError``
(the JAX CLI's random flax network cannot be reproduced).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from collections import defaultdict

import numpy as np
import torch

from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.edit.classifiers import load_scorer_from_checkpoint
from transeditor_tpu_torch.edit.evaluate import (boundary_cosine,
                                                 disentanglement_score,
                                                 score_correlation,
                                                 to_numpy)
from transeditor_tpu_torch.utils.image import load_png

SPACES = ("pz_plus", "p_plus", "z_plus")
_FRAME_RE = re.compile(r"origin_(\d+)_edit_(\d+)_")


def load_strips(strips_dir: str):
    """{space: {sample: [steps,H,W,3] float[-1,1]}} from saved frames."""
    out = {}
    for space in SPACES:
        d = os.path.join(strips_dir, space)
        if not os.path.isdir(d):
            continue
        frames = defaultdict(dict)
        for f in glob.glob(os.path.join(d, "origin_*_edit_*.png")):
            m = _FRAME_RE.search(os.path.basename(f))
            if not m:
                continue
            i, j = int(m.group(1)), int(m.group(2))
            frames[i][j] = f
        samples = {}
        for i, steps in frames.items():
            imgs = [load_png(steps[j]) for j in sorted(steps)]
            samples[i] = np.stack(imgs).astype(np.float32) / 127.5 - 1.0
        if samples:
            out[space] = samples
    return out


def build_scorers(specs, device=None):
    """{attr: Scorer} of ``attr=ckpt.pth`` specs, on ``device`` (default
    cuda)."""
    scorers = {}
    for spec in specs or []:
        name, path = spec.split("=", 1)
        scorers[name] = load_scorer_from_checkpoint(name, path, device)
    return scorers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--strips_dir", required=True)
    ap.add_argument("--edited_attr", required=True)
    ap.add_argument("--classifier", nargs="*", default=None,
                    help="attr=ckpt.pth pairs")
    ap.add_argument("--arcface", type=str, default=None)
    ap.add_argument("--id_inception", nargs="?", const="", default=None,
                    help="ID drift in InceptionV3 pool3 feature space; "
                         "takes the pytorch-fid weights' path")
    ap.add_argument("--boundaries", nargs="*", default=None,
                    help="boundary .npy files to cross-compare")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.id_inception == "":
        raise ValueError(
            "--id_inception needs the InceptionV3 weights' path (a "
            "pytorch-fid checkpoint): the port has no random stand-in for "
            "the JAX CLI's flax initialisation")

    dev = resolve_device(args.device)
    strips = load_strips(args.strips_dir)
    scorers = build_scorers(args.classifier, dev)
    report = {}

    if scorers:
        trajs = {a: {s: [] for s in strips} for a in scorers}
        for space, samples in strips.items():
            for i, imgs in sorted(samples.items()):
                for attr, scorer in scorers.items():
                    trajs[attr][space].append(
                        to_numpy(scorer(imgs)).tolist())
        report["trajectories"] = trajs
        if args.edited_attr in scorers:
            dis = {}
            for space in strips:
                change = trajs[args.edited_attr][space]
                for attr in scorers:
                    if attr == args.edited_attr:
                        continue
                    dis[f"{attr}/{space}"] = disentanglement_score(
                        change, trajs[attr][space])
                    dis[f"corr_{attr}/{space}"] = score_correlation(
                        change, trajs[attr][space])
            report["disentanglement"] = dis

    def _id_report(embed):
        """Per-space mean cosine similarity of each edit step to the
        strip center; the center embeds ONCE per strip."""
        ids = {}
        for space, samples in strips.items():
            sims = []
            for i, imgs in samples.items():
                feats = to_numpy(embed(imgs))
                mid = feats[len(imgs) // 2]
                sims.append(float(np.mean(feats @ mid)))
            ids[space] = float(np.mean(sims))
        return ids

    if args.arcface:
        from transeditor_tpu_torch.io.zoo_port import load_arcface
        from transeditor_tpu_torch.train.coach import face_crop, resize_112
        arc = load_arcface(args.arcface).to(dev).requires_grad_(False)

        def arc_embed(img):
            x = torch.as_tensor(img).to(dev, torch.float32)
            with torch.no_grad():
                return arc(resize_112(face_crop(x)))

        report["id_preservation"] = _id_report(arc_embed)

    if args.id_inception:
        # ID drift in the reference's feature space (InceptionV3 pool3),
        # as the mean cosine similarity of each step to the strip center;
        # inputs stay in [-1, 1]
        from transeditor_tpu_torch.metrics.inception import load_fid_inception
        inc = load_fid_inception(args.id_inception).to(dev)

        def inc_embed(img):
            x = torch.as_tensor(img).to(dev, torch.float32)
            with torch.no_grad():
                f = inc(x)
            return f * torch.rsqrt((f * f).sum(dim=-1, keepdim=True) + 1e-12)

        report["id_preservation_inception"] = _id_report(inc_embed)

    if args.boundaries and len(args.boundaries) >= 2:
        cos = {}
        for i in range(len(args.boundaries)):
            for j in range(i + 1, len(args.boundaries)):
                a, b = args.boundaries[i], args.boundaries[j]
                cos[f"{os.path.basename(a)}~{os.path.basename(b)}"] = \
                    boundary_cosine(np.load(a), np.load(b))
        report["boundary_cosine"] = cos

    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
