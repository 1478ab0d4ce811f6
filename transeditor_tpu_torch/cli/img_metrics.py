"""Folder-vs-folder inference metrics, LPIPS / L2 / ID
(``transeditor_tpu/cli/img_metrics.py``).

Usage, on the card:
  python -m transeditor_tpu_torch.cli.img_metrics --mode lpips \\
      --data_path results/ --gt_path gt_images/ \\
      [--lpips_weights alex.pth] [--batch_size 8] [--resolution 256] \\
      [--device cuda]
  python -m transeditor_tpu_torch.cli.img_metrics --mode id \\
      --data_path results/ --gt_path gt_images/ \\
      --arcface curricular_face.pth [--arcface_depth 100] \\
      [--arcface_mode ir]

The analogue of ``pSp/scripts/calc_losses_on_images.py`` (lpips / l2)
and ``pSp/scripts/calc_id_loss_parallel.py`` (id).  Writes the
reference's ``stat_{mode}.txt`` and ``scores_{mode}.json`` under
``<data_path>/../inference_metrics``.  The flags are the JAX CLI's, plus
``--device``; without ``--lpips_weights`` the LPIPS is the port's seeded
random one.
"""

from __future__ import annotations

import argparse
import os

from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.metrics.paired import (make_id_fn, make_l2_fn,
                                                  make_lpips_fn,
                                                  pair_folders,
                                                  paired_scores,
                                                  write_report)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["lpips", "l2", "id"],
                    default="lpips")
    ap.add_argument("--data_path", required=True,
                    help="results folder (scored against --gt_path)")
    ap.add_argument("--gt_path", required=True)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--lpips_weights", type=str, default=None,
                    help="torch LPIPS linear-head checkpoint "
                         "(random-init heads without it)")
    ap.add_argument("--lpips_net", choices=["alex", "vgg"],
                    default="alex")
    ap.add_argument("--arcface", type=str, default=None,
                    help="face-recognition backbone .pth (id mode)")
    ap.add_argument("--arcface_depth", type=int, default=100,
                    choices=[50, 100, 152],
                    help="IR depth; the reference uses IR-101 "
                         "CurricularFace (calc_id_loss_parallel.py:29)")
    ap.add_argument("--arcface_mode", choices=["ir", "ir_se"],
                    default="ir")
    ap.add_argument("--out", type=str, default=None,
                    help="report dir (default "
                         "<data_path>/../inference_metrics)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    pairs = pair_folders(args.data_path, args.gt_path)
    print(f"Running on {len(pairs)} paired images, mode={args.mode}")

    if args.mode == "l2":
        fn = make_l2_fn()
    elif args.mode == "lpips":
        from transeditor_tpu_torch.zoo.lpips import load_lpips
        net = load_lpips(args.lpips_weights, args.lpips_net, dev)
        if not args.lpips_weights:
            print("WARNING: random-init LPIPS heads "
                  "(pass --lpips_weights for comparable numbers)")
        fn = make_lpips_fn(net)
    else:
        if not args.arcface:
            raise SystemExit("--mode id requires --arcface weights")
        from transeditor_tpu_torch.io.zoo_port import load_arcface
        arc = load_arcface(args.arcface, num_layers=args.arcface_depth,
                           use_se=(args.arcface_mode == "ir_se"))
        fn = make_id_fn(arc.to(dev).requires_grad_(False))

    scores = paired_scores(fn, pairs, resolution=args.resolution,
                           batch_size=args.batch_size, progress=True,
                           device=dev)
    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(args.data_path)),
        "inference_metrics")
    mean, std = write_report(scores, out, args.mode)
    print(f"Average {args.mode} over {len(scores)} images: "
          f"{mean:.4f} +- {std:.4f}  -> {out}")


if __name__ == "__main__":
    main()
