"""Export a checkpoint in the reference torch ``.pt`` layout
(``transeditor_tpu/cli/export_pt.py``): reference-code users load it
with ``Generator(...).load_state_dict(ckpt['g_ema'])``.

Sources:
  * a directory of the port's training checkpoints, as
    ``cli.train_gan`` writes them (``--state_dir out/run/checkpoint
    [--step N]``, the latest step unless ``--step``), or
  * a reference ``.pt`` (``--ckpt in.pt``), a round trip for format
    surgery.

The port's state dicts are already in the reference layout, so the
export is a ``torch.save`` of CPU tensors: ``{'g', 'd', 'g_ema'}``, or
only ``g_ema`` with ``--ema_only``.  The JAX CLI's ``--orbax_dir`` is
refused: the port has no JAX to read an orbax checkpoint.

Usage:
  python -m transeditor_tpu_torch.cli.export_pt \\
      --state_dir out/run/checkpoint --out 790000_exported.pt
"""

from __future__ import annotations

import argparse

from transeditor_tpu_torch.cli.common import (add_model_flags,
                                              model_config_from_args)
from transeditor_tpu_torch.io.checkpoint import (
    export_reference_checkpoint, load_reference_discriminator,
    load_reference_generator, load_train_state_bundle)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--state_dir", type=str, default=None,
                   help="cli.train_gan checkpoint dir (latest step "
                        "unless --step)")
    p.add_argument("--orbax_dir", type=str, default=None,
                   help="the JAX package's orbax checkpoints: not read "
                        "by the port")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--ckpt", type=str, default=None,
                   help="reference-format .pt to round-trip instead")
    p.add_argument("--out", required=True)
    p.add_argument("--ema_only", action="store_true",
                   help="export only g_ema (skip g/d)")
    add_model_flags(p)
    args = p.parse_args(argv)

    if args.orbax_dir is not None:
        raise ValueError(
            f"--orbax_dir {args.orbax_dir}: an orbax checkpoint of the JAX "
            f"package; the PyTorch port exports its own training "
            f"checkpoints (--state_dir) or a reference .pt (--ckpt)")
    if (args.state_dir is None) == (args.ckpt is None):
        p.error("pass exactly one of --state_dir / --ckpt")

    if args.state_dir:
        bundle, step = load_train_state_bundle(args.state_dir, args.step)
        print(f"exporting step {step}")
        g_ema = bundle["g_ema"]
        g = None if args.ema_only else bundle["g"]
        d = None if args.ema_only else bundle["d"]
    else:
        cfg = model_config_from_args(args)
        g_ema = load_reference_generator(args.ckpt, cfg)
        g = d = None
        if not args.ema_only:
            g = load_reference_generator(args.ckpt, cfg, key="g")
            d = load_reference_discriminator(args.ckpt, cfg)

    export_reference_checkpoint(args.out, g_ema=g_ema, g=g, d=d)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
