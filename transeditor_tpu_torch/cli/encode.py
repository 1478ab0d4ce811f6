"""Dual-space encoder inference CLI (``transeditor_tpu/cli/encode.py``;
the reference's dual_space_encoder_test.py): batch-encode a folder into
``encoded_z.npy`` / ``encoded_p.npy`` ([N, 16, 512] float32) for the
editing pipeline.

Usage, on the card:
  python -m transeditor_tpu_torch.cli.encode --decoder_ckpt 790000.pt \\
      --encoder_ckpt psp_out/best_model.pt --data_dir test_imgs/ \\
      --out_dir projection/encoder_inversion/ffhq_encode \\
      [--batch 8] [--save_inversions] [--device cuda]

``--encoder_ckpt`` is a reference pSp ``.pt`` / ``.pth`` (``encoder.*``
keys and the plus-space latent averages) or a coach checkpoint of
``cli.train_encoder`` (its latent average is estimated anew from 10k
draws seeded 0, as the JAX CLI does for its orbax checkpoints).  The
last batch may be short.  ``--save_inversions`` also writes
``inversion_{i}.png``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from transeditor_tpu_torch.cli.common import (add_model_flags,
                                              model_config_from_args)
from transeditor_tpu_torch.data.dataset import ImageFolderSource
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.invert.dual_space import DualSpaceEncoder
from transeditor_tpu_torch.io.checkpoint import (is_coach_bundle,
                                                 load_reference_generator,
                                                 read_torch_file)
from transeditor_tpu_torch.io.zoo_port import (
    gradual_style_encoder_from_state_dict, load_gradual_style_encoder)
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.utils.image import save_png, to_uint8


def load_encoder(path: str):
    """(encoder on the CPU, latent_avg or None) of a pSp ``.pt`` /
    ``.pth`` or a coach checkpoint."""
    ckpt = read_torch_file(path)
    if is_coach_bundle(ckpt):
        return gradual_style_encoder_from_state_dict(ckpt["encoder"],
                                                     own=True), None
    return load_gradual_style_encoder(ckpt)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--decoder_ckpt", required=True)
    p.add_argument("--encoder_ckpt", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--save_inversions", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    add_model_flags(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_config_from_args(args)
    decoder = Generator(cfg, device=dev)
    decoder.load_state_dict(load_reference_generator(args.decoder_ckpt, cfg),
                            strict=True)
    encoder, latent_avg = load_encoder(args.encoder_ckpt)
    dse = DualSpaceEncoder(decoder, encoder.to(dev), latent_avg, seed=0)

    source = ImageFolderSource(args.data_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    zs, ps = [], []
    for start in range(0, len(source), args.batch):
        idx = list(range(start, min(start + args.batch, len(source))))
        imgs = np.stack([source.get(i, cfg.size) for i in idx])
        z, p_codes = dse.encode(imgs.astype(np.float32) / 127.5 - 1.0)
        zs.append(z)
        ps.append(p_codes)
        if args.save_inversions:
            inv = to_uint8(dse.decode(z, p_codes))
            for k, i in enumerate(idx):
                save_png(os.path.join(args.out_dir, f"inversion_{i}.png"),
                         inv[k])
        print(f"encoded {idx[-1] + 1}/{len(source)}", flush=True)

    np.save(os.path.join(args.out_dir, "encoded_z.npy"), np.concatenate(zs))
    np.save(os.path.join(args.out_dir, "encoded_p.npy"), np.concatenate(ps))


if __name__ == "__main__":
    main()
