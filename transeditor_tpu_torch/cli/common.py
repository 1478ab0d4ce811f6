"""Shared model-shape flag set for every entry point (reference flag
names kept verbatim), mapping onto the port's ``ModelConfig``."""

from __future__ import annotations

import argparse

from transeditor_tpu_torch.config import ModelConfig


def add_model_flags(p: argparse.ArgumentParser,
                    dtype_default: str = "float32") -> None:
    """Register the architecture flags."""
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--num_region", type=int, default=1)
    p.add_argument("--num_trans", type=int, default=8)
    p.add_argument("--para_num", type=int, default=16,
                   help="tokens per latent space (reference --para_num)")
    p.add_argument("--no_trans", action="store_true")
    p.add_argument("--no_spatial_map", action="store_true")
    p.add_argument("--pixel_norm_op_dim", type=int, default=1,
                   choices=(1, 2))
    p.add_argument("--inject_noise", action="store_true")
    p.add_argument("--dtype", type=str, default=dtype_default,
                   choices=("float32", "bfloat16"))


def model_config_from_args(args, **overrides) -> ModelConfig:
    """Build a ModelConfig from parsed flags; kwargs override."""
    kw = dict(
        size=args.size,
        channel_multiplier=args.channel_multiplier,
        layer_noise_injection=args.inject_noise,
        use_spatial_mapping=not args.no_spatial_map,
        num_region=args.num_region,
        n_trans=args.num_trans,
        n_tokens=args.para_num,
        pixel_norm_axis=("feature" if args.pixel_norm_op_dim == 1
                         else "token"),
        no_trans=args.no_trans,
        dtype=args.dtype,
    )
    kw.update(overrides)
    return ModelConfig(**kw)
