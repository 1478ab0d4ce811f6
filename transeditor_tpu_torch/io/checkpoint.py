"""Checkpoints: reference-layout ``.pt`` bundles and the train state.

The reference saves ``{'g', 'd', 'g_ema', 'g_optim', 'd_optim'}``
bundles of state dicts.  The port names its parameters as those keys,
so a generator or discriminator state dict loads unchanged.

``save_train_state`` / ``restore_train_state`` keep the whole train
state (g, d, g_ema, both optimizers, the step and the two path-length
means) in one ``torch.save`` file a step, ``<ckpt_dir>/<step:06d>.pt``.
As in the JAX package (``cli/train_gan.py:114-119``), checkpoint ``i``
is the state after step ``i``, so a resumed run starts at ``i + 1``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

from transeditor_tpu_torch.config import ModelConfig


def _reference_entry(pt_path: str, key: str) -> Dict[str, torch.Tensor]:
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=True)
    if key not in ckpt:
        raise KeyError(f"{pt_path} has no {key!r} (keys: {sorted(ckpt)})")
    return ckpt[key]


def load_reference_generator(pt_path: str, cfg: ModelConfig,
                             key: str = "g_ema") -> Dict[str, torch.Tensor]:
    """The ``key`` generator state dict of a reference ``.pt`` bundle
    (CPU tensors).  Raises if its synthesis depth is not ``cfg.size``'s."""
    sd = _reference_entry(pt_path, key)
    last = cfg.log_size - 3                  # index of the last ToRGB
    if (f"to_rgbs.{last}.conv.weight" not in sd
            or f"to_rgbs.{last + 1}.conv.weight" in sd):
        raise ValueError(f"{pt_path}[{key!r}] is not a {cfg.size}px "
                         f"generator")
    return sd


def load_reference_discriminator(pt_path: str, cfg: ModelConfig
                                 ) -> Dict[str, torch.Tensor]:
    """The ``d`` state dict of a reference ``.pt`` bundle (CPU tensors).
    Raises if its number of res blocks is not ``cfg.size``'s."""
    sd = _reference_entry(pt_path, "d")
    last = cfg.log_size - 2                  # index of the last res block
    if (f"convs.{last}.conv1.0.weight" not in sd
            or f"convs.{last + 1}.conv1.0.weight" in sd):
        raise ValueError(f"{pt_path}['d'] is not a {cfg.size}px "
                         f"discriminator")
    return sd


def save_train_state(ckpt_dir: str, step: int, state: Any) -> str:
    """Write ``state`` (a ``train.gan.GANTrainState``) as the checkpoint
    of ``step``; returns its path.  The file appears whole or not at all
    (written beside, then renamed)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step:06d}.pt")
    bundle = {
        "g": state.g.state_dict(), "d": state.d.state_dict(),
        "g_ema": state.g_ema.state_dict(),
        "g_optim": state.opt_g.state_dict(),
        "d_optim": state.opt_d.state_dict(),
        "step": int(state.step),
        "mean_path_length": state.mean_path_length.detach().cpu(),
        "mean_spatial_path_length":
            state.mean_spatial_path_length.detach().cpu(),
    }
    tmp = path + ".tmp"
    torch.save(bundle, tmp)
    os.replace(tmp, path)
    return path


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """Steps with a train-state checkpoint under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(r"(\d+)\.pt", f) for f in os.listdir(ckpt_dir))
                  if m)


def _checkpoint_path(ckpt_dir: str, step: Optional[int]) -> tuple[str, int]:
    if step is None:
        steps = checkpoint_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = steps[-1]
    return os.path.join(ckpt_dir, f"{step:06d}.pt"), step


def load_train_state_generator(ckpt_dir: str, step: Optional[int] = None
                               ) -> tuple[Dict[str, torch.Tensor], int]:
    """The g_ema state dict (CPU tensors) of the latest (or ``step``'s)
    train-state checkpoint under ``ckpt_dir``, and its step."""
    path, step = _checkpoint_path(ckpt_dir, step)
    bundle = torch.load(path, map_location="cpu", weights_only=True)
    return bundle["g_ema"], step


def restore_train_state(ckpt_dir: str, template: Any,
                        step: Optional[int] = None):
    """Load the latest (or ``step``'s) checkpoint into ``template`` (a
    ``GANTrainState`` of the same configuration, e.g. from
    ``init_state``), in place, on its device.  Returns (state, step)."""
    path, step = _checkpoint_path(ckpt_dir, step)
    dev = template.mean_path_length.device
    bundle = torch.load(path, map_location=dev, weights_only=True)
    template.g.load_state_dict(bundle["g"], strict=True)
    template.d.load_state_dict(bundle["d"], strict=True)
    template.g_ema.load_state_dict(bundle["g_ema"], strict=True)
    template.opt_g.load_state_dict(bundle["g_optim"])
    template.opt_d.load_state_dict(bundle["d_optim"])
    template.step = bundle["step"]
    template.mean_path_length = bundle["mean_path_length"].to(dev)
    template.mean_spatial_path_length = \
        bundle["mean_spatial_path_length"].to(dev)
    return template, step
