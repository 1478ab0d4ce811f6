"""Reference checkpoints of the encoder zoo into the port's modules.

The port's modules carry the reference key layouts (InsightFace for the
IR-SE trunks and ArcFace, pSp for ``GradualStyleEncoder``), so loading is
``load_state_dict(strict=True)``; the JAX package's transposing porters
(``transeditor_tpu/io/zoo_port.py``) have no counterpart here beyond
stripping a prefix and transposing the pSp latent averages
(``transeditor_tpu/cli/encode.py:37-39``).
"""

from __future__ import annotations

import re
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from transeditor_tpu_torch.io.checkpoint import read_torch_file
from transeditor_tpu_torch.models.irse import ArcFaceBackbone
from transeditor_tpu_torch.models.psp import GradualStyleEncoder


def _tensors(sd: Mapping) -> dict:
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _count(sd: Mapping, prefix: str) -> int:
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.")
    ids = {int(m.group(1)) for k in sd for m in [pat.match(k)] if m}
    return max(ids) + 1 if ids else 0


def _load(module: torch.nn.Module, sd: Mapping, own: bool):
    """Load a meta-device ``module`` from ``sd`` with ``strict=True``:
    taking ``sd``'s tensors as its own when ``own`` (no copy), else
    copying them into fresh CPU storage."""
    if own:
        module.load_state_dict(sd, strict=True, assign=True)
    else:
        module.to_empty(device="cpu")
        module.load_state_dict(sd, strict=True)
    return module


def gradual_style_encoder_from_state_dict(sd: Mapping, own: bool = False
                                          ) -> GradualStyleEncoder:
    """A ``GradualStyleEncoder`` (CPU) shaped as the state dict ``sd``
    (head counts, pyramid levels by each head's conv count, head width)
    and loaded from it with ``strict=True``, without running torch's
    initialisers.  ``own``: the encoder may keep ``sd``'s tensors."""
    sd = _tensors(sd)
    n_styles, n_spatial = _count(sd, "styles"), _count(sd, "spatials")
    # a head's convs are convs.0, convs.2, ...: log2(spatial) of them
    levels = [(_count(sd, f"styles.{j}.convs") + 1) // 2
              for j in range(n_styles)]
    with torch.device("meta"):
        enc = GradualStyleEncoder(
            style_count=n_styles, coarse_ind=levels.count(4),
            middle_ind=levels.count(4) + levels.count(5),
            spatial_count=n_spatial,
            head_channels=sd["spatials.0.linear.weight"].shape[0])
    return _load(enc, sd, own)


def load_gradual_style_encoder(sd_or_path) -> Tuple[
        GradualStyleEncoder, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """A pSp checkpoint (a path, or its loaded dict: ``encoder.*`` keys,
    flat or under ``state_dict``) -> (encoder on the CPU, latent_avg).
    ``latent_avg`` is (z [T, D], p [T, D]) from ``z_plus_latent_avg`` /
    ``p_plus_latent_avg`` (stored [D, T]), or None when absent."""
    own = isinstance(sd_or_path, str)
    ckpt = read_torch_file(sd_or_path) if own else sd_or_path
    sd = ckpt.get("state_dict", ckpt)
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items()
              if k.startswith("encoder.")}
    if not enc_sd:
        raise KeyError("no encoder.* keys in the pSp checkpoint")
    avg = None
    if "z_plus_latent_avg" in ckpt:
        avg = tuple(torch.as_tensor(np.asarray(ckpt[k])).float().T.contiguous()
                    for k in ("z_plus_latent_avg", "p_plus_latent_avg"))
    return gradual_style_encoder_from_state_dict(enc_sd, own), avg


def load_arcface(sd_or_path, num_layers: int = 50,
                 use_se: bool = True) -> ArcFaceBackbone:
    """An InsightFace / model_irse ``Backbone`` state dict (or its path)
    -> ``ArcFaceBackbone`` on the CPU in eval mode.  ``num_layers=100,
    use_se=False`` is the IR-101 CurricularFace net of the image
    metrics."""
    own = isinstance(sd_or_path, str)
    sd = read_torch_file(sd_or_path) if own else sd_or_path
    with torch.device("meta"):
        net = ArcFaceBackbone(num_layers, "ir_se" if use_se else "ir")
    return _load(net, _tensors(sd), own).eval()
