"""TransEditor generator: the dual-space transformer GAN as an nn.Module.

The stage API and forward modes of ``transeditor_tpu/models/generator.py``:
``map_codes`` / ``map_z`` / ``map_p``, ``interact_codes``,
``style_latents_from`` and ``synthesize``, plus a ``forward`` with the
reference's mode seams (``input_is_latent``, ``map_z``/``map_p``,
``trans_interact``, ``noise``, ``return_similarity``).

Dataflow (size=256): Z, P in [B, 16, 512] (tokens-major); per-token
mapping -> Z+, P+; 8 cross-attention blocks (block 0 concatenates a
16x16 identity to both streams, so its inputs are 528 wide);
``adjust_style`` 16->14 mixes across the TOKEN axis into 14 per-layer
styles; P+ becomes the 4x4 input map (site (h, w) holds token 4h+w);
13 styled convs + 7 ToRGB skips -> NHWC image.

Parameter and buffer names are the reference ``.pt`` keys, so a
reference ``g_ema`` state dict loads with ``strict=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.nn.attention import AttentionBlock
from transeditor_tpu_torch.nn.layers import (EqualLinear, StyledConv, ToRGB,
                                             TokenMapping)
from transeditor_tpu_torch.ops.precision import conv_precision


@dataclasses.dataclass
class GeneratorOutput:
    image: torch.Tensor                          # [B, H, W, 3]
    latent: Optional[torch.Tensor] = None        # [B, 14, 512] styles
    p_plus: Optional[torch.Tensor] = None        # [B, 16, 512]
    z_plus: Optional[torch.Tensor] = None        # [B, 16, 512]
    similarity: Optional[list] = None            # per-block [B, g, 16, 16]


class _NoiseBuffers(nn.Module):
    """The reference's fixed ``noises.noise_i`` buffers [1,1,res,res].
    Carried for checkpoint interop; ``synthesize`` takes explicit NHWC
    noise or draws it (as the JAX package does)."""

    def __init__(self, num_layers: int, rng: torch.Generator):
        super().__init__()
        for i in range(num_layers):
            res = 2 ** ((i + 5) // 2)
            self.register_buffer(f"noise_{i}",
                                 torch.randn(1, 1, res, res, generator=rng))


class Generator(nn.Module):
    """Built on ``device`` (default "cuda"; raises if CUDA is absent and
    the CPU was not asked for) with weights drawn from ``seed``."""

    def __init__(self, cfg: ModelConfig, *,
                 device: str | torch.device | None = None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        rng = torch.Generator().manual_seed(seed)

        self.register_buffer("token", torch.eye(cfg.token_dim))
        self.register_buffer("token_spatial", torch.eye(cfg.n_tokens))

        mapping = dict(lr_mul=cfg.lr_mlp, pixel_norm_axis=cfg.pixel_norm_axis,
                       n_mapping=cfg.num_mappings, dtype=dtype, rng=rng)
        self.style_mapping_network = TokenMapping(
            cfg.n_tokens, cfg.style_dim, cfg.style_dim, **mapping)
        if cfg.use_spatial_mapping:
            self.spatial_mapping_network = TokenMapping(
                cfg.n_tokens, cfg.param_dim, cfg.param_dim, **mapping)

        if not cfg.no_trans:
            blocks = []
            for i in range(cfg.n_trans):
                extra = cfg.n_tokens if i == 0 else 0
                blocks.append(AttentionBlock(
                    cfg.style_dim + extra, cfg.param_dim + extra,
                    cfg.style_dim, lr_mul=cfg.lr_mlp,
                    groups=cfg.attn_groups, dtype=dtype, rng=rng))
            self.interact = nn.ModuleList(blocks)

        # 16 interacted tokens -> n_latent (14) per-layer styles
        self.adjust_style = EqualLinear(cfg.n_tokens, cfg.token_dim,
                                        dtype=dtype, rng=rng)

        ch = cfg.channels
        conv = dict(blur_kernel=cfg.blur_kernel,
                    noise_injection=cfg.layer_noise_injection, dtype=dtype,
                    quantize=cfg.quantize, rng=rng)
        self.conv1 = StyledConv(cfg.param_dim, ch[4], 3, cfg.style_dim,
                                **conv)
        self.to_rgb1 = ToRGB(ch[4], cfg.style_dim, upsample=False,
                             dtype=dtype, rng=rng)
        convs, to_rgbs = [], []
        in_ch = ch[4]
        for i in range(3, cfg.log_size + 1):
            out_ch = ch[2 ** i]
            convs.append(StyledConv(in_ch, out_ch, 3, cfg.style_dim,
                                    upsample=True, **conv))
            convs.append(StyledConv(out_ch, out_ch, 3, cfg.style_dim,
                                    **conv))
            to_rgbs.append(ToRGB(out_ch, cfg.style_dim,
                                 blur_kernel=cfg.blur_kernel, dtype=dtype,
                                 rng=rng))
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(to_rgbs)
        self.noises = _NoiseBuffers(cfg.num_layers, rng)
        self.to(dev)

    # ------------------------------------------------------------------
    # stages

    def map_z(self, z: torch.Tensor) -> torch.Tensor:
        return self.style_mapping_network(z)

    def map_p(self, p: torch.Tensor) -> torch.Tensor:
        if self.cfg.use_spatial_mapping:
            return self.spatial_mapping_network(p)
        return p

    def map_codes(self, z: torch.Tensor, p: torch.Tensor,
                  map_z: bool = True, map_p: bool = True):
        """[B,16,D] x2 -> (z_plus, p_plus)."""
        z_plus = self.map_z(z) if map_z else z
        p_plus = self.map_p(p) if map_p else p
        return z_plus, p_plus

    def interact_codes(self, z_plus: torch.Tensor, p_plus: torch.Tensor,
                       return_similarity: bool = False):
        """Cross-attention interaction.  Block 0 takes both streams
        concatenated with the token identity; later blocks re-query with
        P+."""
        b = z_plus.shape[0]
        eye = self.token_spatial.to(z_plus.dtype).expand(b, -1, -1)
        x = torch.cat([z_plus, eye], dim=-1)
        q0 = torch.cat([p_plus, eye.to(p_plus.dtype)], dim=-1)

        sims = []
        out = x
        for i, blk in enumerate(self.interact):
            out = blk(out, q0 if i == 0 else p_plus,
                      return_similarity=return_similarity)
            if return_similarity:
                out, sim = out
                sims.append(sim)
        if return_similarity:
            return out, sims
        return out

    def style_latents_from(self, tokens: torch.Tensor) -> torch.Tensor:
        """16 tokens -> [B, 14, D] per-layer styles; ``adjust_style``
        mixes across the TOKEN axis per feature."""
        return self.adjust_style(tokens.transpose(1, 2)).transpose(1, 2)

    def synthesize(self, p_plus: torch.Tensor, latent: torch.Tensor,
                   noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
                   rng: torch.Generator | None = None) -> torch.Tensor:
        """P+ -> 4x4 input map; 13 styled convs + RGB skips."""
        cfg = self.cfg
        b = p_plus.shape[0]
        # site (h, w) holds token 4h + w
        x = p_plus.reshape(b, 4, 4, cfg.param_dim).to(cfg.compute_dtype)
        if noise is None:
            noise = [None] * cfg.num_layers

        x = self.conv1(x, latent[:, 0], noise=noise[0], rng=rng)
        skip = self.to_rgb1(x, latent[:, 1])
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            x = self.convs[2 * idx](x, latent[:, i], noise=noise[2 * idx + 1],
                                    rng=rng)
            x = self.convs[2 * idx + 1](x, latent[:, i + 1],
                                        noise=noise[2 * idx + 2], rng=rng)
            skip = to_rgb(x, latent[:, i + 2], skip)
            i += 2
        return skip

    # ------------------------------------------------------------------

    def forward(self, z: torch.Tensor, p: torch.Tensor, *,
                input_is_latent: bool = False, map_z: bool = True,
                map_p: bool = True, trans_interact: bool = True,
                noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
                rng: torch.Generator | None = None,
                return_similarity: bool = False) -> GeneratorOutput:
        """Full forward.

        Args:
          z: style codes [B,16,D], or w-space styles [B,14,D] when
            ``input_is_latent``.
          p: content codes [B,16,D] (or P+ when ``map_p=False``).
          noise: per-layer NHWC noise (noise injection only); missing
            layers draw from ``rng``.
        """
        conv_precision(self.cfg.compute_dtype)
        if input_is_latent:
            map_z, trans_interact = False, False
        if self.cfg.no_trans:
            trans_interact = False

        if input_is_latent:
            # P is still mapped in this mode
            p_plus = self.map_p(p) if map_p else p
            z_plus, latent, sims = None, z, None
        else:
            z_plus, p_plus = self.map_codes(z, p, map_z=map_z, map_p=map_p)
            sims = None
            if trans_interact:
                out = self.interact_codes(
                    z_plus, p_plus, return_similarity=return_similarity)
                tokens, sims = out if return_similarity else (out, None)
            else:
                tokens = z_plus       # only meaningful for no_trans models
            latent = self.style_latents_from(tokens)

        image = self.synthesize(p_plus, latent, noise=noise, rng=rng)
        return GeneratorOutput(image=image, latent=latent, p_plus=p_plus,
                               z_plus=z_plus, similarity=sims)
