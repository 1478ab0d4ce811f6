"""Dual-space cross-attention interaction blocks.

The math of ``transeditor_tpu/nn/attention.py``: queries from the
content (P) tokens, keys/values from the style (Z) tokens, 16 tokens a
side, so plain batched einsums.  Parity details:

  * grouped projection: planes = out_dim // compress (=128),
    heads = groups (=4), head_dim = 32, softmax scale = planes**-0.5
    (NOT head_dim**-0.5); the softmax runs in float32;
  * pre-norm is a LayerNorm over tokens AND channels jointly
    (``layer_norm_tokens``), applied only to the K/V stream;
  * the MLP's GELU is exact (``approximate='none'``).

Submodule names follow the reference keys: ``atten.q_transform`` /
``k_transform`` / ``v_transform`` / ``proj``, ``mlp.0`` / ``mlp.2`` and,
where the block changes width, ``proj``.
"""

from __future__ import annotations

import torch
from torch import nn

from transeditor_tpu_torch.nn.layers import EqualLinear, layer_norm_tokens


class Attention(nn.Module):
    """Grouped cross-attention: Q <- p tokens, K/V <- z tokens."""

    def __init__(self, q_dim: int, kv_dim: int, out_dim: int, *,
                 lr_mul: float = 1.0, groups: int = 4, compress: int = 4,
                 dtype: torch.dtype = torch.float32,
                 rng: torch.Generator | None = None):
        super().__init__()
        planes = out_dim // compress
        kw = dict(lr_mul=lr_mul, dtype=dtype, rng=rng)
        self.q_transform = EqualLinear(q_dim, planes, **kw)
        self.k_transform = EqualLinear(kv_dim, planes, **kw)
        self.v_transform = EqualLinear(kv_dim, planes, **kw)
        self.proj = EqualLinear(planes, out_dim, **kw)
        self.planes = planes
        self.groups = groups

    def forward(self, kv_tokens: torch.Tensor, q_tokens: torch.Tensor,
                return_similarity: bool = False):
        # kv_tokens: [B, L, C_kv]; q_tokens: [B, M, C_q]
        planes, g = self.planes, self.groups
        gp = planes // g
        q = self.q_transform(q_tokens)
        k = self.k_transform(kv_tokens)
        v = self.v_transform(kv_tokens)
        b, m, _ = q.shape
        l = k.shape[1]
        q = q.reshape(b, m, g, gp)
        k = k.reshape(b, l, g, gp)
        v = v.reshape(b, l, g, gp)

        # sim[b,g,m,l]: softmax over the key axis, in float32
        logits = torch.einsum("bmgp,blgp->bgml", q, k) * planes ** -0.5
        sim = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bgml,blgp->bmgp", sim, v).reshape(b, m, planes)
        out = self.proj(out)
        if return_similarity:
            return out, sim
        return out


class AttentionBlock(nn.Module):
    """Pre-LN cross-attention + MLP residual block."""

    def __init__(self, in_dim: int, q_dim: int, out_dim: int, *,
                 lr_mul: float = 1.0, groups: int = 4,
                 dtype: torch.dtype = torch.float32,
                 rng: torch.Generator | None = None):
        super().__init__()
        kw = dict(lr_mul=lr_mul, dtype=dtype, rng=rng)
        self.atten = Attention(q_dim, in_dim, out_dim, groups=groups, **kw)
        self.mlp = nn.Sequential(EqualLinear(out_dim, out_dim, **kw),
                                 nn.GELU(approximate="none"),
                                 EqualLinear(out_dim, out_dim, **kw))
        if in_dim != out_dim:
            self.proj = EqualLinear(in_dim, out_dim, **kw)
        self.in_dim = in_dim
        self.out_dim = out_dim

    def forward(self, x: torch.Tensor, q_tokens: torch.Tensor,
                return_similarity: bool = False):
        out = self.atten(layer_norm_tokens(x), q_tokens,
                         return_similarity=return_similarity)
        sim = None
        if return_similarity:
            out, sim = out
        if self.in_dim != self.out_dim:
            x = self.proj(x) + out
        else:
            x = x + out
        x = x + self.mlp(layer_norm_tokens(x))
        if return_similarity:
            return x, sim
        return x
