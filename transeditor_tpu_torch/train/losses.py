"""GAN losses (``transeditor_tpu/train/losses.py``; reference
train_spatial_query.py:70-105).

Both regularisers differentiate a gradient: ``torch.autograd.grad(...,
create_graph=True)`` keeps the first gradient in the graph, and the
caller's backward takes the second order (through ``fused_blur4``'s own
backward on the generator side).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from transeditor_tpu_torch.parallel.data_parallel import global_mean


def d_logistic_loss(real_pred: torch.Tensor,
                    fake_pred: torch.Tensor) -> torch.Tensor:
    """Non-saturating logistic D loss."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    """Non-saturating logistic G loss."""
    return F.softplus(-fake_pred).mean()


def r1_penalty(d, real_img: torch.Tensor) -> torch.Tensor:
    """R1 gradient penalty E[|grad_x D(x)|^2], differentiable in D's
    parameters.  ``real_img`` must not require grad; a leaf copy does."""
    real = real_img.detach().requires_grad_(True)
    pred = d(real)
    grad, = torch.autograd.grad(pred.float().sum(), real, create_graph=True)
    grad = grad.float()
    return grad.pow(2).reshape(grad.shape[0], -1).sum(dim=1).mean()


def path_length_penalty(synth_fn, latent: torch.Tensor,
                        noise_img: torch.Tensor,
                        mean_path_length: torch.Tensor,
                        decay: float = 0.01, mesh=None):
    """Perceptual path-length regulariser.

    latent: [B, n_latent, D] per-layer styles (in the graph of the
    parameters, or a leaf that requires grad); synth_fn(latent) -> image.
    Returns (penalty, new mean detached, path_lengths).  The running mean
    inside the penalty is not detached, as in the reference; its batch
    mean is over the global batch of the data axis (``mesh``'s, else
    the process group's), the penalty's over this process's rows.
    """
    img = synth_fn(latent).float()
    grad, = torch.autograd.grad((img * noise_img).sum(), latent,
                                create_graph=True)
    grad = grad.float()
    path_lengths = torch.sqrt(grad.pow(2).sum(dim=2).mean(dim=1))
    path_mean = mean_path_length + decay * (global_mean(path_lengths, mesh)
                                            - mean_path_length)
    penalty = (path_lengths - path_mean).pow(2).mean()
    return penalty, path_mean.detach(), path_lengths


def path_noise(rng: torch.Generator, img_shape) -> torch.Tensor:
    """randn(img)/sqrt(H*W), drawn from ``rng`` on its device."""
    b, h, w, c = img_shape
    return torch.randn((b, h, w, c), generator=rng,
                       device=rng.device) / math.sqrt(h * w)
