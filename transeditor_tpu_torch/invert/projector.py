"""Optimisation-based inversion: the projector
(``transeditor_tpu/invert/projector.py``; reference
projector_optimization.py).

Per batch of target images, (Z+, P+) start at the mean of 10k mapped
samples, then Adam minimises

    sum_batch LPIPS_vgg(G(z+, p+), target)
    + mse_weight * mean((G - target)^2)
    + noise_regularize * noise_regularize(noises)   (optimize_noise only)

with a cosine-ramped learning rate, annealed latent noise on z+
(``optimize_noise`` only), per-step renormalisation of the noise maps,
and plus-space decoding (both mapping networks bypassed).

A plain per-step loop (the JAX package's chunked ``lax.scan`` is a TPU
compile workaround).  Only z+, p+ and, with ``optimize_noise``, the
noise maps take gradients: the generator's and the LPIPS network's
parameters are frozen for the run, so the backward computes no weight
gradients.  On the card every up-conv blur of the generator runs the
``fused_blur4`` kernel: its forward, and in the backward its adjoint and
recompute launches (``ops/fused_blur.py``).

Randomness comes from a ``torch.Generator`` seeded by the caller:
the latent statistics' draws, the initial noise maps and the per-step
latent noise.  ``project`` also takes the latter two as arguments (a
parity test feeds the JAX package's draws), as ``estimate_latent_stats``
takes its draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.utils.sampling import sample_zp
from transeditor_tpu_torch.zoo.lpips import LPIPS


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    steps: int = 10_000
    lr: float = 0.1
    lr_rampup: float = 0.05
    lr_rampdown: float = 0.25
    noise: float = 0.05          # latent-noise strength factor
    noise_ramp: float = 0.75
    noise_regularize: float = 1e5
    mse_weight: float = 0.0
    optimize_noise: bool = False  # --use_noise
    truncation: float = 1.0
    trace_every: int = 10


def lr_schedule(step: int, total: int, initial_lr: float,
                rampdown: float = 0.25, rampup: float = 0.05) -> float:
    """Cosine rampdown with a linear warm-up (reference get_lr)."""
    t = step / total
    ramp = min(1.0, (1.0 - t) / rampdown)
    ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
    ramp = ramp * min(1.0, t / rampup)
    return initial_lr * ramp


def noise_regularize(noises: Sequence[torch.Tensor]) -> torch.Tensor:
    """Multi-scale roll-correlation penalty over NHWC [B, S, S, 1] maps:
    at each scale, the squared mean product with the map rolled by one
    along W and along H, then 2x2 mean pooling, down to 8."""
    loss = torch.zeros((), dtype=torch.float32, device=noises[0].device)
    for noise in noises:
        n = noise.float()
        size = n.shape[1]
        while True:
            loss = (loss + (n * torch.roll(n, 1, dims=2)).mean() ** 2
                    + (n * torch.roll(n, 1, dims=1)).mean() ** 2)
            if size <= 8:
                break
            b = n.shape[0]
            n = n.reshape(b, size // 2, 2, size // 2, 2, 1).mean(dim=(2, 4))
            size //= 2
    return loss


def noise_normalize(noises: Sequence[torch.Tensor]) -> list:
    """(noise - mean) / std over each whole map, batch included, with
    the UNBIASED std (torch ``Tensor.std()``, as the reference uses)."""
    return [(n - n.mean()) / (n.std() + 1e-12) for n in noises]


def make_noise_shapes(cfg: ModelConfig, batch: int) -> list:
    shapes = [(batch, 4, 4, 1)]
    for i in range(3, cfg.log_size + 1):
        for _ in range(2):
            shapes.append((batch, 2 ** i, 2 ** i, 1))
    return shapes


def _tensor(x, dev: torch.device) -> torch.Tensor:
    """An array or tensor as a float32 tensor on ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.float().to(dev)


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


@torch.no_grad()
def estimate_latent_stats(g: Generator, seed: int | torch.Generator = 0,
                          n_samples: int = 10_000, chunk: int = 1000,
                          truncation: float = 1.0,
                          draws: Optional[Sequence] = None):
    """Mean and std of the plus spaces from mapped random draws, on the
    generator's device: (z_mean [T, D], z_std [D], p_mean [T, D]).

    ``z_std`` is sqrt(sum over tokens of the per-dimension variance), as
    the reference's latent_std.  ``draws``: the chunks' (z, p) pairs, in
    place of ``n_samples // chunk`` draws from ``seed`` (a generator on
    the generator's device, or the seed of a new one)."""
    cfg, dev = g.cfg, _device_of(g)
    if draws is None:
        rng = (seed if isinstance(seed, torch.Generator)
               else torch.Generator(dev).manual_seed(seed))
        draws = (sample_zp(rng, chunk, cfg.n_tokens, cfg.style_dim,
                           truncation) for _ in range(n_samples // chunk))
    zs = ps = sq = 0.0
    n = 0
    for z, p in draws:
        zp, pp = g.map_codes(_tensor(z, dev), _tensor(p, dev))
        zs = zs + zp.sum(0)
        ps = ps + pp.sum(0)
        sq = sq + (zp.float() ** 2).sum(0)
        n += zp.shape[0]
    z_mean, p_mean = zs / n, ps / n
    var_sum = (sq / n - z_mean.float() ** 2).sum(0)
    return z_mean, torch.sqrt(var_sum.clamp_min(0.0)), p_mean


@contextlib.contextmanager
def _frozen(*modules: torch.nn.Module):
    """Parameters of ``modules`` take no gradient inside; restored after."""
    params = [p for m in modules for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(False)
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def _decode(g: Generator, z, p, noises, rng) -> torch.Tensor:
    """Plus-space decode (mappings bypassed), float32, mean-pooled to
    256px when larger."""
    img = g(z, p, map_z=False, map_p=False, noise=noises, rng=rng).image
    img = img.float()
    if img.shape[1] > 256:
        f = img.shape[1] // 256
        b, h, w, c = img.shape
        img = img.reshape(b, h // f, f, w // f, f, c).mean(dim=(2, 4))
    return img


def projector_loss(g: Generator, lpips: LPIPS, target: torch.Tensor,
                   z: torch.Tensor, p: torch.Tensor,
                   noises: Optional[Sequence[torch.Tensor]],
                   pcfg: ProjectorConfig, rng: torch.Generator | None = None):
    """The objective at plus-space latents (``z`` with its latent noise
    already added; ``noises`` the optimised maps, or None without
    ``optimize_noise``): (total, perceptual, noise regulariser, mse),
    float32 scalars.  The mse is computed even at weight 0, for its
    trace."""
    img = _decode(g, z, p, noises, rng)
    p_loss = lpips(img, target).sum()
    mse = ((img - target) ** 2).mean()
    total = p_loss + pcfg.mse_weight * mse
    if noises is None:
        n_loss = torch.zeros((), device=img.device)
    else:
        n_loss = noise_regularize(noises)
        total = total + pcfg.noise_regularize * n_loss
    return total, p_loss, n_loss, mse


def projector_step(g: Generator, lpips: LPIPS, target: torch.Tensor,
                   opt: torch.optim.Adam, z_std: torch.Tensor, step: int,
                   pcfg: ProjectorConfig, draw=None,
                   rng: torch.Generator | None = None):
    """Step ``step`` of ``project``: ``opt`` holds [z+, p+, *noise maps]
    (the maps only with ``optimize_noise``).  The objective at z+ plus
    its latent noise (``draw``, a standard normal [B, T, D], drawn from
    ``rng`` when None; ``optimize_noise`` only), its gradients in the
    optimised tensors (left in their ``.grad``), one Adam update at
    ``lr_schedule(step)`` and the maps renormalised.  Returns the
    detached (perceptual, noise regulariser, mse)."""
    opt_vars = opt.param_groups[0]["params"]
    z, p, maps = opt_vars[0], opt_vars[1], opt_vars[2:] or None
    z_in = z
    if pcfg.optimize_noise:
        ramp = max(0.0, 1.0 - step / pcfg.steps / pcfg.noise_ramp)
        strength = z_std * (pcfg.noise * ramp ** 2)
        draw = (torch.randn(z.shape, generator=rng, device=z.device)
                if draw is None else _tensor(draw, z.device))
        z_in = z + draw * strength
    total, p_loss, n_loss, mse = projector_loss(g, lpips, target, z_in, p,
                                                maps, pcfg, rng)
    grads = torch.autograd.grad(total, opt_vars)
    for var, grad in zip(opt_vars, grads):
        var.grad = grad
    opt.param_groups[0]["lr"] = lr_schedule(
        step, pcfg.steps, pcfg.lr, pcfg.lr_rampdown, pcfg.lr_rampup)
    opt.step()
    if maps is not None:
        with torch.no_grad():
            for m, n in zip(maps, noise_normalize(maps)):
                m.copy_(n)
    return p_loss.detach(), n_loss.detach(), mse.detach()


def project(g: Generator, lpips: LPIPS, target_images,
            pcfg: ProjectorConfig = ProjectorConfig(), *, seed: int = 0,
            stats=None, noises: Optional[Sequence] = None,
            latent_noise: Optional[Sequence] = None,
            device: str | torch.device | None = None) -> dict:
    """Invert ``target_images`` ([B, H, W, 3] in [-1, 1], array or
    tensor) on ``device`` (default "cuda"; raises without a card unless
    "cpu"), where ``g`` and ``lpips`` (net "vgg" in the reference) must
    already be.

    ``stats``: (z_mean, z_std, p_mean) from ``estimate_latent_stats``;
    estimated here on 10k draws when None.  ``noises``: the initial
    NHWC noise maps (``make_noise_shapes``), ``latent_noise[k]``: step
    k's standard normal [B, T, D] draw; both read only with
    ``optimize_noise``.  What is not given is drawn, in that order, from
    one generator seeded with ``seed``.

    Returns numpy arrays: z_plus, p_plus, image, the perceptual / noise /
    mse traces (every ``trace_every``-th step) and, with
    ``optimize_noise``, the noise maps.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    for name, m in (("generator", g), ("lpips", lpips)):
        if _device_of(m) != dev:
            raise ValueError(f"the {name} is on {_device_of(m)}, the "
                             f"projector runs on {dev}")
    cfg = g.cfg
    rng = torch.Generator(dev).manual_seed(seed)
    if stats is None:
        stats = estimate_latent_stats(g, rng, truncation=pcfg.truncation)
    z_mean, z_std, p_mean = (_tensor(s, dev) for s in stats)
    target = _tensor(target_images, dev)
    batch = target.shape[0]

    z = z_mean.expand(batch, *z_mean.shape).clone()
    p = p_mean.expand(batch, *p_mean.shape).clone()
    opt_vars = [z, p]
    maps = None
    if pcfg.optimize_noise:
        if noises is None:
            noises = [torch.randn(s, generator=rng, device=dev)
                      for s in make_noise_shapes(cfg, batch)]
        maps = [_tensor(n, dev).clone() for n in noises]
        opt_vars += maps
    for var in opt_vars:
        var.requires_grad_(True)
    # update k takes lr_schedule(k): the first moves nothing
    opt = torch.optim.Adam(opt_vars, lr=0.0, betas=(0.9, 0.999), eps=1e-8)

    traces = []
    with _frozen(g, lpips):
        for step in range(pcfg.steps):
            draw = None if latent_noise is None else latent_noise[step]
            traces.append(torch.stack(projector_step(
                g, lpips, target, opt, z_std, step, pcfg, draw, rng)))
        with torch.no_grad():
            final = _decode(g, z, p, maps, rng)

    tr = (torch.stack(traces).cpu().numpy() if traces
          else np.zeros((0, 3), np.float32))
    every = pcfg.trace_every
    result = {
        "z_plus": z.detach().cpu().numpy(),
        "p_plus": p.detach().cpu().numpy(),
        "image": final.cpu().numpy(),
        "perceptual_trace": tr[::every, 0],
        "noise_trace": tr[::every, 1],
        "mse_trace": tr[::every, 2],
    }
    if maps is not None:
        result["noises"] = [m.detach().cpu().numpy() for m in maps]
    return result
