"""Encoder-inversion trainer, the pSp coach (``transeditor_tpu/train/coach.py``;
reference ``pSp/training/coach_new.py``).

Real images go through the encoder and the frozen decoder (plus-space
decode); the weighted loss is

    id_lambda * ArcFace ID + l2_lambda * MSE + lpips_lambda * LPIPS_alex
    + the face-crop variants + w_norm_lambda * w-norm

(coach.py:142-178), minimised by Ranger (RAdam + gradient
centralisation, no Lookahead).  Every ``fake_every`` steps a fake step
samples (Z, P), maps and decodes them without gradients, re-encodes the
image and takes the latent MSE in float32.  ``eval_step`` runs the
encoder on its running BatchNorm statistics.

A plain per-step loop; the JAX package's are jitted.  Only the encoder's
parameters take gradients: the decoder, the LPIPS network and ArcFace
are frozen inside every step.  The loss gradient reaches the encoder
through the decoder's inputs, so on the card a train step runs each
up-conv's ``fused_blur4`` forward, adjoint and recompute launch (6 + 6 +
6 at 256px); an eval step runs the 6 forward launches, and a fake step
only those of its no-grad decode: unlike the JAX fake step, which calls
the full forward and leaves XLA to drop the decode whose image it never
reads, the encoder's output is not decoded here.

Randomness: the encoder's initial weights come from ``init_fn``'s seed;
the fake step's codes from a ``torch.Generator`` on the decoder's device,
or ``draws=`` (a parity test feeds the JAX package's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.device import device_of
from transeditor_tpu_torch.invert.projector import _frozen, _tensor
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.models.irse import init_weights
from transeditor_tpu_torch.models.psp import GradualStyleEncoder, PSPModel
from transeditor_tpu_torch.train.ranger import ranger_simple
from transeditor_tpu_torch.utils.sampling import sample_zp
from transeditor_tpu_torch.zoo.backbones import adaptive_avg_pool_2d
from transeditor_tpu_torch.zoo.lpips import LPIPS


@dataclasses.dataclass(frozen=True)
class CoachConfig:
    """Loss weights and schedule (psp_training_options.py defaults)."""

    max_steps: int = 500_000
    batch_size: int = 8
    learning_rate: float = 1e-4
    optim_name: str = "ranger"
    lpips_lambda: float = 0.8
    id_lambda: float = 0.1
    l2_lambda: float = 1.0
    lpips_lambda_crop: float = 0.0
    l2_lambda_crop: float = 0.0
    w_norm_lambda: float = 0.0
    use_fake_lambda: float = 0.0
    fake_every: int = 10          # psp_training_options.py:86
    val_interval: int = 2500
    save_interval: int = 10_000
    start_from_latent_avg: bool = True
    from_plus_space: bool = True


@dataclasses.dataclass
class CoachState:
    """The encoder (parameters and BatchNorm statistics), its optimizer,
    the count of train steps and the best validation loss.  The steps
    update it in place and return it."""

    encoder: GradualStyleEncoder
    optimizer: torch.optim.Optimizer
    step: int = 0
    best_val_loss: float = math.inf


def face_crop(img: torch.Tensor) -> torch.Tensor:
    """The ArcFace alignment crop of NHWC images (id_loss.py:17-21: rows
    35:223, cols 32:220).  Raises below 224px, as the JAX package does,
    instead of slicing to an empty map."""
    if img.shape[1] < 224 or img.shape[2] < 224:
        raise ValueError(
            f"ArcFace face_crop needs >=224px images, got "
            f"{img.shape[1]}x{img.shape[2]}: the ID loss is defined on "
            f"256px outputs (reference id_loss.py:17-21)")
    return img[:, 35:223, 32:220, :]


def resize_112(img: torch.Tensor) -> torch.Tensor:
    """``AdaptiveAvgPool2d((112, 112))``: the reference's face_pool
    (id_loss.py:14) pools the 188x188 crop, it does not resize."""
    return adaptive_avg_pool_2d(img, (112, 112))


class IdLoss:
    """The ID loss of an ArcFace embedder (id_loss.py:8-45): (mean of
    1 - cos(inv, real), mean of cos - 1), both on the face crops pooled
    to 112px.  The embedder runs in eval mode; ``real``'s embedding takes
    no gradient."""

    def __init__(self, arcface: torch.nn.Module):
        self.arcface = arcface.eval()

    def __call__(self, inversed: torch.Tensor, real: torch.Tensor):
        f_inv = self.arcface(resize_112(face_crop(inversed)))
        with torch.no_grad():
            f_real = self.arcface(resize_112(face_crop(real)))
        sim = (f_inv * f_real).sum(dim=-1)
        return (1.0 - sim).mean(), (sim - 1.0).mean()


def make_arcface_id_loss(arcface: torch.nn.Module) -> IdLoss:
    """``IdLoss`` of ``arcface`` (an ``ArcFaceBackbone``)."""
    return IdLoss(arcface)


def make_coach(cfg: ModelConfig, ccfg: CoachConfig, decoder: Generator,
               lpips: LPIPS, id_loss: Optional[IdLoss] = None,
               latent_avg: Optional[Sequence] = None):
    """Build (init_fn, train_step, eval_step, fake_step) around the frozen
    ``decoder`` and ``lpips`` (net "alex"), on the decoder's device.

    * ``init_fn(encoder=None, seed=0) -> CoachState``: a default
      ``GradualStyleEncoder`` with torch's initialisers drawn from
      ``seed`` (or ``encoder``, moved to the device), and its optimizer;
    * ``train_step(state, real) -> (state, logs, inversions)``;
    * ``eval_step(state, real) -> (logs, inversions)``;
    * ``fake_step(state, draws=None, rng=None) -> (state, loss)``:
      ``draws`` is the (z, p) pair of codes, else drawn from ``rng``.

    ``real``: [B, H, W, 3] images in [-1, 1] on the device.  ``logs``
    holds detached float32 scalars.  ``id_loss`` is optional (no ID term
    without it), as is ``latent_avg`` (z [T, D], p [T, D]).
    """
    dev = device_of(decoder)
    frozen = [decoder, lpips]
    if id_loss is not None:
        frozen.append(id_loss.arcface)
    avg = (None if latent_avg is None else
           tuple(_tensor(a, dev) for a in latent_avg))
    use_avg = ccfg.start_from_latent_avg and avg is not None

    def init_fn(encoder: Optional[GradualStyleEncoder] = None,
                seed: int = 0) -> CoachState:
        if encoder is None:
            encoder = init_weights(GradualStyleEncoder(),
                                   torch.Generator().manual_seed(seed))
        encoder = encoder.to(dev).train()
        if ccfg.optim_name == "ranger":
            opt = ranger_simple(encoder.parameters(), ccfg.learning_rate)
        else:
            opt = torch.optim.Adam(encoder.parameters(), ccfg.learning_rate)
        return CoachState(encoder=encoder, optimizer=opt)

    def encode(state: CoachState, images: torch.Tensor, train: bool):
        state.encoder.train(train)
        psp = PSPModel(state.encoder, decoder, avg, use_avg)
        return psp, psp.encode(images)

    def forward(state, images, train):
        psp, (z, p) = encode(state, images, train)
        img = psp.decode(z, p, from_plus_space=ccfg.from_plus_space)
        return img, z, p

    def losses(inv, real, z, p):
        inv, real = inv.float(), real.float()
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        logs = {}
        if ccfg.id_lambda > 0 and id_loss is not None:
            loss_id, improve = id_loss(inv, real)
            logs["loss_id"], logs["id_improve"] = loss_id, improve
            loss = loss + ccfg.id_lambda * loss_id
        if ccfg.l2_lambda > 0:
            l2 = ((inv - real) ** 2).mean()
            logs["loss_l2"] = l2
            loss = loss + ccfg.l2_lambda * l2
        if ccfg.lpips_lambda > 0:
            lp = lpips(inv, real).mean()
            logs["loss_lpips"] = lp
            loss = loss + ccfg.lpips_lambda * lp
        if ccfg.lpips_lambda_crop > 0:
            lp = lpips(face_crop(inv), face_crop(real)).mean()
            logs["loss_lpips_crop"] = lp
            loss = loss + ccfg.lpips_lambda_crop * lp
        if ccfg.l2_lambda_crop > 0:
            l2 = ((face_crop(inv) - face_crop(real)) ** 2).mean()
            logs["loss_l2_crop"] = l2
            loss = loss + ccfg.l2_lambda_crop * l2
        if ccfg.w_norm_lambda > 0 and avg is not None:
            wn = (torch.linalg.vector_norm(z - avg[0][None], dim=-1).mean()
                  + torch.linalg.vector_norm(p - avg[1][None], dim=-1).mean())
            logs["loss_w_norm"] = wn
            loss = loss + ccfg.w_norm_lambda * wn
        logs["loss"] = loss
        return loss, logs

    def _update(state: CoachState, loss: torch.Tensor) -> None:
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()

    def train_step(state: CoachState, real: torch.Tensor):
        with _frozen(*frozen):
            inv, z, p = forward(state, real, train=True)
            loss, logs = losses(inv, real, z, p)
            _update(state, loss)
        state.step += 1
        return state, {k: v.detach() for k, v in logs.items()}, inv.detach()

    def fake_step(state: CoachState, draws: Optional[Sequence] = None,
                  rng: Optional[torch.Generator] = None):
        if draws is None:
            draws = sample_zp(rng, ccfg.batch_size, cfg.n_tokens,
                              cfg.style_dim)
        z, p = (_tensor(d, dev) for d in draws)
        with _frozen(*frozen):
            with torch.no_grad():
                z_plus, p_plus = decoder.map_codes(z, p)
                fake = decoder(z_plus, p_plus, map_z=False,
                               map_p=False).image.float()
            _, (zc, pc) = encode(state, fake, train=True)
            f32 = torch.float32
            # the latent MSE in float32 whatever the compute dtype
            loss = ccfg.use_fake_lambda * (
                ((z_plus.to(f32) - zc.to(f32)) ** 2).mean()
                + ((p_plus.to(f32) - pc.to(f32)) ** 2).mean())
            _update(state, loss)
        return state, loss.detach()

    @torch.no_grad()
    def eval_step(state: CoachState, real: torch.Tensor):
        inv, z, p = forward(state, real, train=False)
        _, logs = losses(inv, real, z, p)
        return logs, inv

    return init_fn, train_step, eval_step, fake_step
