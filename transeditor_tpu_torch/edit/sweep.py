"""Editing sweeps: score 150k samples, train boundaries, edit strips
(``transeditor_tpu/edit/sweep.py``).

Reference drivers: ``our_interfaceGAN/edit_all_noinversion_ffhq.py``
(and the inversion / CelebA-HQ variants): generate ``num_sample``
(150k) random (Z+, P+) pairs, decode from plus space, score each image
with an attribute classifier (:100-149), train linear-SVM boundaries in
the flattened Z+ and P+ spaces (:153-168), then edit 8 samples along
p+/z+/pz+ directions over 61 steps per per-attribute distance configs,
re-scoring each edited image (:179-286).

The port takes a ``Generator`` module where the JAX package takes
``(cfg, gen_params)``, and a scorer on the generator's device.  Each
scored batch is sample -> map -> decode -> float32 -> score on the
device, without gradients, and its codes and scores stream into the host
stores; an edit strip decodes as one batch.  Codes are drawn from a
``torch.Generator`` seeded with ``seed`` on the generator's device; a
parity test passes the JAX package's draws in through ``draws=``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from transeditor_tpu_torch.device import device_of
from transeditor_tpu_torch.edit.boundary import (linear_interpolate,
                                                 train_boundary)
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.utils.image import make_grid, save_png, to_uint8
from transeditor_tpu_torch.utils.sampling import sample_zp


def _latent_store(n: int, dim: int, store: str, mem_budget_bytes: int,
                  memmap_dir: Optional[str]) -> np.ndarray:
    """[n, dim] float32 accumulator: RAM if it fits the budget, else an
    unlinked-on-close tempfile memmap.  At the reference protocol scale
    (150k x 8192 x 2 trees = 9.8 GB) the list-concatenate pattern OOMs
    production hosts, so the sweep streams batches straight into this
    (reference edit_all_noinversion_ffhq.py:100-149 has the same flaw)."""
    nbytes = n * dim * 4
    if store == "ram" or (store == "auto" and nbytes <= mem_budget_bytes):
        return np.empty((n, dim), np.float32)
    f = tempfile.NamedTemporaryFile(
        prefix="sweep_latents_", suffix=".f32", dir=memmap_dir)
    mm = np.memmap(f, dtype=np.float32, mode="w+", shape=(n, dim))
    mm._tmpfile = f  # keep the fd alive; file unlinks when mm dies
    return mm


def _codes(g: Generator, rng: torch.Generator, batch: int,
           truncation: float, drawn=None):
    """(Z, P) [batch, T, D] on the generator's device: ``drawn`` (numpy
    or tensors) when given, else drawn from ``rng``."""
    if drawn is not None:
        dev = device_of(g)
        return tuple(torch.tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev) for a in drawn)
    cfg = g.cfg
    return sample_zp(rng, batch, cfg.n_tokens, cfg.style_dim, truncation)


def collect_scored_latents(
    g: Generator, scorer: Optional[Callable],
    n_samples: int = 150_000, batch: int = 64, truncation: float = 1.0,
    seed: int = 0, progress: Optional[Callable[[int], None]] = None,
    store: str = "auto", mem_budget_bytes: int = 1 << 30,
    memmap_dir: Optional[str] = None,
    draws: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (z_plus_flat [N, 16*512], p_plus_flat, scores [N]).

    ``store``: 'ram' | 'memmap' | 'auto' (memmap once the two latent
    trees would exceed ``mem_budget_bytes``).  Batches stream directly
    into the preallocated store, so peak host RAM stays at
    O(batch + budget) even for the 150k-sample protocol.  ``draws``: one
    (Z, P) pair of [batch, T, D] codes a batch in place of the seeded
    draws."""
    cfg = g.cfg
    rng = torch.Generator(device=device_of(g)).manual_seed(seed)
    score = _scorer_or_zeros(scorer)

    dim = cfg.n_tokens * cfg.style_dim
    # the budget covers BOTH latent trees
    z = _latent_store(n_samples, dim, store, mem_budget_bytes // 2,
                      memmap_dir)
    p = _latent_store(n_samples, dim, store, mem_budget_bytes // 2,
                      memmap_dir)
    s = np.empty((n_samples,), np.float32)

    done = 0
    i = 0
    while done < n_samples:
        zc, pc = _codes(g, rng, batch, truncation,
                        None if draws is None else draws[i])
        with torch.no_grad():
            zp, pp = g.map_codes(zc, pc)
            img = g(zp, pp, map_z=False, map_p=False).image
            sb = score(img.float())
        n = min(batch, n_samples - done)
        z[done:done + n] = zp[:n].float().reshape(n, dim).cpu().numpy()
        p[done:done + n] = pp[:n].float().reshape(n, dim).cpu().numpy()
        s[done:done + n] = sb[:n].float().cpu().numpy()
        done += n
        i += 1
        if progress:
            progress(done)
    return z, p, s


def train_dual_boundaries(z_flat, p_flat, scores, chosen_ratio=0.02,
                          seed=0, device=None) -> Dict[str, np.ndarray]:
    """Both editing directions (the reference trains Z+ and P+ SVMs,
    :153-168), fitted on ``device`` (default cuda)."""
    return {
        "z": train_boundary(z_flat, scores, chosen_ratio, seed=seed,
                            device=device),
        "p": train_boundary(p_flat, scores, chosen_ratio, seed=seed,
                            device=device),
    }


@dataclasses.dataclass
class EditStrip:
    images: np.ndarray    # [steps, H, W, 3] float in [-1,1]
    scores: np.ndarray    # [steps]
    space: str            # 'pz_plus' | 'p_plus' | 'z_plus'


def _scorer_or_zeros(scorer):
    """``scorer``, or zero scores when there is none (as the JAX
    package's ``_scorer_parts``)."""
    if scorer is None:
        return lambda img: torch.zeros(img.shape[0], device=img.device)
    return scorer


def make_strip_decoder(g: Generator, scorer: Optional[Callable] = None):
    """decode(z_strip, p_strip) -> (float32 images, scores), tensors on
    the generator's device: a [steps, 16, 512] x2 plus-space strip decoded
    as one batch, without gradients."""
    score = _scorer_or_zeros(scorer)
    dev = device_of(g)

    def decode(z_strip, p_strip):
        z_strip = torch.as_tensor(z_strip, dtype=torch.float32, device=dev)
        p_strip = torch.as_tensor(p_strip, dtype=torch.float32, device=dev)
        with torch.no_grad():
            img = g(z_strip, p_strip, map_z=False,
                    map_p=False).image.float()
            return img, score(img)

    return decode


def edit_sample(decode, z_plus, p_plus, boundaries, style_distance,
                content_distance, steps: int = 61) -> Dict[str, EditStrip]:
    """Edit ONE sample along pz+/p+/z+ (reference :209-270).

    z_plus/p_plus: [16, 512] plus-space codes (sampled or inverted).
    """
    z_plus, p_plus = np.asarray(z_plus), np.asarray(p_plus)
    t, d = z_plus.shape
    z_flat = z_plus.reshape(1, -1)
    p_flat = p_plus.reshape(1, -1)

    z_moved = linear_interpolate(z_flat, boundaries["z"], -style_distance,
                                 style_distance, steps).reshape(steps, t, d)
    p_moved = linear_interpolate(p_flat, boundaries["p"], -content_distance,
                                 content_distance, steps).reshape(steps, t, d)
    z_fixed = np.broadcast_to(z_plus[None], (steps, t, d))
    p_fixed = np.broadcast_to(p_plus[None], (steps, t, d))

    out = {}
    for space, (zz, pp) in {
        "pz_plus": (z_moved, p_moved),
        "p_plus": (z_fixed, p_moved),
        "z_plus": (z_moved, p_fixed),
    }.items():
        img, s = decode(np.ascontiguousarray(zz), np.ascontiguousarray(pp))
        out[space] = EditStrip(img.cpu().numpy(), s.float().cpu().numpy(),
                               space)
    return out


def save_strips(strips: Dict[str, EditStrip], out_dir: str,
                sample_idx: int, attribute: str):
    """PNG per edited frame, predicted score embedded in the filename
    (the reference's assertion mechanism, :249), plus one strip grid."""
    for space, strip in strips.items():
        d = os.path.join(out_dir, space)
        os.makedirs(d, exist_ok=True)
        imgs = to_uint8(strip.images)
        for j in range(imgs.shape[0]):
            save_png(os.path.join(
                d, f"origin_{sample_idx}_edit_{j}_{attribute}_"
                   f"{round(float(strip.scores[j]))}.png"), imgs[j])
        save_png(os.path.join(d, f"strip_{sample_idx}.png"),
                 make_grid(strip.images, nrow=imgs.shape[0], pad=0))


def run_noinversion_sweep(
    g: Generator, scorer, boundaries, out_dir: str,
    attribute: str, style_distance: float, content_distance: float,
    n_edit_samples: int = 8, steps: int = 61, seed: int = 0,
    truncation: float = 1.0,
    draws: Optional[Tuple[np.ndarray, np.ndarray]] = None,
):
    """The per-(seed, distance-config) edit phase (:179-286): draw
    ``n_edit_samples`` (Z, P) pairs (or take ``draws``), save their
    decodes as ``origin_image/sample_gen.png``, and save each one's
    strips."""
    rng = torch.Generator(device=device_of(g)).manual_seed(seed)
    z, p = _codes(g, rng, n_edit_samples, truncation, draws)
    with torch.no_grad():
        zp, pp = g.map_codes(z, p)
        origin = g(z, p).image.float().cpu().numpy()
    os.makedirs(os.path.join(out_dir, "origin_image"), exist_ok=True)
    save_png(os.path.join(out_dir, "origin_image", "sample_gen.png"),
             make_grid(origin, nrow=1, pad=0))

    decode = make_strip_decoder(g, scorer)
    zp, pp = zp.float().cpu().numpy(), pp.float().cpu().numpy()
    for i in range(n_edit_samples):
        strips = edit_sample(decode, zp[i], pp[i], boundaries,
                             style_distance, content_distance, steps)
        save_strips(strips, out_dir, i, attribute)
