"""Perceptual Path Length (``transeditor_tpu/metrics/ppl.py``).

Protocol: 10k samples in batches of 64; pairs of endpoints lerped at t
(0 for end sampling, U[0, 1) for full) and t + eps (1e-4); decode;
optional center crop (rows 3c:7c, cols 2c:6c with c = H/8); VGG net-lin
LPIPS between the two decodes / eps²; the mean of the distances within
the [1st, 99th] percentiles.  Spaces: 'all' (lerp Z and P), 'z' (P
batch-fixed), 'p' (Z batch-fixed); ``eval_plus`` lerps in Z+ / P+ and
decodes with the mappings bypassed.

The port takes the generator and the LPIPS as modules where the JAX
package takes ``(cfg, params)``.  Endpoints are interpolated in float32
(the JAX package's float32 ``t`` promotes bfloat16 codes), the image is
cast to float32 before the LPIPS.  Draws come from a ``torch.Generator``
seeded ``seed`` on the generator's device; a parity test passes the JAX
package's draws in through ``draws=``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from transeditor_tpu_torch.device import device_of
from transeditor_tpu_torch.utils.sampling import sample_tokens


def center_crop(img: torch.Tensor) -> torch.Tensor:
    """NHWC rows 3c:7c, cols 2c:6c with c = H // 8."""
    c = img.shape[1] // 8
    return img[:, c * 3: c * 7, c * 2: c * 6, :]


def slerp(a: torch.Tensor, b: torch.Tensor, t, axis: int = 1
          ) -> torch.Tensor:
    """Spherical interpolation, normalising over ``axis``: the reference
    normalises over its trailing axis, the 16-token axis of its [B, 512,
    16] layout, which is axis 1 of the port's [B, T, D]."""
    def normalize(x):
        return x * torch.rsqrt((x * x).sum(dim=axis, keepdim=True))
    a = normalize(a)
    b = normalize(b)
    d = (a * b).sum(dim=axis, keepdim=True)
    p = t * torch.arccos(d)
    c = normalize(b - d * a)
    return normalize(a * torch.cos(p) + c * torch.sin(p))


def resize_256(img: torch.Tensor) -> torch.Tensor:
    """NHWC -> 256x256 by ``F.interpolate(bilinear, align_corners=False)``,
    which does not antialias."""
    x = F.interpolate(img.permute(0, 3, 1, 2), size=(256, 256),
                      mode="bilinear", align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1)


def make_ppl_distance_fn(g, lpips, space: str = "all",
                         eval_plus: bool = True, crop: bool = False,
                         eps: float = 1e-4, use_slerp: bool = False
                         ) -> Callable:
    """``(z, p, t) -> [B]`` path-length distances of 2B endpoints ([2B, T,
    D] codes paired as ``x[0::2], x[1::2]``, a scalar ``t``), on the
    generator's device, without gradients: lerp (or slerp) at t and
    t + eps, interleaved restack, mapping bypass under ``eval_plus``,
    center crop, the >256px bilinear downscale, LPIPS / eps²."""

    def interp_pairs(x, t):
        a, b = x[0::2], x[1::2]
        if use_slerp:
            e0 = slerp(a, b, t)
            e1 = slerp(a, b, t + eps)
        else:
            e0 = a + (b - a) * t
            e1 = a + (b - a) * (t + eps)
        return torch.stack([e0, e1], 1).reshape(x.shape)

    def distances(z, p, t) -> torch.Tensor:
        with torch.no_grad():
            if eval_plus:
                z, p = g.map_codes(z, p)
            z, p = z.float(), p.float()
            t = torch.as_tensor(t, dtype=torch.float32, device=z.device)
            lz = interp_pairs(z, t) if space in ("all", "z") else z
            lp = interp_pairs(p, t) if space in ("all", "p") else p
            img = g(lz, lp, map_z=not eval_plus,
                    map_p=not eval_plus).image.float()
            if crop:
                img = center_crop(img)
            if img.shape[1] > 256:
                img = resize_256(img)
            d = lpips(img[0::2], img[1::2])
        return d / (eps * eps)

    return distances


def percentile_filter_mean(distances: np.ndarray) -> float:
    """[1st, 99th]-percentile filtered mean (numpy's 'lower' / 'higher'
    methods)."""
    distances = np.asarray(distances)
    lo = np.percentile(distances, 1, method="lower")
    hi = np.percentile(distances, 99, method="higher")
    kept = distances[(distances >= lo) & (distances <= hi)]
    return float(kept.mean())


def _tensor(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)


def make_ppl_batch_fn(g, lpips, space: str = "all", eval_plus: bool = True,
                      crop: bool = False, eps: float = 1e-4, batch: int = 64,
                      use_slerp: bool = False, sampling: str = "end"
                      ) -> Callable:
    """``(rng, drawn=None) -> [batch]`` distances of one batch: Z and P
    ([2 * batch, T, D], batch-fixed for space 'p' / 'z') and t (0 for
    'end', U[0, 1) for 'full') from the ``torch.Generator`` ``rng``, or
    ``drawn = (z, p, t)`` in their place."""
    distances = make_ppl_distance_fn(g, lpips, space, eval_plus, crop,
                                     eps=eps, use_slerp=use_slerp)
    cfg = g.cfg

    def ppl_batch(rng: torch.Generator, drawn=None) -> torch.Tensor:
        if drawn is not None:
            dev = device_of(g)
            z, p, t = (_tensor(a, dev) for a in drawn)
        else:
            z = sample_tokens(rng, batch * 2, cfg.n_tokens, cfg.style_dim,
                              same=(space == "p"))
            p = sample_tokens(rng, batch * 2, cfg.n_tokens, cfg.param_dim,
                              same=(space == "z"))
            t = (torch.rand((), generator=rng, device=rng.device)
                 if sampling == "full" else 0.0)
        return distances(z, p, t)

    return ppl_batch


def compute_ppl(g, lpips, space: str = "all", eval_plus: bool = True,
                crop: bool = False, n_samples: int = 10_000,
                batch: int = 64, seed: int = 0, use_slerp: bool = False,
                sampling: str = "end",
                progress: Optional[Callable[[int], None]] = None,
                draws: Optional[Sequence[Tuple]] = None) -> float:
    """The percentile-filtered mean path length over ``n_samples`` pairs
    (whole batches are drawn; the surplus of the last is dropped).
    ``draws``: one (z, p, t) a batch in place of the seeded draws."""
    fn = make_ppl_batch_fn(g, lpips, space, eval_plus, crop, batch=batch,
                           use_slerp=use_slerp, sampling=sampling)
    rng = torch.Generator(device=device_of(g)).manual_seed(seed)
    dists = []
    done = 0
    i = 0
    while done < n_samples:
        d = fn(rng, None if draws is None else draws[i])
        dists.append(d.cpu().numpy())
        done += batch
        i += 1
        if progress:
            progress(done)
    distances = np.concatenate(dists)[:n_samples]
    return percentile_filter_mean(distances)
