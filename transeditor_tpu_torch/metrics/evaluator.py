"""Checkpoint evaluator: FID, LPIPS diversity, PPL and PRDC
(``transeditor_tpu/metrics/evaluator.py``).

Per checkpoint: FID of 69k (FFHQ) / 29k (CelebA-HQ) samples against
cached real statistics; LPIPS diversity over 1,000 groups of 40 images
in three regimes; PPL over the spaces all, p and z in plus space with
the crop; PRDC of VGG16-fc7 features, generated against real.

The port takes modules (the generator, ``InceptionV3Features``, the two
LPIPS nets, ``VGG16Fc7``) where the JAX package takes parameter trees.
Each batch is sample -> decode -> float32 -> features on the
generator's device without gradients; features stream into
preallocated host stores.  Codes come from a ``torch.Generator`` seeded
``seed`` on the generator's device; a parity test passes the JAX
package's draws in through ``draws=``.

``mesh=`` (``parallel/mesh.py``, one process per card) splits each batch
over the mesh's data axis, as the JAX package's
``_shard_batch_constraint`` shards it over chips: every rank draws the
whole batch's codes from the one seeded generator, decodes and scores
its contiguous rows, and the features (or LPIPS distances) are
all-gathered in row order.  The result on every rank is the one-process
result, whatever the number of ranks.  The batch (and the LPIPS group
and its pairs) must split evenly over the data axis.
"""

from __future__ import annotations

import dataclasses
import pickle
import zipfile
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from transeditor_tpu_torch.device import device_of
from transeditor_tpu_torch.metrics.fid import compute_stats, frechet_distance
from transeditor_tpu_torch.metrics.ppl import compute_ppl
from transeditor_tpu_torch.metrics.prdc import compute_prdc
from transeditor_tpu_torch.utils.sampling import sample_tokens


def load_real_stats(path: str):
    """Cached real-data statistics ('mean'/'cov' or 'mu'/'sigma') from the
    reference's pickle (``inception_ffhq.pkl``) or an ``.npz`` with the
    same keys.  A bare ``.npy`` (one array, not two named ones) takes the
    pickle branch, which raises for it."""
    try:
        z = np.load(path)
    except (ValueError, OSError, TypeError, zipfile.BadZipFile,
            pickle.UnpicklingError):
        z = None            # not npz / npy: the pickle format
    if z is not None and not isinstance(z, np.lib.npyio.NpzFile):
        z = None
    if z is not None:
        with z:
            # an npz without either spelling is an error in the caller's
            # file: its KeyError propagates
            mean = z["mean"] if "mean" in z.files else z["mu"]
            cov = z["cov"] if "cov" in z.files else z["sigma"]
            return np.asarray(mean), np.asarray(cov)
    with open(path, "rb") as f:
        stats = pickle.load(f)
    mean = stats.get("mean", stats.get("mu"))
    cov = stats.get("cov", stats.get("sigma"))
    return np.asarray(mean), np.asarray(cov)


def _codes(g, rng: torch.Generator, batch: int, truncation: float = 1.0,
           drawn=None, z_same: bool = False, p_same: bool = False):
    """(Z, P) [batch, T, D] on the generator's device: ``drawn`` when
    given, else drawn from ``rng`` (Z first)."""
    if drawn is not None:
        dev = device_of(g)
        return tuple(torch.tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev) for a in drawn)
    cfg = g.cfg
    z = sample_tokens(rng, batch, cfg.n_tokens, cfg.style_dim, truncation,
                      same=z_same)
    p = sample_tokens(rng, batch, cfg.n_tokens, cfg.param_dim, truncation,
                      same=p_same)
    return z, p


def _rng(g, seed: int) -> torch.Generator:
    return torch.Generator(device=device_of(g)).manual_seed(seed)


def _decode(g, z, p) -> torch.Tensor:
    return g(z, p).image.float()


def _split(mesh) -> bool:
    """Whether a batch is split over ``mesh``'s data axis."""
    return mesh is not None and mesh.data_active


def _my_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's contiguous rows of a batch (all of it without a
    data axis to split over)."""
    if not _split(mesh):
        return t
    n = mesh.n_data
    if t.shape[0] % n:
        raise ValueError(f"a batch of {t.shape[0]} does not split over "
                         f"{n} data ranks")
    per = t.shape[0] // n
    return t[mesh.data_index * per:(mesh.data_index + 1) * per]


def _all_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's ``t`` (equal shapes) stacked in rank order along
    dim 0: the inverse of ``_my_rows``."""
    if not _split(mesh):
        return t
    t = t.contiguous()
    out = t.new_empty((mesh.n_data * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=mesh.data_group)
    return out


def _features(net: Callable, g, z, p, mesh) -> np.ndarray:
    """``net`` of the decodes of (z, p), this rank's rows of them, and
    gathered: [batch, features] on the host."""
    with torch.no_grad():
        fb = net(_decode(g, _my_rows(z, mesh), _my_rows(p, mesh)))
        return _all_rows(fb, mesh).cpu().numpy()


def evaluate_fid(g, inception: Callable, real_mean, real_cov,
                 n_samples: int = 69_000, batch: int = 64,
                 truncation: float = 1.0, seed: int = 0,
                 draws: Optional[Sequence] = None, mesh=None) -> float:
    """FID of ``n_samples`` decodes against (real_mean, real_cov).
    Features stream into a preallocated store; the surplus rows of the
    last batch are dropped.  ``draws``: one (Z, P) a batch.  ``mesh``:
    split each batch over its data axis (module docstring)."""
    rng = _rng(g, seed)
    feats = None
    done = 0
    i = 0
    while done < n_samples:
        z, p = _codes(g, rng, batch, truncation,
                      None if draws is None else draws[i])
        fb = _features(inception, g, z, p, mesh)
        if feats is None:
            feats = np.empty((n_samples, fb.shape[1]), np.float32)
        m = min(batch, n_samples - done)
        feats[done:done + m] = fb[:m]
        done += m
        i += 1
    mean, cov = compute_stats(feats)
    return frechet_distance(mean, cov, real_mean, real_cov)


def _uint8_features(net: Callable, imgs: np.ndarray, dev) -> np.ndarray:
    """uint8 NHWC uploaded as is, normalised to [-1, 1] on the device."""
    x = torch.from_numpy(np.ascontiguousarray(imgs, np.uint8)).to(dev)
    with torch.no_grad():
        return net(x.float() / 127.5 - 1.0).cpu().numpy()


def real_stats_from_source(source, inception, resolution: int,
                           n_samples: int = 50_000, batch: int = 64):
    """FID statistics of the first ``n_samples`` images of ``source`` (the
    calc_inception.py analogue), on the net's device."""
    dev = device_of(inception)
    n = min(n_samples, len(source))
    feats = None
    for start in range(0, n, batch):
        imgs = np.stack([source.get(i, resolution)
                         for i in range(start, min(start + batch, n))])
        fb = _uint8_features(inception, imgs, dev)
        if feats is None:
            feats = np.empty((n, fb.shape[1]), np.float32)
        feats[start:start + len(fb)] = fb
    return compute_stats(feats)


def make_pairwise_lpips_mean(lpips, n_images: int,
                             pair_chunk: int = 130, mesh=None) -> Callable:
    """``images [N, H, W, C] -> scalar``: the mean LPIPS over all
    unordered pairs (i < j) of one group, evaluated as batched LPIPS calls
    over chunks of ``pair_chunk`` gathered index pairs.  ``mesh``: each
    data rank scores its contiguous share of the pairs, in chunks of at
    most ``pair_chunk``, and the distances are gathered in pair order."""
    iu, ju = np.triu_indices(n_images, k=1)
    n_pairs = len(iu)
    # a chunk larger than the pair list cannot be sliced: one chunk
    pair_chunk = min(pair_chunk, n_pairs)
    assert n_pairs % pair_chunk == 0, (
        f"pair_chunk {pair_chunk} must divide n_pairs {n_pairs}")
    iu_t, ju_t = torch.from_numpy(iu), torch.from_numpy(ju)

    def pairwise_mean(img: torch.Tensor) -> torch.Tensor:
        ii = _my_rows(iu_t.to(img.device), mesh)
        jj = _my_rows(ju_t.to(img.device), mesh)
        step = min(pair_chunk, len(ii))
        dists = []
        for s in range(0, len(ii), step):
            dists.append(lpips(img[ii[s:s + step]], img[jj[s:s + step]]))
        return _all_rows(torch.cat(dists), mesh).mean()

    return pairwise_mean


# regime -> (z_same, p_same).  The labels are the reference's: its
# "fix_z" accumulates the P-fixed draws and "fix_p" the Z-fixed ones.
REGIMES = {"all": (False, False), "fix_z": (False, True),
           "fix_p": (True, False)}


def evaluate_lpips_diversity(g, lpips, n_images: int = 40,
                             n_batches: int = 1000, truncation: float = 1.0,
                             seed: int = 0, pair_chunk: int = 130,
                             draws: Optional[Sequence] = None, mesh=None
                             ) -> Dict[str, float]:
    """Three-regime mean pairwise LPIPS: each of ``n_batches`` rounds
    decodes one group of ``n_images`` per regime (``REGIMES``, in that
    order).  ``draws``: a round's three (Z, P) pairs, in that order.
    ``mesh``: each data rank decodes its rows of a group and scores its
    share of the pairs."""
    pairwise_mean = make_pairwise_lpips_mean(lpips, n_images, pair_chunk,
                                             mesh)
    rng = _rng(g, seed)
    sums = {k: 0.0 for k in REGIMES}
    for b in range(n_batches):
        for r, (name, (z_same, p_same)) in enumerate(REGIMES.items()):
            z, p = _codes(g, rng, n_images, truncation,
                          None if draws is None else draws[b][r],
                          z_same=z_same, p_same=p_same)
            with torch.no_grad():
                img = _all_rows(_decode(g, _my_rows(z, mesh),
                                        _my_rows(p, mesh)), mesh)
                sums[name] += float(pairwise_mean(img))
    return {k: v / n_batches for k, v in sums.items()}


def evaluate_prdc(g, vgg, real_source, n_samples: int = 50_000,
                  batch: int = 64, nearest_k: int = 3, seed: int = 0,
                  draws: Optional[Sequence] = None,
                  mesh=None) -> Dict[str, float]:
    """PRDC of VGG16-fc7 features (``zoo/backbones.py::VGG16Fc7``) of n
    decodes against n real images, both at the native size, k-NN on the
    generator's device.  ``mesh``: each data rank scores its rows of
    each batch, generated and real (a last batch of real images is
    padded to the batch by repeating its last image, and the padding's
    features dropped); every rank runs the k-NN on all features."""
    dev = device_of(g)
    rng = _rng(g, seed)
    n = min(n_samples, len(real_source))
    fake = real = None
    done = 0
    i = 0
    while done < n:
        m = min(batch, n - done)
        z, p = _codes(g, rng, batch, drawn=None if draws is None
                      else draws[i])
        fb = _features(vgg, g, z, p, mesh)
        idx = list(range(done, done + m))
        if _split(mesh):
            idx = _my_rows(torch.tensor(idx + [idx[-1]] * (batch - m)),
                           mesh).tolist()
        imgs = np.stack([real_source.get(j, g.cfg.size) for j in idx])
        rb = _uint8_features(vgg, imgs, dev)
        if _split(mesh):
            rb = _all_rows(torch.from_numpy(rb).to(dev), mesh).cpu().numpy()
        if fake is None:
            fake = np.empty((n, fb.shape[1]), np.float32)
            real = np.empty((n, rb.shape[1]), np.float32)
        fake[done:done + m] = fb[:m]
        real[done:done + m] = rb[:m]
        done += m
        i += 1
    return compute_prdc(real, fake, nearest_k, device=dev)


@dataclasses.dataclass
class EvalReport:
    fid: Optional[float] = None
    lpips: Optional[Dict[str, float]] = None
    ppl: Optional[Dict[str, float]] = None


PPL_SPACES = ("all", "p", "z")


def evaluate_checkpoint(g, *, inception=None, real_stats=None, lpips=None,
                        ppl_lpips=None, do_fid=False, do_lpips=False,
                        do_ppl=False, fid_samples=69_000, lpips_batches=1000,
                        ppl_samples=10_000, batch=64, ppl_slerp=False,
                        draws: Optional[Dict] = None,
                        ppl_g=None) -> EvalReport:
    """The reference's two perceptual nets: AlexNet LPIPS (``lpips``) for
    diversity, net-lin VGG (``ppl_lpips``) for PPL.  ``draws``: optional
    {"fid": [...], "lpips": [...], "ppl": {space: [...]}} in place of the
    seeded draws of each protocol.  ``ppl_g``: the generator PPL decodes
    through (``cli.evaluate`` passes a float32 copy of ``g``); default
    ``g``."""
    draws = draws or {}
    report = EvalReport()
    if do_fid:
        assert inception is not None and real_stats is not None
        report.fid = evaluate_fid(g, inception, *real_stats,
                                  n_samples=fid_samples, batch=batch,
                                  draws=draws.get("fid"))
    if do_lpips:
        assert lpips is not None
        report.lpips = evaluate_lpips_diversity(
            g, lpips, n_batches=lpips_batches, draws=draws.get("lpips"))
    if do_ppl:
        assert ppl_lpips is not None
        ppl_draws = draws.get("ppl", {})
        report.ppl = {
            space: compute_ppl(g if ppl_g is None else ppl_g, ppl_lpips,
                               space=space, eval_plus=True, crop=True,
                               use_slerp=ppl_slerp, n_samples=ppl_samples,
                               batch=batch, draws=ppl_draws.get(space))
            for space in PPL_SPACES}
    return report
