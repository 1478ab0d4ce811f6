"""The port's editing sweep (``transeditor_tpu_torch/edit/sweep.py``),
presets and evaluation (``edit/presets.py``, ``edit/evaluate.py``)
against the JAX package, on the CPU in float32.

A tiny generator (16px, 32 wide, one interaction block) holds the same
weights in both packages.  The JAX sweep draws its codes with
``jax.random``; the port takes the same draws through ``draws=``.
Scorers: mean brightness scaled by 100 (a plain callable, so that frame
names carry integers of several digits) and a narrowed random CelebA-HQ
net (no rounding before it).  Tolerances: plus-space codes within 1e-4
of the largest magnitude, images within 5e-4 (13 convolutions sum in
another order; ``test_torch_port_generator.py``), brightness scores
within 0.05 (100x an image mean), classifier scores within 2e-5.  Frame
names embed ``round(score)``: names are compared where JAX's score lies
farther than the score tolerance from a .5 boundary.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.edit import celebahq_classifier as jceleb
from transeditor_tpu.edit import evaluate as jev
from transeditor_tpu.edit import presets as jpre
from transeditor_tpu.edit import sweep as jsw
from transeditor_tpu.utils.sampling import sample_zp as jax_sample_zp

import torch_port_edit_oracle as eo
from transeditor_tpu_torch.edit import celebahq_classifier as tceleb
from transeditor_tpu_torch.edit import evaluate as tev
from transeditor_tpu_torch.edit import presets as tpre
from transeditor_tpu_torch.edit import sweep as tsw
from transeditor_tpu_torch.utils.image import load_png
from torch_port_threads import torch_worker_threads  # noqa: F401

JCFG = JaxConfig(**eo.TINY)
DIM = 16 * eo.TINY["style_dim"]
CODE_REL = 1e-4
IMG_ATOL = 5e-4
BRIGHT_ATOL = 0.05
PROB_ATOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    _, params, g = eo.generator_pair(0)
    return params, g


def bright_jax(img):
    return 100 * jnp.mean(img, axis=(1, 2, 3))


def bright_port(img):
    return 100 * img.mean(dim=(1, 2, 3))


@pytest.fixture(scope="module")
def celebahq():
    with eo.narrow_celebahq():
        sd = eo.celebahq_sd(0)
        jscorer = jceleb.make_celebahq_scorer(
            jceleb.port_celebahq_classifier(sd))
        tscorer = tceleb.make_celebahq_scorer(
            eo.port_module(tceleb.CelebAHQAttributeClassifier, sd),
            device="cpu")
        yield jscorer, tscorer


def jax_draws(seed, n_batches, batch, truncation=1.0):
    """The codes ``collect_scored_latents`` draws for batch i."""
    key = jax.random.PRNGKey(seed)
    return [tuple(np.asarray(a) for a in jax_sample_zp(
        jax.random.fold_in(key, i), batch, 16, eo.TINY["style_dim"],
        truncation)) for i in range(n_batches)]


@pytest.mark.parametrize("n,batch,truncation,seed",
                         [(40, 16, 1.0, 0), (24, 8, 0.7, 3)])
def test_collect_scored_latents_matches_jax(pair, n, batch, truncation,
                                            seed):
    params, g = pair
    kw = dict(n_samples=n, batch=batch, truncation=truncation, seed=seed)
    zw, pw, sw = jsw.collect_scored_latents(JCFG, params, bright_jax, **kw)
    draws = jax_draws(seed, -(-n // batch), batch, truncation)
    done = []
    z, p, s = tsw.collect_scored_latents(g, bright_port, draws=draws,
                                         progress=done.append, **kw)
    assert z.shape == p.shape == (n, DIM) and s.shape == (n,)
    assert z.dtype == p.dtype == s.dtype == np.float32
    assert done == [min(n, batch * (i + 1)) for i in range(len(draws))]
    eo.assert_close(z, zw, CODE_REL, "z+")
    eo.assert_close(p, pw, CODE_REL, "p+")
    np.testing.assert_allclose(s, sw, atol=BRIGHT_ATOL, rtol=0)


def test_collect_with_a_classifier_matches_jax(pair, celebahq):
    params, g = pair
    jscorer, tscorer = celebahq
    zw, pw, sw = jsw.collect_scored_latents(JCFG, params, jscorer,
                                            n_samples=16, batch=8, seed=1)
    z, p, s = tsw.collect_scored_latents(g, tscorer, n_samples=16, batch=8,
                                         draws=jax_draws(1, 2, 8))
    np.testing.assert_allclose(s, sw, atol=PROB_ATOL, rtol=0)
    assert 0.01 < np.median(sw) < 0.99


def test_seeded_draws_repeat(pair):
    _, g = pair
    a = tsw.collect_scored_latents(g, bright_port, n_samples=8, batch=4,
                                   seed=5)
    b = tsw.collect_scored_latents(g, None, n_samples=8, batch=4, seed=5)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(b[2], np.zeros(8, np.float32))


def test_memmap_store_equals_ram(pair):
    _, g = pair
    kw = dict(n_samples=24, batch=8, seed=3)
    z_ram, p_ram, s_ram = tsw.collect_scored_latents(g, bright_port,
                                                     store="ram", **kw)
    z_mm, p_mm, s_mm = tsw.collect_scored_latents(g, bright_port,
                                                  store="memmap", **kw)
    assert isinstance(z_mm, np.memmap) and not isinstance(z_ram, np.memmap)
    np.testing.assert_array_equal(np.asarray(z_mm), z_ram)
    np.testing.assert_array_equal(np.asarray(p_mm), p_ram)
    np.testing.assert_array_equal(s_mm, s_ram)
    big = tsw._latent_store(150_000, 16 * 512, "auto", (1 << 30) // 2, None)
    assert isinstance(big, np.memmap)
    big[149_999, -1] = 1.0
    assert big[149_999, -1] == 1.0
    del big
    assert not isinstance(tsw._latent_store(64, 512, "auto", 1 << 30, None),
                          np.memmap)


def _boundaries(seed):
    rng = np.random.RandomState(seed)
    out = {}
    for k in ("z", "p"):
        b = rng.randn(1, DIM).astype(np.float32)
        out[k] = b / np.linalg.norm(b)
    return out


def _plus_codes(params, seed):
    z, p = jax_draws(seed, 1, 1)[0]
    from transeditor_tpu.models import Generator as JaxGenerator
    zp, pp = JaxGenerator(JCFG).apply(params, jnp.asarray(z), jnp.asarray(p),
                                      method="map_codes")
    return np.asarray(zp)[0], np.asarray(pp)[0]


@pytest.mark.parametrize("scorer", ["bright", "celebahq"])
def test_edit_sample_matches_jax(pair, celebahq, scorer):
    params, g = pair
    jscorer, tscorer = ((bright_jax, bright_port) if scorer == "bright"
                        else celebahq)
    zp, pp = _plus_codes(params, 2)
    bounds = _boundaries(2)
    want = jsw.edit_sample(jsw.make_strip_decoder(JCFG, params, jscorer),
                           zp, pp, bounds, 3.0, 5.0, steps=7)
    got = tsw.edit_sample(tsw.make_strip_decoder(g, tscorer), zp, pp,
                          bounds, 3.0, 5.0, steps=7)
    assert set(got) == {"pz_plus", "p_plus", "z_plus"}
    atol = BRIGHT_ATOL if scorer == "bright" else PROB_ATOL
    for space, w in want.items():
        assert got[space].space == space
        assert got[space].images.shape == (7, 16, 16, 3)
        np.testing.assert_allclose(got[space].images, w.images,
                                   atol=IMG_ATOL, rtol=0, err_msg=space)
        np.testing.assert_allclose(got[space].scores, w.scores, atol=atol,
                                   rtol=0, err_msg=space)
    assert got["pz_plus"].scores[0] != got["pz_plus"].scores[-1]


def _names(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for f in files:
            out[os.path.join(rel, f)] = os.path.join(dirpath, f)
    return out


def _comparable(names, scores):
    """Frame names whose JAX score (by space and frame) is not within
    the score tolerance of a .5 boundary (``round`` may land either side
    there); every other file too."""
    keep = set()
    for name in names:
        space, base = os.path.split(name)
        score = scores.get(os.path.join(space, base.rsplit("_", 1)[0]))
        if score is None or \
                abs(abs(score - np.floor(score)) - 0.5) > BRIGHT_ATOL:
            keep.add(name)
    return keep


def test_save_strips_and_noinversion_sweep_match_jax(pair, tmp_path):
    from transeditor_tpu.models import Generator as JaxGenerator
    params, g = pair
    bounds = _boundaries(4)
    jsw.run_noinversion_sweep(JCFG, params, bright_jax, bounds,
                              str(tmp_path / "jax"), "bright", 2.0, 4.0,
                              n_edit_samples=2, steps=5, seed=6)
    # run_noinversion_sweep draws with PRNGKey(seed) itself, no fold_in
    z, p = (np.asarray(a) for a in jax_sample_zp(
        jax.random.PRNGKey(6), 2, 16, eo.TINY["style_dim"]))
    tsw.run_noinversion_sweep(g, bright_port, bounds, str(tmp_path / "port"),
                              "bright", 2.0, 4.0, n_edit_samples=2, steps=5,
                              seed=6, draws=(z, p))
    want, got = _names(tmp_path / "jax"), _names(tmp_path / "port")
    assert len(got) == len(want) == 1 + 3 * 2 * 6
    # JAX's scores, by space and frame, from its own strips
    scores = {}
    decode = jsw.make_strip_decoder(JCFG, params, bright_jax)
    zp, pp = JaxGenerator(JCFG).apply(params, jnp.asarray(z), jnp.asarray(p),
                                      method="map_codes")
    for i in range(2):
        strips = jsw.edit_sample(decode, np.asarray(zp)[i],
                                 np.asarray(pp)[i], bounds, 2.0, 4.0, 5)
        for space, strip in strips.items():
            for j, s in enumerate(strip.scores):
                scores[os.path.join(space, f"origin_{i}_edit_{j}_bright")] \
                    = float(s)
    assert len(scores) == 3 * 2 * 5
    keep = _comparable(want, scores)
    assert len(keep) > len(want) - 4
    assert keep == _comparable(got, scores)
    for name in keep:
        a, b = load_png(got[name]), load_png(want[name])
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name


def test_train_dual_boundaries_matches_jax(pair):
    params, g = pair
    rng = np.random.RandomState(7)
    z = rng.randn(200, DIM).astype(np.float32)
    p = rng.randn(200, DIM).astype(np.float32)
    s = (z[:, 0] - p[:, 1] + 0.1 * rng.randn(200)).astype(np.float32)
    want = jsw.train_dual_boundaries(z, p, s, chosen_ratio=0.25, seed=1)
    got = tsw.train_dual_boundaries(z, p, s, chosen_ratio=0.25, seed=1,
                                    device="cpu")
    for k in ("z", "p"):
        cos = float(np.sum(got[k] * want[k]))
        assert 1 - cos < 1e-6, (k, cos)


def test_presets_equal_jax():
    assert tpre.SEED_RANGE == jpre.SEED_RANGE
    assert tpre.NOINVERSION == jpre.NOINVERSION
    assert tpre.INVERSION == jpre.INVERSION
    for attr, idx in [("age", None), ("gender", None), ("pose", None),
                      ("Male", 0), ("Wavy_Hair", 3), ("Young", 4),
                      ("nonexistent", None), ("Bald", 8)]:
        for inv in (False, True):
            for seeds in (False, True):
                assert tpre.sweep_preset(attr, idx, inv, seeds) == \
                    jpre.sweep_preset(attr, idx, inv, seeds)


def test_evaluate_equals_jax():
    rng = np.random.default_rng(0)
    change = [rng.standard_normal(7).cumsum().tolist() for _ in range(3)]
    interest = [rng.standard_normal(7).tolist() for _ in range(3)]
    assert tev.direction_deltas(change[0]) == jev.direction_deltas(change[0])
    assert tev.disentanglement_score(change, interest) == \
        jev.disentanglement_score(change, interest)
    assert tev.score_correlation(change, interest) == \
        jev.score_correlation(change, interest)
    a, b = rng.standard_normal((1, 9)), rng.standard_normal((1, 9))
    assert tev.boundary_cosine(a, b) == jev.boundary_cosine(a, b)
    imgs = {"z_plus": rng.standard_normal((5, 4, 4, 3)).astype(np.float32)}
    got = tev.rescore_strips(imgs, {"m": lambda x: torch.as_tensor(x).mean(
        dim=(1, 2, 3))})
    want = jev.rescore_strips(imgs, {"m": lambda x: np.mean(x, (1, 2, 3))})
    np.testing.assert_allclose(got["m"]["z_plus"], want["m"]["z_plus"],
                               rtol=1e-6)

    def embed(x):
        f = torch.as_tensor(x).reshape(len(x), -1)
        return f / f.norm(dim=-1, keepdim=True)

    o, e = imgs["z_plus"][:2], imgs["z_plus"][2:4]
    np.testing.assert_allclose(
        tev.id_preservation(embed, o, e),
        jev.id_preservation(lambda x: embed(x).numpy(), o, e), rtol=1e-6)
