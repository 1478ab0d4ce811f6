"""The port's FID statistics, Fréchet distance, PRDC and real-stats reader
(``transeditor_tpu_torch/metrics/{fid,prdc,evaluator}.py``) against the
JAX package's, on the CPU.

FID is float64 numpy and scipy in both packages: held to 1e-10.  PRDC
counts are integers and both packages divide them in float64, so the
four values are held EQUAL, over k in {1, 3, 5} and row chunks that do
and do not divide N.
"""

import pickle

import numpy as np
import pytest

from transeditor_tpu.metrics import evaluator as jev
from transeditor_tpu.metrics import fid as jfid
from transeditor_tpu.metrics.prdc import compute_prdc as jax_prdc

from transeditor_tpu_torch.metrics import evaluator as tev
from transeditor_tpu_torch.metrics import fid as tfid
from transeditor_tpu_torch.metrics.prdc import compute_prdc
from torch_port_threads import torch_worker_threads  # noqa: F401

FID_TOL = 1e-10


def _feats(seed, n=120, d=16, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * (1 + 0.1 * seed) + shift).astype(
        np.float32)


def test_stats_and_frechet_distance_match_jax():
    a, b = _feats(0), _feats(1, shift=0.3)
    ma, ca = tfid.compute_stats(a)
    wa, wc = jfid.compute_stats(a)
    np.testing.assert_allclose(ma, wa, rtol=0, atol=FID_TOL)
    np.testing.assert_allclose(ca, wc, rtol=0, atol=FID_TOL)
    mb, cb = tfid.compute_stats(b)
    got = tfid.frechet_distance(ma, ca, mb, cb)
    want = jfid.frechet_distance(ma, ca, mb, cb)
    assert got > 0 and abs(got - want) <= FID_TOL * max(1.0, abs(want))
    assert abs(tfid.fid_from_features(a, mb, cb)
               - jfid.fid_from_features(a, mb, cb)) <= FID_TOL * want


def test_singular_covariances_take_the_eps_offset_as_jax():
    # rank-deficient: fewer samples than dimensions
    a, b = _feats(2, n=6), _feats(3, n=6, shift=0.1)
    ma, ca = tfid.compute_stats(a)
    mb, cb = tfid.compute_stats(b)
    got = tfid.frechet_distance(ma, ca, mb, cb)
    want = jfid.frechet_distance(ma, ca, mb, cb)
    assert np.isfinite(got) and abs(got - want) <= 1e-8 * max(1.0, abs(want))


def test_a_materially_imaginary_sqrtm_raises_as_jax():
    rng = np.random.default_rng(4)
    m = rng.standard_normal((4, 4))
    c1 = np.diag([1.0, 1.0, 1.0, 1.0])
    c2 = -np.eye(4) * 4 + 0.01 * (m + m.T)        # negative definite
    for fn in (jfid.frechet_distance, tfid.frechet_distance):
        with pytest.raises(ValueError, match="Imaginary component"):
            fn(np.zeros(4), c1, np.zeros(4), c2)


@pytest.mark.parametrize("row_chunk", [64, 100, 300, 2048],
                         ids=["chunk64-divides", "chunk100-ragged",
                              "chunk300-ragged", "chunk-whole"])
@pytest.mark.parametrize("nearest_k", [1, 3, 5])
def test_prdc_equals_jax(nearest_k, row_chunk):
    real = _feats(10, n=320, d=24)
    fake = _feats(11, n=256, d=24, shift=0.15)
    want = jax_prdc(real, fake, nearest_k, row_chunk)
    got = compute_prdc(real, fake, nearest_k, row_chunk, device="cpu")
    assert got == want
    assert 0 < got["precision"] < 1 and 0 < got["coverage"] < 1


def test_prdc_takes_tensors_and_identical_sets_cover_everything():
    import torch
    x = _feats(12, n=96, d=8)
    got = compute_prdc(torch.from_numpy(x), x, 3, 32, device="cpu")
    assert got["precision"] == got["recall"] == got["coverage"] == 1.0
    assert got == jax_prdc(x, x, 3, 32)


@pytest.mark.parametrize("keys", [("mean", "cov"), ("mu", "sigma")])
def test_real_stats_from_npz(tmp_path, keys):
    m, c = _feats(20, n=1, d=5)[0], np.eye(5) * 2
    path = tmp_path / "stats.npz"
    np.savez(path, **{keys[0]: m, keys[1]: c})
    for fn in (tev.load_real_stats, jev.load_real_stats):
        gm, gc = fn(str(path))
        np.testing.assert_array_equal(gm, m)
        np.testing.assert_array_equal(gc, c)


def test_real_stats_from_the_reference_pickle(tmp_path):
    m, c = np.arange(3.0), np.eye(3)
    path = tmp_path / "inception_ffhq.pkl"
    with open(path, "wb") as f:
        pickle.dump({"mu": m, "sigma": c, "n": 3}, f)
    got, want = tev.load_real_stats(str(path)), jev.load_real_stats(str(path))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bare_npy_and_npz_without_keys_raise_as_jax(tmp_path):
    npy = tmp_path / "stats.npy"
    np.save(npy, np.zeros(3))
    errors = []
    for fn in (jev.load_real_stats, tev.load_real_stats):
        with pytest.raises(Exception) as e:
            fn(str(npy))
        errors.append(type(e.value))
    assert errors[0] is errors[1]
    bad = tmp_path / "bad.npz"
    np.savez(bad, other=np.zeros(2))
    for fn in (jev.load_real_stats, tev.load_real_stats):
        with pytest.raises(KeyError):
            fn(str(bad))
