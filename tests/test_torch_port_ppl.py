"""The port's PPL (``transeditor_tpu_torch/metrics/ppl.py``) against the JAX
package's, on the CPU in float32.

A 32px generator (one interaction block, 32 wide) holds the same weights
in both packages (the port's seeded init read by the JAX porter), and a
random richzhang VGG LPIPS the same heads and backbone.  PPL divides an
LPIPS distance by eps², so at the protocol's eps = 1e-4 a rounding
difference of 1e-7 in the images moves a distance by ~1e-3 relative: the
distances are held at eps = 1e-2 to ``COARSE_RTOL`` (measured on this
grid: 9.7e-5 at worst, the same at 2 and 8 threads), where pairing,
crop, slerp axis, mapping bypass and scaling show and rounding does not,
and at 1e-4 to ``PROTOCOL_RTOL`` (measured: 1.1e-2), the tolerance the
JAX package itself is held to against the reference.
The endpoints are the JAX package's own draws for each space.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transeditor_tpu.metrics import ppl as jp

import torch_port_metrics_oracle as mo
from transeditor_tpu_torch.metrics import ppl as tp
from torch_port_threads import torch_worker_threads  # noqa: F401

TINY = dict(size=32, style_dim=32, param_dim=32, max_channels=32, n_trans=1)
COARSE_RTOL = 2e-4
PROTOCOL_RTOL = 2e-2


@pytest.fixture(scope="module")
def nets():
    jcfg, params, g = mo.generator_pair(0, **TINY)
    lpp, lpips = mo.lpips_pair("vgg", 0)
    return jcfg, params, g, lpp, lpips


def _draw(space, batch=2, seed=0, sampling="end"):
    return mo.ppl_draws(1, batch, 16, 32, 32, space, sampling, seed)[0]


def test_center_crop_and_slerp_match_jax():
    x = np.random.RandomState(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    got = tp.center_crop(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jp.center_crop(x)))
    assert got.shape == (2, 16, 16, 3)
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((3, 16, 8)).astype(np.float32)
            for _ in range(2))
    for t in (0.0, 0.3, 1e-4):
        want = np.asarray(jp.slerp(jnp.asarray(a), jnp.asarray(b),
                                   jnp.float32(t)))
        got = tp.slerp(torch.from_numpy(a), torch.from_numpy(b),
                       torch.tensor(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # normalised over the token axis (1): unit norm along it
    assert np.allclose((got ** 2).sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("use_slerp", [False, True], ids=["lerp", "slerp"])
@pytest.mark.parametrize("crop", [False, True], ids=["full", "crop"])
@pytest.mark.parametrize("eval_plus", [True, False], ids=["plus", "mapped"])
@pytest.mark.parametrize("space", ["all", "z", "p"])
def test_distances_match_jax(nets, space, eval_plus, crop, use_slerp):
    jcfg, params, g, lpp, lpips = nets
    z, p, t = _draw(space)
    for eps, rtol in ((1e-2, COARSE_RTOL), (1e-4, PROTOCOL_RTOL)):
        want = np.asarray(jp.make_ppl_distance_fn(
            jcfg, space, eval_plus, crop, eps=eps, use_slerp=use_slerp)(
                params, lpp, jnp.asarray(z), jnp.asarray(p), jnp.asarray(t)))
        got = tp.make_ppl_distance_fn(g, lpips, space, eval_plus, crop,
                                      eps=eps, use_slerp=use_slerp)(
            torch.from_numpy(z), torch.from_numpy(p), torch.from_numpy(t))
        assert got.shape == (2,) and bool((got > 0).all())
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol)


def test_full_sampling_t_and_a_batch_of_draws(nets):
    """A batch function call with JAX's (z, p, t ~ U[0, 1)) draws."""
    jcfg, params, g, lpp, lpips = nets
    z, p, t = _draw("all", sampling="full", seed=3)
    assert 0 < float(t) < 1
    want = np.asarray(jp.make_ppl_distance_fn(jcfg, "all", True, True,
                                              eps=1e-2)(
        params, lpp, jnp.asarray(z), jnp.asarray(p), jnp.asarray(t)))
    got = tp.make_ppl_batch_fn(g, lpips, "all", True, True, eps=1e-2,
                               batch=2, sampling="full")(None, (z, p, t))
    np.testing.assert_allclose(got.numpy(), want, rtol=COARSE_RTOL)


def test_seeded_batches_sample_the_spaces_shapes(nets):
    """Without draws: space 'z' fixes P across the batch, 'p' fixes Z."""
    *_, g, _, lpips = nets
    seen = {}

    def spy(z, p, t):
        seen["z"], seen["p"], seen["t"] = z, p, t
        return torch.zeros(z.shape[0] // 2)

    orig = tp.make_ppl_distance_fn
    tp.make_ppl_distance_fn = lambda *a, **k: spy
    try:
        for space, fixed in (("z", "p"), ("p", "z")):
            fn = tp.make_ppl_batch_fn(g, lpips, space, batch=3)
            fn(torch.Generator().manual_seed(0))
            assert seen["z"].shape == seen["p"].shape == (6, 16, 32)
            assert bool((seen[fixed] == seen[fixed][:1]).all())
            other = "z" if fixed == "p" else "p"
            assert not bool((seen[other] == seen[other][:1]).all())
            assert seen["t"] == 0.0
    finally:
        tp.make_ppl_distance_fn = orig


def test_percentile_filter_mean_is_exact():
    rng = np.random.default_rng(5)
    for n in (7, 100, 1001):
        d = rng.exponential(3.0, n).astype(np.float32)
        assert tp.percentile_filter_mean(d) == jp.percentile_filter_mean(d)


def test_compute_ppl_with_jax_draws(nets):
    jcfg, params, g, lpp, lpips = nets
    batch, n = 3, 5                        # 2 batches, the surplus dropped
    key_draws = mo.ppl_draws(2, batch, 16, 32, 32, "p")
    want = jp.compute_ppl(jcfg, params, lpp, space="p", eval_plus=True,
                          crop=True, n_samples=n, batch=batch)
    seen = []
    got = tp.compute_ppl(g, lpips, space="p", eval_plus=True, crop=True,
                         n_samples=n, batch=batch, draws=key_draws,
                         progress=seen.append)
    assert seen == [3, 6]
    np.testing.assert_allclose(got, want, rtol=PROTOCOL_RTOL)


def test_downscale_path_above_256px():
    """A 512px generator: the image goes through the >256px bilinear
    downscale (no antialias) before the LPIPS, in one call."""
    kw = dict(size=512, style_dim=16, param_dim=16, max_channels=8,
              n_trans=1)
    jcfg, params, g = mo.generator_pair(1, **kw)
    lpp, lpips = mo.lpips_pair("vgg", 1)
    z, p, t = mo.ppl_draws(1, 1, 16, 16, 16, "all")[0]
    fn = jax.jit(jp.make_ppl_distance_fn(jcfg, "all", True, False, 1e-2))
    want = np.asarray(fn(params, lpp, jnp.asarray(z), jnp.asarray(p),
                         jnp.asarray(t)))
    seen = []
    resize = tp.resize_256
    tp.resize_256 = lambda img: seen.append(img.shape) or resize(img)
    try:
        got = tp.make_ppl_distance_fn(g, lpips, "all", True, False, 1e-2)(
            torch.from_numpy(z), torch.from_numpy(p), torch.from_numpy(t))
    finally:
        tp.resize_256 = resize
    assert seen == [(2, 512, 512, 3)]
    np.testing.assert_allclose(got.numpy(), want, rtol=COARSE_RTOL)


def test_resize_256_matches_jax_image_resize():
    x = np.random.RandomState(6).uniform(-1, 1, (1, 512, 512, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 256, 256, 3),
                                       "bilinear", antialias=False))
    got = tp.resize_256(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
