"""The port's LPIPS diversity and checkpoint report
(``transeditor_tpu_torch/metrics/evaluator.py``: ``make_pairwise_lpips_mean``,
``evaluate_lpips_diversity``, ``evaluate_checkpoint``) against the JAX
package's, on the CPU in float32, with the JAX package's draws.

A 32px generator (the smallest size AlexNet's pools take) holds the same
weights in both packages; the AlexNet and VGG LPIPS are random richzhang
checkpoints.  Diversity is held to ``DIV_RTOL``, PPL (eps = 1e-4) to 2e-2
as in ``test_torch_port_ppl.py``; ``evaluate_checkpoint``'s FID statistics
go through the recorder of ``test_torch_port_evaluator.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transeditor_tpu.metrics import evaluator as jev
from transeditor_tpu.metrics import inception as ji

import torch_port_metrics_oracle as mo
from transeditor_tpu_torch.metrics import evaluator as tev
from transeditor_tpu_torch.metrics import inception as ti
from torch_port_threads import torch_worker_threads  # noqa: F401

TINY = dict(size=32, style_dim=32, param_dim=32, max_channels=32, n_trans=1)
DIV_RTOL = 1e-5
PPL_RTOL = 2e-2
STATS_REL = 1e-5


@pytest.fixture(scope="module")
def nets():
    jcfg, params, g = mo.generator_pair(2, **TINY)
    return (jcfg, params, g, mo.lpips_pair("alex", 3),
            mo.lpips_pair("vgg", 4))


@pytest.mark.parametrize("n_images,pair_chunk", [(6, 5), (6, 15), (5, 130)],
                         ids=["chunks-of-5", "one-chunk", "chunk-clipped"])
def test_pairwise_mean_matches_jax(nets, n_images, pair_chunk):
    (jlp, lpips) = nets[3]
    img = np.random.RandomState(n_images).uniform(
        -1, 1, (n_images, 32, 32, 3)).astype(np.float32)
    want = float(jev.make_pairwise_lpips_mean(n_images, pair_chunk)(
        jlp, jnp.asarray(img)))
    with torch.no_grad():
        got = float(tev.make_pairwise_lpips_mean(lpips, n_images,
                                                 pair_chunk)(
            torch.from_numpy(img)))
    assert got == pytest.approx(want, rel=DIV_RTOL)


def test_pair_chunk_must_divide_the_pairs_as_jax(nets):
    lpips = nets[3][1]
    for make in (lambda: jev.make_pairwise_lpips_mean(6, 4),
                 lambda: tev.make_pairwise_lpips_mean(lpips, 6, 4)):
        with pytest.raises(AssertionError, match="must divide n_pairs 15"):
            make()


def test_diversity_matches_jax_in_its_three_regimes(nets):
    jcfg, params, g, (jlp, lpips), _ = nets
    kw = dict(n_images=6, n_batches=2, pair_chunk=5, seed=4)
    want = jev.evaluate_lpips_diversity(jcfg, params, jlp, **kw)
    got = tev.evaluate_lpips_diversity(
        g, lpips, **kw, draws=mo.diversity_draws(2, 6, 16, 32, 32, seed=4))
    assert list(got) == ["all", "fix_z", "fix_p"] and set(want) == set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=DIV_RTOL), k
    assert len(set(got.values())) == 3


def test_seeded_regimes_fix_the_named_space(nets):
    """Without draws: 'fix_z' decodes one P for the whole group, 'fix_p'
    one Z (the reference's labels)."""
    g, lpips = nets[2], nets[3][1]
    seen = []
    forward = g.forward
    g.forward = lambda z, p, **kw: seen.append((z, p)) or forward(z, p, **kw)
    try:
        tev.evaluate_lpips_diversity(g, lpips, n_images=3, n_batches=1,
                                     pair_chunk=3)
    finally:
        del g.forward
    (z0, p0), (z1, p1), (z2, p2) = seen

    def fixed(x):
        return bool((x == x[:1]).all())
    assert [fixed(z0), fixed(p0)] == [False, False]
    assert [fixed(z1), fixed(p1)] == [False, True]
    assert [fixed(z2), fixed(p2)] == [True, False]


def test_evaluate_checkpoint_matches_jax(nets, monkeypatch):
    jcfg, params, g, (jlp, lpips), (jvp, ppl_lpips) = nets
    sd = mo.fid_inception_sd(5)
    seen = {}
    for tag, mod in (("jax", jev), ("port", tev)):
        def rec(m, c, rm, rc, tag=tag):
            seen[tag] = (m, c)
            return 1.5
        monkeypatch.setattr(mod, "frechet_distance", rec)
    real = (np.zeros(2048), np.eye(2048))
    kw = dict(do_fid=True, do_lpips=True, do_ppl=True, fid_samples=3,
              lpips_batches=1, ppl_samples=3, batch=2)
    want = jev.evaluate_checkpoint(
        jcfg, params, inception_params=ji.port_fid_inception_weights(sd),
        real_stats=real, lpips_params=jlp, ppl_lpips_params=jvp, **kw)
    draws = {"fid": mo.fid_draws(2, 2, 16, 32, 32),
             "lpips": mo.diversity_draws(1, 40, 16, 32, 32),
             "ppl": {s: mo.ppl_draws(2, 2, 16, 32, 32, s)
                     for s in ("all", "p", "z")}}
    got = tev.evaluate_checkpoint(
        g, inception=ti.load_fid_inception(mo.torch_sd(sd)),
        real_stats=real, lpips=lpips, ppl_lpips=ppl_lpips, draws=draws, **kw)
    assert got.fid == want.fid == 1.5
    for a, b in zip(seen["port"], seen["jax"]):
        assert mo.rel_err(a, b) <= STATS_REL
    assert set(got.lpips) == set(want.lpips)
    for k in want.lpips:
        assert got.lpips[k] == pytest.approx(want.lpips[k], rel=DIV_RTOL)
    assert list(got.ppl) == list(want.ppl) == ["all", "p", "z"]
    for k in want.ppl:
        assert got.ppl[k] == pytest.approx(want.ppl[k], rel=PPL_RTOL)
