"""The port's projector (``transeditor_tpu_torch/invert/projector.py``)
against the JAX package's, on the CPU in float32.

The config is ``tests/test_invert_and_ppl.py``'s (16px, 32 wide, one
interaction block).  JAX ``Generator.init`` weights go through the
port's weight bridge.  The VGG LPIPS is a torchvision-layout state dict
that both sides load, from one of three draws (``DRAWS``): the JAX
package's LPIPS initialisers (convs N(0, 0.1), biases 0, heads 1, which
that test and both CLIs' random LPIPS use) seeded 0 or 1, and He-scaled
convs with N(0, 0.1) biases and heads.  The randomness JAX draws inside
``project`` is replicated here with its own key sequence
(``split(key, 3)`` -> stats, noise maps, per-step latent noise
``fold_in(k_opt, step)``) and handed to the port as ``noises=`` /
``latent_noise=``; ``estimate_latent_stats`` is fed JAX's chunk draws
(``fold_in(key, i)``).

What can agree, and to what:

* Each step, from the same state: the objective's parts, its gradients
  in z+, p+ and the noise maps, and the Adam update, on every draw and in
  both noise modes, within 1e-5 of each tensor's largest magnitude
  (``test_each_step_matches_jax_from_its_state``).  The image entering
  the LPIPS is pinned to JAX's decode on both sides there (its value is
  JAX's image exactly, its gradient flows through each side's own
  generator), because the two frameworks' images differ by rounding
  (about 2e-6 of their largest magnitude) and the VGG's ReLUs are kinks:
  an input within rounding of 0 takes either slope.  Unpinned, the
  gradients agree within 1e-4 (the LPIPS gradient is steep: the
  rounding-level image change alone moves it by up to 2e-5) unless a
  VGG ReLU input changes sign between the two images, which the test
  counts: on the seed-1 draw one does at step 0 without latent noise
  (the gradients then differ by 3e-3) and at step 1 with it (2e-3).
* Five free-running steps.  Adam divides each component by its own RMS,
  so a component whose gradient is near 0 moves by up to the lr either
  way, and a kink met on one side only sends the trajectories apart.
  On the seed-0 draw z+, p+, the noise maps, the image and the traces
  agree within 1e-4 of their largest magnitudes
  (``test_project_matches_jax``).  On the seed-1 draw without latent
  noise, the step-0 kink above puts JAX's result 2e-2 away; there JAX's
  z+, p+ and image are, within 3e-4, the port's own result from a start
  changed by one float32 rounding
  (``test_free_running_gap_is_a_rounding_restart``, which holds every
  other draw to the same), so the gap is the port's own sensitivity to
  rounding.  Restarts that meet no kink land up to 1.4e-4 from JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.invert import projector as jp

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.invert import projector as tp
from transeditor_tpu_torch.ops import fused_blur
from torch_port_projector_oracle import (MODEL, PROJ_REL, STATS_REL,
                                         STEPS, _models, _project_pair,
                                         _rel, _stats, _target)
from torch_port_threads import torch_worker_threads  # noqa: F401


@pytest.fixture(scope="module")
def plain():
    return _models(False)


def test_lr_schedule_matches_jax():
    for total in (5, 1000):
        for step in sorted({0, 1, total // 20, total // 4, total // 2,
                            3 * total // 4, total - 1}):
            # JAX evaluates in float32: 1e-8 is about one ulp of lr 0.1
            want = float(jp.lr_schedule(step, total, 0.1))
            np.testing.assert_allclose(tp.lr_schedule(step, total, 0.1),
                                       want, rtol=1e-6, atol=1e-8)
    assert tp.lr_schedule(0, 10_000, 0.1) == 0.0


def _noise_maps(seed, batch=2):
    rng = np.random.RandomState(seed)
    shapes = tp.make_noise_shapes(ModelConfig(size=32), batch)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def test_noise_regularize_matches_jax():
    maps = _noise_maps(0)
    # correlated maps, so the rolled products are far from 0
    maps = [m + np.roll(m, 1, axis=1) + np.roll(m, 1, axis=2) for m in maps]
    want = float(jp.noise_regularize([jnp.asarray(m) for m in maps]))
    got = float(tp.noise_regularize([torch.from_numpy(m) for m in maps]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ones = tp.noise_regularize([torch.ones(1, 16, 16, 1)])
    np.testing.assert_allclose(float(ones), 4.0, rtol=1e-6)


def test_noise_normalize_matches_jax_with_the_unbiased_std():
    maps = [3.0 * m + 1.0 for m in _noise_maps(1)]
    want = jp.noise_normalize([jnp.asarray(m) for m in maps])
    got = tp.noise_normalize([torch.from_numpy(m) for m in maps])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    # the 4x4 map over a batch of 2: 32 values, ddof=1
    assert maps[0].shape == (2, 4, 4, 1)
    np.testing.assert_allclose(got[0].numpy().std(ddof=1), 1.0, rtol=1e-5)
    assert abs(got[0].numpy().std(ddof=0) - np.sqrt(31 / 32)) < 1e-5


@pytest.mark.parametrize("size", [16, 256])
def test_make_noise_shapes_matches_jax(size):
    assert tp.make_noise_shapes(ModelConfig(size=size), 3) == \
        jp.make_noise_shapes(JaxConfig(size=size), 3)
    assert len(tp.make_noise_shapes(ModelConfig(size=size), 1)) == \
        ModelConfig(size=size).num_layers


def test_estimate_latent_stats_matches_jax_on_its_draws(plain):
    jcfg, params, g, _, _ = plain
    (zm, zs, pm), draws = _stats(jcfg, params)
    got = tp.estimate_latent_stats(g, draws=draws)
    assert tuple(got[1].shape) == (MODEL["style_dim"],)
    for name, a, b in zip(("z_mean", "z_std", "p_mean"), got, (zm, zs, pm)):
        _rel(a.numpy(), b, STATS_REL, name)


def test_estimate_latent_stats_draws_from_its_seed(plain):
    g = plain[2]
    a = tp.estimate_latent_stats(g, seed=4, n_samples=200, chunk=100)
    b = tp.estimate_latent_stats(g, seed=4, n_samples=200, chunk=100)
    c = tp.estimate_latent_stats(g, seed=5, n_samples=200, chunk=100)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert bool((a[1] > 0).all())


# ------------------------------------------------------------- project


@pytest.fixture(scope="module")
def projected(plain):
    return {False: _project_pair(plain, False),
            True: _project_pair(_models(True), True)}


@pytest.mark.parametrize("optimize_noise", [False, True])
def test_project_matches_jax(projected, optimize_noise):
    got, want = projected[optimize_noise]
    keys = {"z_plus", "p_plus", "image", "perceptual_trace", "noise_trace",
            "mse_trace"} | ({"noises"} if optimize_noise else set())
    assert set(got) == set(want) == keys
    for k in keys - {"noises", "noise_trace"}:
        _rel(got[k], want[k], PROJ_REL, k)
    assert got["perceptual_trace"].shape == (STEPS,)
    if optimize_noise:
        _rel(got["noise_trace"], want["noise_trace"], PROJ_REL, "noise_trace")
        assert len(got["noises"]) == len(want["noises"]) == 5
        for i, (a, b) in enumerate(zip(got["noises"], want["noises"])):
            _rel(a, b, PROJ_REL, f"noise map {i}")
    else:
        assert not got["noise_trace"].any() and not want["noise_trace"].any()
    # the optimisation moved the latents away from the mean
    assert float(np.abs(got["z_plus"][0] - got["z_plus"][1]).max()) > 1e-3


def test_project_noise_maps_reach_the_image(projected):
    """With noise injection on and the noise weights non-zero, the image
    depends on the optimised maps; the traces show the regulariser."""
    got, _ = projected[True]
    assert float(got["noise_trace"].max()) > 0
    n = got["noises"][1]
    np.testing.assert_allclose(n.mean(), 0.0, atol=1e-5)
    np.testing.assert_allclose(n.std(ddof=1), 1.0, rtol=1e-5)


def test_five_steps_amplify_a_rounding_level_change(plain):
    """Why 5-step parity cannot be held much tighter than 1e-4: the
    port's own result from a start scaled by 1 + 2**-20 (about the
    frameworks' gradient differences) moves by more than 10x that."""
    jcfg, params, g, _, lp = plain
    target = _target(jcfg, params)
    (zm, zs, pm), _ = _stats(jcfg, params)
    pcfg = tp.ProjectorConfig(steps=STEPS)
    out = []
    for scale in (1.0, 1.0 + 2.0 ** -20):
        stats = tuple(torch.from_numpy(np.array(s)) for s in (zm, zs, pm))
        stats = (stats[0] * scale, stats[1], stats[2] * scale)
        out.append(tp.project(g, lp, target, pcfg, stats=stats,
                              device="cpu"))
    moved = max(float(np.abs(out[1][k] - out[0][k]).max()
                      / np.abs(out[0][k]).max()) for k in ("z_plus", "p_plus"))
    assert moved > 10 * 2.0 ** -20, moved


# ------------------------------------------------- each step, other draws


def test_project_freezes_the_networks_and_runs_the_blur_by_role(
        plain, monkeypatch):
    """Only the optimised tensors take gradients (the networks' flags are
    restored after), and each step calls ``fused_blur4`` once per up-conv
    in each role: forward, adjoint (grad of x) and recompute (grad of the
    demodulation).  On the CPU these are its plain version; on the card
    the same calls are the kernel's launches."""
    jcfg, params, g, _, lp = plain
    roles = []
    real = fused_blur._blur

    def counting(x, taps, pad, scale, bias, act, role):
        roles.append(role)
        return real(x, taps, pad, scale, bias, act, role)

    monkeypatch.setattr(fused_blur, "_blur", counting)
    before = [p.requires_grad for p in g.parameters()]
    target = _target(jcfg, params)
    stats = tp.estimate_latent_stats(g, n_samples=100, chunk=100)
    roles.clear()
    tp.project(g, lp, target, tp.ProjectorConfig(steps=2), stats=stats,
               device="cpu")
    ups = g.cfg.log_size - 2
    # two steps, then one forward for the final decode
    assert {r: roles.count(r) for r in set(roles)} == {
        "forward": 3 * ups, "adjoint": 2 * ups, "recompute": 2 * ups}
    assert [p.requires_grad for p in g.parameters()] == before
    assert all(p.grad is None for p in g.parameters())
    assert all(p.grad is None for p in lp.parameters())


def test_project_runs_on_the_card_unless_the_cpu_is_asked_for(plain,
                                                              monkeypatch):
    g, lp = plain[2], plain[4]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.project(g, lp, np.zeros((1, 16, 16, 3), np.float32))
