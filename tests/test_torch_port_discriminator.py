"""The port's discriminator and GAN losses vs the JAX package.

JAX ``init`` weights go through ``discriminator_state_dict_from_jax``
(and ``generator_state_dict_from_jax``) into the port; the same numpy
images and codes go through both.  float32 on the CPU.  Tolerances:
logits and loss values rtol 1e-4 (atol 1e-5); gradients, R1's
grad-of-grad and the path-length penalty's second-order gradient 1e-4
of each tensor's largest magnitude + 1e-8 (as the step tests).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.io.torch_export import (discriminator_state_dict,
                                             export_reference_checkpoint)
from transeditor_tpu.models import Discriminator as JaxDiscriminator
from transeditor_tpu.models import Generator as JaxGenerator
from transeditor_tpu.models.discriminator import \
    minibatch_stddev as jax_minibatch_stddev
from transeditor_tpu.train import losses as jax_losses

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.io.checkpoint import load_reference_discriminator
from transeditor_tpu_torch.io.torch_export import (
    discriminator_state_dict_from_jax, generator_state_dict_from_jax)
from transeditor_tpu_torch.models.discriminator import (Discriminator,
                                                        minibatch_stddev)
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.train import losses

SMALL = dict(size=16, style_dim=32, param_dim=32, max_channels=32, n_trans=1)
TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _disc_pair(size, seed=0):
    kw = {**SMALL, "size": size}
    jd = JaxDiscriminator(JaxConfig(**kw))
    params = jd.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    cfg = ModelConfig(**kw)
    d = Discriminator(cfg, device="cpu")
    d.load_state_dict(discriminator_state_dict_from_jax(_np(params), cfg),
                      strict=True)
    return jd, params, d, cfg


def _images(seed, b, size):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, size, size, 3)).astype(np.float32)


def _assert_grads(got_sd, want_sd, module, what):
    for name, _ in module.named_parameters():
        want = want_sd[name].numpy()
        diff = np.abs(got_sd[name].detach().numpy() - want).max()
        tol = 1e-4 * np.abs(want).max() + 1e-8
        assert diff <= tol, f"{what} {name}: {diff} > {tol}"


def _named_grads(module, grads):
    return {n: g for (n, _), g in zip(module.named_parameters(), grads)}


@pytest.mark.parametrize("size,batch", [(16, 4), (32, 3)])
def test_logits_match_jax(size, batch):
    jd, params, d, _ = _disc_pair(size)
    img = _images(1, batch, size)
    want = np.asarray(jd.apply(params, jnp.asarray(img)))
    with torch.no_grad():
        got = d(torch.from_numpy(img))
    assert tuple(got.shape) == want.shape == (batch, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_reference_keys_and_checkpoint_load(tmp_path):
    _, params, d, cfg = _disc_pair(32)
    ref = discriminator_state_dict(_np(params), JaxConfig(**{**SMALL,
                                                             "size": 32}))
    assert set(d.state_dict()) == set(ref)
    for k, v in d.state_dict().items():
        assert tuple(v.shape) == ref[k].shape, k
    path = tmp_path / "d.pt"
    export_reference_checkpoint(str(path), JaxConfig(**{**SMALL,
                                                        "size": 32}),
                                d=params)
    fresh = Discriminator(cfg, device="cpu", seed=5)
    fresh.load_state_dict(load_reference_discriminator(str(path), cfg),
                          strict=True)
    for k, v in d.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v)
    with pytest.raises(ValueError):
        load_reference_discriminator(str(path), ModelConfig(size=64))


@pytest.mark.parametrize("b", [3, 4, 6, 8])
def test_minibatch_stddev_matches_jax(b):
    x = np.random.RandomState(b).randn(b, 4, 4, 6).astype(np.float32)
    want = np.asarray(jax_minibatch_stddev(jnp.asarray(x)))
    got = minibatch_stddev(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_d_losses_and_r1_match_jax():
    """d_logistic_loss and R1 values, their gradients in the D
    parameters (R1's a grad-of-grad), and g_nonsaturating_loss."""
    jd, params, d, cfg = _disc_pair(16)
    real, fake = _images(2, 4, 16), _images(3, 4, 16)

    def jax_d_loss(p):
        return jax_losses.d_logistic_loss(
            jd.apply({"params": p}, jnp.asarray(real)),
            jd.apply({"params": p}, jnp.asarray(fake)))

    def jax_r1(p):
        return jax_losses.r1_penalty(
            lambda p_, img: jd.apply({"params": p_}, img), p,
            jnp.asarray(real))

    params_d = d.parameters
    for name, jfn, port in (
            ("d_logistic", jax_d_loss,
             lambda: losses.d_logistic_loss(d(torch.from_numpy(real)),
                                            d(torch.from_numpy(fake)))),
            ("r1", jax_r1, lambda: losses.r1_penalty(
                d, torch.from_numpy(real)))):
        want_v, want_g = jax.jit(jax.value_and_grad(jfn))(params["params"])
        got_v = port()
        np.testing.assert_allclose(float(got_v.detach()), float(want_v),
                                   err_msg=name,
                                   **TOL)
        got_g = torch.autograd.grad(got_v, list(params_d()),
                                    allow_unused=True, materialize_grads=True)
        _assert_grads(_named_grads(d, got_g),
                      discriminator_state_dict_from_jax(_np(want_g), cfg),
                      d, name)

    pred = np.random.RandomState(4).randn(4, 1).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.g_nonsaturating_loss(torch.from_numpy(pred))),
        float(jax_losses.g_nonsaturating_loss(jnp.asarray(pred))), **TOL)


def test_path_length_penalty_second_order_matches_jax():
    """The penalty, its path lengths and its gradient in the G
    parameters: a derivative of a gradient through every up-conv's
    fused_blur4 backward."""
    jcfg, cfg = JaxConfig(**SMALL), ModelConfig(**SMALL)
    jg = JaxGenerator(jcfg)
    z0 = jnp.zeros((1, 16, 32))
    params = jg.init({"params": jax.random.PRNGKey(0)}, z0, z0)["params"]
    g = Generator(cfg, device="cpu")
    g.load_state_dict(generator_state_dict_from_jax(_np(params), cfg),
                      strict=True)
    rng = np.random.RandomState(7)
    z, p = (rng.randn(2, 16, 32).astype(np.float32) for _ in range(2))
    noise = (rng.randn(2, 16, 16, 3) / 16).astype(np.float32)
    mean_pl = np.float32(0.5)

    def jax_penalty(pg):
        v = {"params": pg}
        zp, pp = jg.apply(v, jnp.asarray(z), jnp.asarray(p),
                          method="map_codes")
        tokens = jg.apply(v, zp, pp, method="interact_codes")
        latent = jg.apply(v, tokens, method="style_latents_from")
        pen, mean, lengths = jax_losses.path_length_penalty(
            lambda lat: jg.apply(v, pp, lat, method="synthesize"), latent,
            jnp.asarray(noise), jnp.asarray(mean_pl))
        return pen, (mean, lengths)

    (want_pen, (want_mean, want_len)), want_g = jax.jit(jax.value_and_grad(
        jax_penalty, has_aux=True))(params)

    zp, pp = g.map_codes(torch.from_numpy(z), torch.from_numpy(p))
    latent = g.style_latents_from(g.interact_codes(zp, pp))
    pen, mean, lengths = losses.path_length_penalty(
        lambda lat: g.synthesize(pp, lat), latent, torch.from_numpy(noise),
        torch.tensor(mean_pl))
    np.testing.assert_allclose(float(pen.detach()), float(want_pen), **TOL)
    np.testing.assert_allclose(float(mean), float(want_mean), **TOL)
    np.testing.assert_allclose(lengths.detach().numpy(),
                               np.asarray(want_len), **TOL)
    assert not mean.requires_grad
    got_g = torch.autograd.grad(pen, list(g.parameters()), allow_unused=True,
                                materialize_grads=True)
    _assert_grads(_named_grads(g, got_g),
                  generator_state_dict_from_jax(_np(want_g), cfg), g,
                  "path length")


def test_path_noise_scale():
    n = losses.path_noise(torch.Generator().manual_seed(0), (64, 32, 32, 3))
    assert tuple(n.shape) == (64, 32, 32, 3)
    assert abs(float(n.std()) * 32 - 1) < 0.02
