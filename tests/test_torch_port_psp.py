"""The port's pSp encoder and wrapper (``transeditor_tpu_torch/models/psp.py``,
``io/zoo_port.py``) against the JAX package's, on the CPU in float32.

The encoder is the reduced one of ``torch_port_encoder_oracle`` (IR-SE-50
trunk, 3 style heads, 16 spatial heads, ``HEAD`` channels).  A random
pSp-layout state dict reaches JAX through the JAX package's
``io/zoo_port.py`` pieces and the port by two routes: the reference
route (``load_gradual_style_encoder`` of a checkpoint with ``encoder.``
keys and the [D, T] latent averages, loaded with ``strict=True``) and
the JAX route (``gradual_style_encoder_state_dict_from_jax`` of the JAX
variables).  (z, p) agree within 1e-5 of their largest magnitude on
three seeds, in eval mode and in train mode (with the BatchNorm running
statistics).  The default-size encoder is held in
``test_torch_port_encode_cli.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.models import Generator as JaxGenerator
from transeditor_tpu.models import psp as jp
from transeditor_tpu.utils.sampling import sample_zp as jax_sample_zp

import torch_port_encoder_oracle as orc
from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.io import torch_export as te
from transeditor_tpu_torch.io.zoo_port import load_gradual_style_encoder
from transeditor_tpu_torch.models import psp as tp
from transeditor_tpu_torch.models.generator import Generator
from torch_port_threads import torch_worker_threads  # noqa: F401

REL = 1e-5
DECODER = dict(size=64, style_dim=orc.HEAD, param_dim=orc.HEAD,
               max_channels=32, n_trans=1)


@functools.lru_cache(maxsize=None)
def _jax_encode(train):
    """The reduced JAX encoder's jitted apply; it is traced at its first
    call, which ``_call_jax`` makes with the narrow heads in place."""
    with orc.reduced_jax_encoder() as enc:
        module = enc(train=train)
    if train:
        return jax.jit(lambda v, x: module.apply(v, x,
                                                 mutable=["batch_stats"]))
    return jax.jit(module.apply)


def _call_jax(train, variables, x):
    with orc.reduced_jax_encoder():
        return _jax_encode(train)(variables, jnp.asarray(x))


@functools.lru_cache(maxsize=2)
def _case(seed):
    sd = orc.reduced_sd(seed)
    rng = np.random.default_rng(50 + seed)
    avg = [rng.standard_normal((orc.HEAD, 16), np.float32) for _ in range(2)]
    ckpt = {"state_dict": {f"encoder.{k}": torch.from_numpy(np.array(v))
                           for k, v in sd.items()},
            "z_plus_latent_avg": torch.from_numpy(avg[0]),
            "p_plus_latent_avg": torch.from_numpy(avg[1])}
    return sd, orc.jax_encoder_vars(sd), ckpt, avg


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("seed", orc.SEEDS)
def test_reduced_encoder_matches_jax_by_both_routes(seed, train):
    sd, variables, ckpt, avg = _case(seed)
    x = orc.images(seed)
    out = _call_jax(train, variables, x)
    (jz_, jp_), new = (out if train else (out, None))
    port_ref, got_avg = load_gradual_style_encoder(ckpt)
    assert (port_ref.style_count, port_ref.coarse_ind, port_ref.middle_ind,
            port_ref.spatial_count) == (3, 1, 2, 16)
    for a, want in zip(got_avg, avg):
        np.testing.assert_array_equal(a.numpy(), want.T)
    port_jax = tp.GradualStyleEncoder(head_channels=orc.HEAD, **orc.REDUCED)
    port_jax.load_state_dict(te.gradual_style_encoder_state_dict_from_jax(
        orc.np_tree(variables)), strict=True)
    for route, port in (("reference", port_ref), ("jax", port_jax)):
        port.train(train)
        with torch.no_grad():
            z, p = port(torch.from_numpy(x))
        assert z.shape == p.shape == (2, 16, orc.HEAD)
        orc.assert_close(z, jz_, REL, f"{route} z")
        orc.assert_close(p, jp_, REL, f"{route} p")
        if train:
            want = te.gradual_style_encoder_state_dict_from_jax(
                {"params": variables["params"],
                 "batch_stats": orc.np_tree(new["batch_stats"])})
            orc.assert_stats_close(port.state_dict(), want, 1e-5, route)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3, 9, 13), (1, 4, 4, 8, 8, 8),
                                   (3, 16, 16, 4, 32, 32),
                                   (2, 8, 8, 2, 16, 16)])
def test_bilinear_align_corners_matches_jax(shape):
    b, h, w, c, oh, ow = shape
    x = np.random.RandomState(h * w).randn(b, h, w, c).astype(np.float32)
    want = np.asarray(jp.bilinear_align_corners(jnp.asarray(x), oh, ow))
    got = tp.bilinear_align_corners(torch.from_numpy(x), oh, ow)
    orc.assert_close(got, want, 1e-6, "bilinear")


@functools.lru_cache(maxsize=None)
def _decoder():
    jcfg = JaxConfig(**DECODER)
    z0 = jnp.zeros((1, 16, orc.HEAD))
    dec = orc.np_tree(jax.jit(JaxGenerator(jcfg).init)(
        jax.random.PRNGKey(0), z0, z0))
    cfg = ModelConfig(**DECODER)
    g = Generator(cfg, device="cpu")
    g.load_state_dict(te.generator_state_dict_from_jax(dec, cfg), strict=True)
    return jcfg, dec, g.eval()


@functools.lru_cache(maxsize=None)
def _jax_psp():
    """The JAX ``PSPModel`` (reduced encoder) and its jitted encode and
    decode, traced at their first calls inside ``reduced_jax_encoder``."""
    with orc.reduced_jax_encoder():
        jpsp = jp.PSPModel.create(_decoder()[0])
    return (jax.jit(lambda v, img, a: jpsp.encode(v, img, a)),
            jax.jit(lambda d, z, p, plus: jpsp.decode(d, z, p, plus),
                    static_argnums=3))


@pytest.mark.parametrize("seed", orc.SEEDS)
def test_psp_model_encode_decode_with_injected_latent_avg(seed):
    jcfg, dec, g = _decoder()
    _, variables, ckpt, avg = _case(seed)
    avg = tuple(a.T.copy() for a in avg)           # [T, D]
    x = orc.images(seed)
    enc_fn, dec_fn = _jax_psp()
    with orc.reduced_jax_encoder():
        jz_, jp_ = enc_fn(variables, jnp.asarray(x),
                          tuple(jnp.asarray(a) for a in avg))
    enc, _ = load_gradual_style_encoder(ckpt)
    psp = tp.PSPModel(enc.eval(), g, [torch.from_numpy(a) for a in avg])
    with torch.no_grad():
        z, p = psp.encode(torch.from_numpy(x))
        orc.assert_close(z, jz_, REL, "z")
        orc.assert_close(p, jp_, REL, "p")
        for plus in (True, False):
            want = dec_fn(dec, jz_, jp_, plus)
            got = psp.decode(torch.from_numpy(np.array(jz_)),
                             torch.from_numpy(np.array(jp_)), plus)
            orc.assert_close(got, want, REL, f"decode plus={plus}")


def test_estimate_latent_avg_matches_jax_on_its_draws():
    """``estimate_latent_avg`` fed the JAX package's chunk draws
    (``fold_in(key, i)``) equals JAX's average."""
    jcfg, dec, g = _decoder()
    key, n, chunk = jax.random.PRNGKey(3), 2000, 1000
    want = jp.PSPModel.create(jcfg).estimate_latent_avg(dec, key, n, chunk)
    draws = [tuple(np.asarray(t) for t in jax_sample_zp(
        jax.random.fold_in(key, i), chunk, 16, orc.HEAD))
        for i in range(n // chunk)]
    got = tp.PSPModel(None, g).estimate_latent_avg(draws=draws)
    for a, b, name in zip(got, want, ("z", "p")):
        orc.assert_close(a, b, REL, name)
