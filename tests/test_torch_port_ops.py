"""The port's ops vs the JAX package's, on the CPU in float32.

Inputs come from ``np.random.RandomState`` and go through both the JAX
function and its ``transeditor_tpu_torch`` counterpart.  Resampling is
a sum of at most 16 products per output, so float32 agrees to 1e-5; the
modulated convs sum up to 3*3*16 products in another order, hence 1e-4.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.nn.layers import EqualConv2d as JaxEqualConv2d
from transeditor_tpu.nn.layers import layer_norm_tokens as jax_layer_norm
from transeditor_tpu.nn.layers import pixel_norm as jax_pixel_norm
from transeditor_tpu.ops import act as jax_act
from transeditor_tpu.ops import modconv as jax_modconv
from transeditor_tpu.ops import resample as jax_resample

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.nn.layers import (EqualConv2d, layer_norm_tokens,
                                             pixel_norm)
from transeditor_tpu_torch.ops import act, modconv, resample
from transeditor_tpu_torch.ops.precision import conv_precision
from torch_port_threads import torch_worker_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def test_config_invariants_match_jax():
    for kw in ({}, {"size": 32, "channel_multiplier": 1},
               {"num_region": 2, "size": 1024}):
        ours, ref = ModelConfig(**kw), JaxConfig(**kw)
        for name in ("log_size", "token_dim", "n_latent", "num_layers",
                     "num_mappings", "channels"):
            assert getattr(ours, name) == getattr(ref, name), name
    cfg = ModelConfig()
    assert (cfg.token_dim, cfg.num_layers, cfg.num_mappings) == (14, 13, 16)
    assert cfg.compute_dtype == torch.float32
    assert ModelConfig(dtype="bfloat16").compute_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        ModelConfig(size=100)


@pytest.mark.parametrize("up,down,pad,taps_1d", [
    (1, 1, (0, 0), False),
    (2, 1, (2, 1), False),      # Upsample pads
    (1, 2, (1, 1), False),      # Downsample pads
    (1, 1, (-1, 2), False),     # negative pad crops
    (2, 2, (1, 1), False),
    (2, 1, (2, 1), True),       # separable 1-D taps path
    (1, 2, (-1, 2), True),
])
def test_upfirdn2d_matches_jax(up, down, pad, taps_1d):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 10, 3).astype(np.float32)
    k1 = np.asarray([1.0, 3.0, 3.0, 1.0], np.float32)
    kernel = (k1 / k1.sum() * up if taps_1d
              else resample.make_resample_kernel(k1))
    want = np.asarray(jax_resample.upfirdn2d(jnp.asarray(x),
                                             jnp.asarray(kernel), up=up,
                                             down=down, pad=pad))
    got = resample.upfirdn2d(_t(x), kernel, up=up, down=down, pad=pad)
    assert tuple(got.shape) == want.shape
    # out = (in*up + p0 + p1 - k)//down + 1
    assert got.shape[1] == (8 * up + pad[0] + pad[1] - 4) // down + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn,kw", [
    ("upsample_2d", {}),
    ("downsample_2d", {}),
    ("blur", {"pad": (2, 1)}),
    ("blur", {"pad": (1, 1), "upsample_factor": 2}),
])
def test_resample_helpers_match_jax(fn, kw):
    x = np.random.RandomState(1).randn(2, 8, 8, 4).astype(np.float32)
    want = np.asarray(getattr(jax_resample, fn)(jnp.asarray(x), **kw))
    got = getattr(resample, fn)(_t(x), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_activations_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 5, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    np.testing.assert_allclose(
        act.fused_leaky_relu(_t(x), _t(b)).numpy(),
        np.asarray(jax_act.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        act.scaled_leaky_relu(_t(x)).numpy(),
        np.asarray(jax_act.scaled_leaky_relu(jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", [-1, -2])
def test_norms_match_jax(axis):
    x = np.random.RandomState(3).randn(3, 16, 24).astype(np.float32) * 2 + 1
    np.testing.assert_allclose(
        pixel_norm(_t(x), axis=axis).numpy(),
        np.asarray(jax_pixel_norm(jnp.asarray(x), axis=axis)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layer_norm_tokens(_t(x)).numpy(),
        np.asarray(jax_layer_norm(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["plain", "up", "down"])
@pytest.mark.parametrize("demod", [True, False])
def test_modulated_conv2d_matches_jax(mode, demod):
    rng = np.random.RandomState(4)
    b, in_ch, out_ch, k, h = 2, 8, 16, 3, 8
    if mode == "plain" and not demod:
        k = 1                                   # the ToRGB configuration
    x = rng.randn(b, h, h, in_ch).astype(np.float32)
    w = rng.randn(k, k, in_ch, out_ch).astype(np.float32)     # HWIO
    s = (1 + 0.1 * rng.randn(b, in_ch)).astype(np.float32)
    flags = dict(demodulate=demod, upsample=mode == "up",
                 downsample=mode == "down")
    want = np.asarray(jax_modconv.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), **flags))
    got = modconv.modulated_conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)),
                                   _t(s), **flags)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0)])
def test_equal_conv2d_matches_jax(stride, padding):
    import jax
    x = np.random.RandomState(6).randn(2, 9, 9, 5).astype(np.float32)
    jmod = JaxEqualConv2d(7, 3, stride=stride, padding=padding)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    w = np.asarray(params["params"]["weight"])                 # HWIO
    b = np.random.RandomState(7).randn(7).astype(np.float32)
    params = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}}
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    conv = EqualConv2d(5, 7, 3, stride=stride, padding=padding)
    with torch.no_grad():
        conv.weight.copy_(_t(w.transpose(3, 2, 0, 1)))
        conv.bias.copy_(_t(b))
        got = conv(_t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_int8_not_ported():
    """The int8 mode is ported now (ops/quant.py): quantize="int8" no
    longer raises, and the modulated conv runs through quantized_conv
    (held to JAX in tests/test_torch_port_quant.py)."""
    from transeditor_tpu_torch.ops.quant import quantized_conv

    rng = np.random.RandomState(0)
    x = _t(rng.randn(1, 4, 4, 2))
    w = _t(rng.randn(3, 2, 3, 3))
    got = modconv.modulated_conv2d(x, w, torch.ones(1, 2), demodulate=False,
                                   quantize="int8")
    want = quantized_conv(x, w * (1.0 / np.sqrt(2 * 9)), torch.float32,
                          padding=1)
    assert got.shape == (1, 4, 4, 3)
    assert torch.equal(got, want)


def test_f32_precision_turns_tf32_off():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        conv_precision(torch.bfloat16)          # bf16 leaves them alone
        assert torch.backends.cudnn.allow_tf32
        conv_precision(torch.float32)
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
