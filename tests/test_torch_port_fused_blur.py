"""The port's ``fused_blur4`` (its plain version, as it runs on the CPU)
vs the JAX Pallas kernel in interpret mode and vs the JAX upfirdn2d
chain.  The CUDA kernel itself is held against the same plain version on
the card (``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``).

Tolerances: a 16-product float32 sum, 1e-5; with the scale + bias +
activation epilogue the values grow, 1e-4 (as tests/test_pallas_blur.py).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from transeditor_tpu.ops import modconv as jax_modconv
from transeditor_tpu.ops.pallas_blur import fused_blur4 as jax_fused_blur4
from transeditor_tpu.ops.resample import upfirdn2d as jax_upfirdn2d

from transeditor_tpu_torch.ops import fused_blur, modconv

TAPS = tuple((np.asarray([1., 3., 3., 1.]) / 8.0 * 2.0).tolist())  # up gain


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _jax_chain(x, pad, scale=None, bias=None, act=False):
    y = jax_upfirdn2d(jnp.asarray(x), jnp.asarray(np.outer(TAPS, TAPS),
                                                  jnp.float32),
                      up=1, down=1, pad=pad)
    if scale is not None:
        y = y * jnp.asarray(scale)[:, None, None, :]
    if bias is not None:
        y = y + jnp.asarray(bias)
    if act:
        y = jnp.where(y >= 0, y, 0.2 * y) * math.sqrt(2)
    return np.asarray(y)


@pytest.mark.parametrize("h,c", [(9, 128), (17, 256), (33, 128), (129, 128)])
def test_matches_pallas_kernel(h, c):
    x = np.random.RandomState(0).randn(1, h, h, c).astype(np.float32)
    want = np.asarray(jax_fused_blur4(jnp.asarray(x), TAPS, (1, 1),
                                      interpret=True))
    got = fused_blur.fused_blur4(_t(x), TAPS, (1, 1))
    assert tuple(got.shape) == want.shape == (1, h - 1, h - 1, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_epilogue_matches_pallas_kernel():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 9, 128).astype(np.float32)
    scale = (rng.rand(2, 128) + 0.5).astype(np.float32)
    bias = rng.randn(128).astype(np.float32)
    want = np.asarray(jax_fused_blur4(
        jnp.asarray(x), TAPS, (1, 1), scale=jnp.asarray(scale),
        bias=jnp.asarray(bias), act=True, interpret=True))
    got = fused_blur.fused_blur4(_t(x), TAPS, (1, 1), scale=_t(scale),
                                 bias=_t(bias), act=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,pad,epilogue", [
    ((2, 17, 17, 64), (1, 1), True),       # C the Pallas kernel refuses
    ((2, 11, 23, 20), (1, 1), False),      # non-square, odd C
    ((1, 12, 9, 8), (2, 1), True),         # asymmetric pad
])
def test_matches_upfirdn2d_chain(shape, pad, epilogue):
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype(np.float32)
    b, c = shape[0], shape[-1]
    scale = (rng.rand(b, c) + 0.5).astype(np.float32) if epilogue else None
    bias = rng.randn(c).astype(np.float32) if epilogue else None
    want = _jax_chain(x, pad, scale, bias, act=epilogue)
    got = fused_blur.fused_blur4(
        _t(x), TAPS, pad, scale=None if scale is None else _t(scale),
        bias=None if bias is None else _t(bias), act=epilogue)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_plain_rounds_once_to_bf16():
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 9, 9, 16)
                         .astype(np.float32)).to(torch.bfloat16)
    got = fused_blur.fused_blur4(x, TAPS)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    want = fused_blur.fused_blur4_plain(x.float(), TAPS)
    assert torch.equal(got, want.to(torch.bfloat16))


def test_cpu_path_does_not_count_launches():
    before = fused_blur.launches.value
    fused_blur.fused_blur4(torch.zeros(1, 5, 5, 4), TAPS)
    assert fused_blur.launches.value == before


def test_rejects_bad_arguments():
    x = torch.zeros(2, 9, 9, 8)
    with pytest.raises(ValueError):
        fused_blur.fused_blur4(x, TAPS[:3])
    with pytest.raises(ValueError):
        fused_blur.fused_blur4(x, TAPS, scale=torch.ones(2, 4))
    with pytest.raises(ValueError):
        fused_blur.fused_blur4(x, TAPS, bias=torch.ones(9))
    with pytest.raises(ValueError):
        fused_blur.fused_blur4(torch.zeros(9, 9, 8), TAPS)
    with pytest.raises(ValueError):
        fused_blur.fused_blur4(torch.zeros(1, 2, 2, 8), TAPS, pad=(0, 0))


@pytest.mark.parametrize("bias,act", [(False, False), (True, True)])
def test_modulated_conv2d_up_fused_matches_jax(bias, act):
    rng = np.random.RandomState(5)
    b, in_ch, out_ch, h = 2, 8, 12, 5
    x = rng.randn(b, h, h, in_ch).astype(np.float32)
    w = rng.randn(3, 3, in_ch, out_ch).astype(np.float32)       # HWIO
    s = (1 + 0.1 * rng.randn(b, in_ch)).astype(np.float32)
    bv = rng.randn(out_ch).astype(np.float32) if bias else None
    want = np.asarray(jax_modconv.modulated_conv2d_up_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
        bias=None if bv is None else jnp.asarray(bv), activate=act))
    got = modconv.modulated_conv2d_up_fused(
        _t(x), _t(w.transpose(3, 2, 0, 1)), _t(s),
        bias=None if bv is None else _t(bv), activate=act)
    assert tuple(got.shape) == want.shape == (b, 2 * h, 2 * h, out_ch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
