"""The port's int8 mode (``ops/quant.py``, the int8 branches of
``ops/modconv.py``) against the JAX package's, on the CPU.

Inputs come from numpy seeds; weights go HWIO (JAX) <-> OIHW (port).
Tolerances: int8 values, float32 scales and int32 sums exactly equal
(``conv2d_int8_plain`` is exact in float64); ``quantized_conv`` equal in
float32 and bfloat16 (the same rounding steps in the same order); the
modulated convs around it as each test states.  The 32px int8 generator (``max_channels=64``, as
``tests/test_quant.py``) against JAX's with the same weights: PSNR >= 45
dB (53.9 dB measured) and mean |diff| <= 2e-3 (6.3e-4 measured): the
mapping and attention matmuls differ in their last bits, and an
activation within that of a rounding boundary quantises to the next
int8 step, which moves a few percent of the pixels.  The port's own
int8-vs-float32 gate is the JAX test's, > 24 dB (27.47 dB measured).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.models import Generator as JaxGenerator
from transeditor_tpu.ops import modconv as jmodconv
from transeditor_tpu.ops import quant as jq

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.io.torch_export import \
    generator_state_dict_from_jax
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.ops import modconv, quant
from torch_port_threads import torch_worker_threads  # noqa: F401

SMALL = dict(size=32, max_channels=64)
MODES = [dict(stride=1, padding=1, transpose=False),
         dict(stride=2, padding=0, transpose=False),
         dict(stride=2, padding=0, transpose=True)]
MODE_IDS = ["stride1", "downsample", "transposed"]


def _hwio_to_oihw(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _operands(seed, shape=(2, 5, 7, 20), out_ch=6, k=3):
    rng = np.random.RandomState(seed)
    gain = np.asarray([1.0, 10.0, 0.1, 3.0][:shape[0]], np.float32)
    x = (rng.randn(*shape) * gain[:, None, None, None]).astype(np.float32)
    w = (rng.randn(k, k, shape[3], out_ch) * 0.3).astype(np.float32)
    return x, w


@pytest.mark.parametrize("in_ch,out_ch,k", [(20, 6, 3), (6, 20, 3),
                                            (32, 16, 1)])
def test_weight_quantization_equals_jax(in_ch, out_ch, k):
    _, w = _operands(0, (1, 1, 1, in_ch), out_ch, k)
    wq, sw = jq.quantize_weight_per_oc(jnp.asarray(w))
    twq, tsw = quant.quantize_weight_per_oc(_hwio_to_oihw(w))
    assert twq.dtype == torch.int8 and tsw.dtype == torch.float32
    np.testing.assert_array_equal(twq.numpy(),
                                  np.asarray(wq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(sw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_quantization_equals_jax(dtype):
    x, _ = _operands(1, (4, 5, 5, 8))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    xq, sx = jq.quantize_act_per_sample(jx)
    txq, tsx = quant.quantize_act_per_sample(tx)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(sx))
    # each sample uses its own range: its largest magnitude hits 127
    assert (txq.abs().amax(dim=(1, 2, 3)) == 127).all()


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("shape,out_ch,k", [((2, 5, 7, 20), 6, 3),
                                            ((1, 9, 4, 6), 20, 3),
                                            ((2, 4, 5, 32), 16, 1)])
def test_conv2d_int8_plain_equals_jax(mode, shape, out_ch, k):
    x, w = _operands(2, shape, out_ch, k)
    xq, _ = jq.quantize_act_per_sample(jnp.asarray(x))
    wq, _ = jq.quantize_weight_per_oc(jnp.asarray(w))
    want = np.asarray(jq.conv2d_int8(xq, wq, **mode))
    got = quant.conv2d_int8_plain(torch.from_numpy(np.array(xq)),
                                  _hwio_to_oihw(np.asarray(wq)), **mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    again = quant.conv2d_int8(torch.from_numpy(np.array(xq)),
                              _hwio_to_oihw(np.asarray(wq)), **mode)
    assert torch.equal(again, got)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_conv_equals_jax(mode, dtype):
    x, w = _operands(3)
    want = jq.quantized_conv(jnp.asarray(x).astype(dtype), jnp.asarray(w),
                             getattr(jnp, dtype), **mode)
    got = quant.quantized_conv(torch.from_numpy(x).to(getattr(torch, dtype)),
                               _hwio_to_oihw(w), getattr(torch, dtype),
                               **mode)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_modulated_convs_int8_equal_jax(dtype):
    """The int8 branches of both modulated convs, the up-conv through
    ``fused_blur4``'s plain version with demod, bias and activation."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 6, 16).astype(np.float32)
    w = rng.randn(3, 3, 16, 24).astype(np.float32)
    style = (rng.rand(2, 16) + 0.5).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))
    tw, ts, tb = _hwio_to_oihw(w), torch.from_numpy(style), \
        torch.from_numpy(bias)
    # the quantised conv is equal (test_quantized_conv_equals_jax); demod's
    # float32 matmul sums in another order, one ulp of the product
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    want = jmodconv.modulated_conv2d(jx, jnp.asarray(w), jnp.asarray(style),
                                     quantize="int8")
    got = modconv.modulated_conv2d(tx, tw, ts, quantize="int8")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    want = jmodconv.modulated_conv2d_up_fused(
        jx, jnp.asarray(w), jnp.asarray(style), bias=jnp.asarray(bias),
        activate=True, quantize="int8")
    got = modconv.modulated_conv2d_up_fused(tx, tw, ts, bias=tb,
                                            activate=True, quantize="int8")
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        # the blur sums in another order (fused_blur4's plain version is a
        # depthwise conv)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        # JAX's unfused bf16 chain rounds after demod, after the blur and
        # after the activation, fused_blur4 once: within 2 bf16 ulps of
        # the largest magnitude (1.5 measured)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2.0 ** -7 * np.abs(want).max(), err


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return 10 * np.log10(4.0 / mse)          # images live in [-1, 1]


@pytest.fixture(scope="module")
def int8_images():
    """(JAX int8, port int8, port float32) images of the 32px model on
    the same weights and codes."""
    rng = np.random.RandomState(3)
    z = rng.randn(4, 16, 512).astype(np.float32)
    p = rng.randn(4, 16, 512).astype(np.float32)
    jg32 = JaxGenerator(JaxConfig(**SMALL))
    jg8 = JaxGenerator(JaxConfig(**SMALL, quantize="int8"))
    params = jg32.init(jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(p))
    sd = generator_state_dict_from_jax(jax.tree.map(np.asarray, params),
                                       ModelConfig(**SMALL))
    jax_img = np.asarray(jg8.apply(params, z, p).image)
    g8 = Generator(ModelConfig(**SMALL, quantize="int8"), device="cpu")
    g8.load_state_dict(sd, strict=True)
    g32 = Generator(ModelConfig(**SMALL), device="cpu")
    g32.load_state_dict(sd, strict=True)
    with torch.no_grad():
        zt, pt = torch.from_numpy(z), torch.from_numpy(p)
        return jax_img, g8(zt, pt).image.numpy(), g32(zt, pt).image.numpy()


def test_generator_int8_matches_jax(int8_images):
    jax_img, img8, _ = int8_images
    assert img8.shape == jax_img.shape
    assert _psnr(img8, jax_img) >= 45.0
    assert np.abs(img8 - jax_img).mean() <= 2e-3


def test_generator_int8_quality_gate(int8_images):
    _, img8, img32 = int8_images
    psnr = _psnr(img8, img32)
    assert psnr > 24.0, f"int8 path too lossy: PSNR={psnr:.1f} dB"


def test_wrapper_checks_operands():
    xq = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    wq = torch.zeros((4, 8, 3, 3), dtype=torch.int8)
    with pytest.raises(TypeError):
        quant.conv2d_int8(xq.float(), wq)
    with pytest.raises(ValueError):
        quant.conv2d_int8(xq, wq[:, :4].contiguous())
    with pytest.raises(ValueError):
        quant.conv2d_int8(xq, wq, stride=1, transpose=True)
    with pytest.raises(ValueError):
        quant.conv2d_int8(xq, wq, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        quant.conv2d_int8(xq, wq, out_dtype=torch.float16)


def test_quantized_operands_are_dense():
    """A permuted (channels-first) input, as the generator's first conv
    can get it, quantises to a dense NHWC int8 tensor: the kernel reads
    only contiguous operands."""
    x = torch.randn(2, 8, 4, 4).permute(0, 2, 3, 1)
    assert not x.is_contiguous()
    xq, _ = quant.quantize_act_per_sample(x * 2.0)
    wq, _ = quant.quantize_weight_per_oc(torch.randn(3, 3, 3, 8)
                                         .permute(3, 2, 0, 1))
    assert xq.is_contiguous() and wq.is_contiguous()
