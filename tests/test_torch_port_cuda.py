"""The CUDA kernel against its plain version, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernel has
no CPU mode) and skip without one.  This file imports no JAX, and
tests/conftest.py does, so run it on the card with:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.ops import fused_blur

pytestmark = pytest.mark.cuda
TAPS = tuple((np.asarray([1., 3., 3., 1.]) / 8.0 * 2.0).tolist())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


@pytest.mark.parametrize("shape", [(2, 9, 9, 512), (2, 65, 65, 256),
                                   (2, 17, 17, 64), (2, 11, 23, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(dev).manual_seed(0)
    b, c = shape[0], shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    scale = torch.rand((b, c), generator=g, device=dev) + 0.5
    bias = torch.randn((c,), generator=g, device=dev)
    before = fused_blur.launches.value
    got = fused_blur.fused_blur4(x, TAPS, scale=scale, bias=bias, act=True)
    torch.cuda.synchronize()
    assert fused_blur.launches.value == before + 1
    want = fused_blur.fused_blur4_plain(x.float(), TAPS, scale=scale,
                                        bias=bias, act=True)
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        # bf16 rounding, plus the f32 sum-order allowance near zero
        assert bool((err <= 2 * _bf16_ulp(want) + 1e-5).all())


def test_generator_f32_card_matches_cpu(dev):
    cfg = ModelConfig(size=32, style_dim=64, param_dim=64, max_channels=64,
                      n_trans=2)
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randn(2, 16, 64).astype(np.float32))
    p = torch.from_numpy(rng.randn(2, 16, 64).astype(np.float32))
    with torch.no_grad():
        want = Generator(cfg, device="cpu")(z, p).image
        g = Generator(cfg, device=dev)
        before = fused_blur.launches.value
        got = g(z.to(dev), p.to(dev)).image.cpu()
    assert fused_blur.launches.value - before == cfg.log_size - 2
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
