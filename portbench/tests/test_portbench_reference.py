"""The frozen reference against the port's CPU path at a tiny width, so a
fault in the reference shows here before it costs card time."""

import pytest
import torch

from conftest import TINY, tiny_cell
from portbench.harness import program, weights


def pair(cell):
    from transeditor_tpu_torch.models.discriminator import Discriminator
    from transeditor_tpu_torch.models.generator import Generator
    cfg = dict(cell.config, dtype="float32")
    g, d = weights.make(cell.model, 3, "cpu")
    pg = Generator(program.model_config(cfg), device="cpu")
    pd = Discriminator(program.model_config(cfg), device="cpu")
    pg.load_state_dict(weights.state_dict(g), strict=True)
    pd.load_state_dict(weights.state_dict(d), strict=True)
    return g, d, pg, pd


@pytest.mark.parametrize("plus", [False, True])
def test_generator_matches_the_port(plus):
    g, _, pg, _ = pair(tiny_cell("te256_bf16.train_b16"))
    z, p = torch.randn(3, 16, 32), torch.randn(3, 16, 32)
    with torch.no_grad():
        want = g(z, p, plus_space=plus)
        got = pg(z, p, map_z=not plus, map_p=not plus).image
    assert got.shape == want.shape == (3, 32, 32, 3)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_discriminator_matches_the_port():
    _, d, _, pd = pair(tiny_cell("te256_bf16.train_b16"))
    x = torch.randn(4, 32, 32, 3)
    with torch.no_grad():
        want, got = d(x), pd(x)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_reference_keys_are_the_ports():
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.models.generator import Generator
    cfg = ModelConfig(**{k: v for k, v in TINY.items()})
    g, d = weights.templates(dict(tiny_cell("te256_bf16.train_b16").model),
                             "cpu")
    assert set(g.state_dict()) == set(Generator(cfg, device="cpu")
                                      .state_dict())
