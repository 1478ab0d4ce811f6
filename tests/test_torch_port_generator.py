"""The port's Generator vs the JAX Generator on the same weights.

JAX ``Generator.init`` weights go through ``generator_state_dict_from_jax``
into the port; the same numpy codes go through both.  Small config (32px,
two interaction blocks, 64-wide), float32 on the CPU.  Tolerances:
latents and codes 1e-4; images atol 5e-4 / rtol 1e-3 (13 convs sum in
another order; the JAX package matched its reference to ~2e-4).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.io.torch_export import (export_reference_checkpoint,
                                             generator_state_dict)
from transeditor_tpu.models import Generator as JaxGenerator

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.io.checkpoint import load_reference_generator
from transeditor_tpu_torch.io.torch_export import \
    generator_state_dict_from_jax
from transeditor_tpu_torch.models.generator import Generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(size=32, style_dim=64, param_dim=64, max_channels=64, n_trans=2)
IMG_TOL = dict(atol=5e-4, rtol=1e-3)
LAT_TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(seed=0, **kw):
    """(jax module, jax params, numpy params, port Generator)."""
    kw = {**TINY, **kw}
    jg = JaxGenerator(JaxConfig(**kw))
    z0 = jnp.zeros((1, 16, kw["style_dim"]))
    params = jg.init({"params": jax.random.PRNGKey(seed),
                      "noise": jax.random.PRNGKey(seed + 1)}, z0, z0)
    params_np = jax.tree.map(np.asarray, params)
    cfg = ModelConfig(**kw)
    g = Generator(cfg, device="cpu")
    g.load_state_dict(generator_state_dict_from_jax(params_np, cfg),
                      strict=True)
    return jg, params, params_np, g


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _codes(seed, b=2, d=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 16, d).astype(np.float32),
            rng.randn(b, 16, d).astype(np.float32))


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               **tol)


def test_state_dict_matches_jax_export(pair):
    _, _, params_np, _ = pair
    ours = generator_state_dict_from_jax(params_np, ModelConfig(**TINY))
    ref = generator_state_dict(params_np, JaxConfig(**TINY))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_state_dict_names_are_the_reference_keys(pair):
    _, _, params_np, g = pair
    ref = generator_state_dict(params_np, JaxConfig(**TINY))
    assert set(g.state_dict()) == set(ref)
    for k, v in g.state_dict().items():
        assert tuple(v.shape) == ref[k].shape, k


@torch.no_grad()
def test_default_forward_matches_jax(pair):
    jg, params, _, g = pair
    z, p = _codes(1)
    want = jg.apply(params, jnp.asarray(z), jnp.asarray(p))
    got = g(torch.from_numpy(z), torch.from_numpy(p))
    _close(got.image, want.image, IMG_TOL)
    for name in ("latent", "p_plus", "z_plus"):
        _close(getattr(got, name), getattr(want, name), LAT_TOL)


@torch.no_grad()
def test_similarity_matches_jax(pair):
    jg, params, _, g = pair
    z, p = _codes(2)
    want = jg.apply(params, jnp.asarray(z), jnp.asarray(p),
                    return_similarity=True)
    got = g(torch.from_numpy(z), torch.from_numpy(p), return_similarity=True)
    assert len(got.similarity) == len(want.similarity) == 2
    for a, b in zip(got.similarity, want.similarity):
        assert tuple(a.shape) == (2, 4, 16, 16)
        _close(a, b, LAT_TOL)
    _close(got.image, want.image, IMG_TOL)


@torch.no_grad()
def test_input_is_latent_matches_jax(pair):
    jg, params, _, g = pair
    z, p = _codes(3)
    latent = np.array(jg.apply(params, jnp.asarray(z),
                               jnp.asarray(p)).latent)
    want = jg.apply(params, jnp.asarray(latent), jnp.asarray(p),
                    input_is_latent=True)
    got = g(torch.from_numpy(latent), torch.from_numpy(p),
            input_is_latent=True)
    assert got.z_plus is None
    _close(got.image, want.image, IMG_TOL)
    _close(got.p_plus, want.p_plus, LAT_TOL)


@torch.no_grad()
def test_plus_space_decode_matches_jax(pair):
    jg, params, _, g = pair
    z, p = _codes(4)
    want = jg.apply(params, jnp.asarray(z), jnp.asarray(p), map_z=False,
                    map_p=False)
    got = g(torch.from_numpy(z), torch.from_numpy(p), map_z=False,
            map_p=False)
    _close(got.image, want.image, IMG_TOL)
    _close(got.latent, want.latent, LAT_TOL)


@torch.no_grad()
def test_stage_api_composes_to_forward(pair):
    _, _, _, g = pair
    z, p = (torch.from_numpy(a) for a in _codes(5))
    z_plus, p_plus = g.map_codes(z, p)
    latent = g.style_latents_from(g.interact_codes(z_plus, p_plus))
    image = g.synthesize(p_plus, latent)
    full = g(z, p)
    torch.testing.assert_close(image, full.image)
    torch.testing.assert_close(g.map_z(z), full.z_plus)
    torch.testing.assert_close(g.map_p(p), full.p_plus)


@torch.no_grad()
def test_no_trans_matches_jax():
    jg, params, _, g = _pair(seed=7, no_trans=True)
    z, p = _codes(6)
    want = jg.apply(params, jnp.asarray(z), jnp.asarray(p))
    got = g(torch.from_numpy(z), torch.from_numpy(p))
    _close(got.image, want.image, IMG_TOL)
    _close(got.latent, want.latent, LAT_TOL)


@torch.no_grad()
def test_noise_injection_with_explicit_noise_matches_jax():
    jg, _, params_np, _ = _pair(seed=9, layer_noise_injection=True)
    # zero-init noise weights would hide the noise: give them values
    rng = np.random.RandomState(8)
    for tree in params_np["params"].values():
        if "noise_weight" in tree:
            tree["noise_weight"] = np.float32(rng.randn())
    cfg = ModelConfig(**TINY, layer_noise_injection=True)
    g = Generator(cfg, device="cpu")
    g.load_state_dict(generator_state_dict_from_jax(params_np, cfg),
                      strict=True)
    z, p = _codes(7)
    noise = [rng.randn(2, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1)
             .astype(np.float32) for i in range(cfg.num_layers)]
    want = jg.apply(jax.tree.map(jnp.asarray, params_np), jnp.asarray(z),
                    jnp.asarray(p), noise=[jnp.asarray(n) for n in noise])
    got = g(torch.from_numpy(z), torch.from_numpy(p),
            noise=[torch.from_numpy(n) for n in noise])
    _close(got.image, want.image, IMG_TOL)
    # drawn noise (no explicit list) changes the image
    drawn = g(torch.from_numpy(z), torch.from_numpy(p),
              rng=torch.Generator().manual_seed(0))
    assert not torch.allclose(drawn.image, got.image)


@torch.no_grad()
def test_num_region_tail_tokens_zero_and_match_jax():
    jg, params, _, g = _pair(seed=11, num_region=2)
    z, p = _codes(9)
    want = jg.apply(params, jnp.asarray(z), jnp.asarray(p))
    got = g(torch.from_numpy(z), torch.from_numpy(p))
    assert torch.count_nonzero(got.z_plus[:, 8:]) == 0
    assert torch.count_nonzero(got.p_plus[:, 8:]) == 0
    _close(got.image, want.image, IMG_TOL)


def test_load_reference_generator_reads_exported_pt(pair, tmp_path):
    _, params, _, g = pair
    path = tmp_path / "g.pt"
    export_reference_checkpoint(str(path), JaxConfig(**TINY), g_ema=params)
    sd = load_reference_generator(str(path), ModelConfig(**TINY))
    fresh = Generator(ModelConfig(**TINY), device="cpu", seed=123)
    fresh.load_state_dict(sd, strict=True)
    for k, v in g.state_dict().items():
        if not k.startswith("noises."):
            torch.testing.assert_close(fresh.state_dict()[k], v)
    with pytest.raises(ValueError):
        load_reference_generator(str(path), ModelConfig(size=64))


def test_bf16_forward_keeps_bf16_activations(pair):
    cfg = ModelConfig(**TINY, dtype="bfloat16")
    g = Generator(cfg, device="cpu")
    g.load_state_dict(pair[3].state_dict(), strict=True)
    z, p = (torch.from_numpy(a) for a in _codes(10))
    with torch.no_grad():
        out = g(z, p)
    for name in ("image", "latent", "p_plus", "z_plus"):
        assert getattr(out, name).dtype == torch.bfloat16, name
    assert all(v.dtype == torch.float32 for v in g.state_dict().values())
    assert torch.isfinite(out.image.float()).all()


def test_generator_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(ModelConfig(**TINY))


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports without JAX
    or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import transeditor_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'transeditor_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'transeditor_tpu_torch.serve' in sys.modules\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
