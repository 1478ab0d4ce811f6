"""The port's ``cli/visualize.py`` against the JAX package's, on the CPU.

One narrow 32px model (64 wide, two attention blocks) in float32: JAX
``init`` weights go through ``generator_state_dict_from_jax`` into the
port, and the port's ``run_*`` draw JAX's codes through ``draws=`` (the
JAX CLI's ``sample_tokens`` on ``PRNGKey(seed)``).  Tolerances: every
PNG within 1 uint8 level of JAX's (the images agree to ~5e-4 in
[-1, 1], 0.06 of a level, so only a value next to a rounding boundary
moves); the similarity heatmaps within 1 level (the attention
similarities agree to float32 rounding, and ``colorize_heatmap``
truncates); ``colorize_heatmap`` of the same similarities byte-equal;
``main``'s file tree equal to the JAX CLI's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import transeditor_tpu.cli.common as jax_common
from transeditor_tpu.cli import visualize as jvis
from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.models import Generator as JaxGenerator
from transeditor_tpu.utils.image import colorize_heatmap as jax_heatmap
from transeditor_tpu.utils.sampling import sample_tokens

from transeditor_tpu_torch.cli import visualize as vis
from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.io.checkpoint import save_train_state
from transeditor_tpu_torch.io.torch_export import \
    generator_state_dict_from_jax
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.train.gan import TrainConfig, init_state
from transeditor_tpu_torch.utils.image import colorize_heatmap
from torch_port_threads import torch_worker_threads  # noqa: F401

TINY = dict(size=32, style_dim=64, param_dim=64, max_channels=64, n_trans=2)


def jax_draws(seed, batch, n_tokens, dim, truncation=1.0, same=False):
    return np.asarray(sample_tokens(jax.random.PRNGKey(seed), batch,
                                    n_tokens, dim, truncation, same=same))


@pytest.fixture(scope="module")
def samplers():
    """(JAX Sampler, port Sampler) on the same weights."""
    jcfg = JaxConfig(**TINY)
    z0 = jnp.zeros((1, 16, 64))
    params = JaxGenerator(jcfg).init({"params": jax.random.PRNGKey(0),
                                      "noise": jax.random.PRNGKey(1)},
                                     z0, z0)
    cfg = ModelConfig(**TINY)
    g = Generator(cfg, device="cpu")
    g.load_state_dict(generator_state_dict_from_jax(
        jax.tree.map(np.asarray, params), cfg), strict=True)
    return jvis.Sampler(jcfg, params), vis.Sampler(g)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _assert_pngs_match(port_dir, jax_dir, levels=1):
    names = _tree(jax_dir)
    assert names and _tree(port_dir) == names
    for name in names:
        got = np.asarray(Image.open(os.path.join(port_dir, name)), np.int16)
        want = np.asarray(Image.open(os.path.join(jax_dir, name)), np.int16)
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= levels, name


def _run_both(tmp_path, fn_name, samplers, **kw):
    js, ps = samplers
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    getattr(jvis, fn_name)(js, str(jdir), **kw)
    getattr(vis, fn_name)(ps, str(pdir), draws=jax_draws, **kw)
    _assert_pngs_match(pdir, jdir)


def test_run_sample(tmp_path, samplers):
    _run_both(tmp_path, "run_sample", samplers, n_sample=4, loops=2)


@pytest.mark.parametrize("which", ["z", "p"])
def test_run_swap(tmp_path, samplers, which):
    _run_both(tmp_path, "run_swap", samplers, which=which, n_sample=2,
              loops=2)


@pytest.mark.parametrize("space", ["z", "z+", "w", "p", "p+"])
def test_run_interp(tmp_path, samplers, space):
    _run_both(tmp_path, "run_interp", samplers, space=space, n_rows=2,
              steps=2, num_tests=1)


@pytest.mark.parametrize("space", ["z", "z+", "p", "p+"])
def test_run_dat_interp(tmp_path, samplers, space):
    _run_both(tmp_path, "run_dat_interp", samplers, space=space, n=2,
              steps=2, num_tests=1)


def test_run_similarity(tmp_path, samplers):
    _run_both(tmp_path, "run_similarity", samplers, n=2)
    js, _ = samplers
    z = jax_draws(0, 2, 16, 64)
    p = jax_draws(1, 2, 16, 64)
    out = js.gen.apply(js.params, jnp.asarray(z), jnp.asarray(p),
                       return_similarity=True)
    for sim in out.similarity:
        sim = np.asarray(sim, np.float32).mean(axis=0)
        for head in sim:
            np.testing.assert_array_equal(colorize_heatmap(head),
                                          jax_heatmap(head))


def _fake_jax_sampler(monkeypatch):
    """The JAX CLI with its model replaced by zero images of the right
    shape: its file tree without compiling a generator."""
    def images(self, z, p, **kw):
        return np.zeros((len(z), 32, 32, 3), np.float32)

    monkeypatch.setattr(jvis, "load_reference_generator",
                        lambda path, cfg: None)
    monkeypatch.setattr(jvis.Sampler, "images", images)
    monkeypatch.setattr(jvis.Sampler, "map_codes",
                        lambda self, z, p: (np.asarray(z), np.asarray(p)))
    monkeypatch.setattr(jvis.Sampler, "style_latents",
                        lambda self, z, p: np.zeros((len(z), 14, 64),
                                                    np.float32))


ARGV = ["--sample", "--swap_z", "--swap_p", "--interp", "--dat_interp",
        "--n_sample", "4", "--loop_num", "2", "--interp_num", "1",
        "--dtype", "float32"]


def test_main_file_tree_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_common, "model_config_from_args",
                        lambda args, **kw: JaxConfig(**TINY))
    monkeypatch.setattr(vis, "model_config_from_args",
                        lambda args, **kw: ModelConfig(**TINY))
    _fake_jax_sampler(monkeypatch)
    cfg = ModelConfig(**TINY)
    pt = tmp_path / "g.pt"
    torch.save({"g_ema": Generator(cfg, device="cpu").state_dict()}, pt)
    jvis.main(["--ckpt", str(pt), "--out", str(tmp_path / "jax")] + ARGV)
    vis.main(["--ckpt", str(pt), "--out", str(tmp_path / "port"),
              "--device", "cpu"] + ARGV)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")

    # a directory of the port's training checkpoints reads its g_ema
    state = init_state(cfg, TrainConfig(), seed=2, device="cpu")
    save_train_state(str(tmp_path / "ckpt"), 1, state)
    vis.main(["--ckpt", str(tmp_path / "ckpt"), "--out",
              str(tmp_path / "from_state"), "--device", "cpu", "--sample",
              "--n_sample", "4", "--loop_num", "1", "--dtype", "float32"])
    assert _tree(tmp_path / "from_state") == ["0.png"]


def test_orbax_directory_is_refused(tmp_path):
    (tmp_path / "orbax" / "0").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        vis.load_generator_weights(str(tmp_path / "orbax"),
                                   ModelConfig(**TINY))
