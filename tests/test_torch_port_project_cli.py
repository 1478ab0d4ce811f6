"""The port's ``cli.project`` against the JAX package's ``cli.project``.

One reference-layout ``.pt`` (the JAX generator's weights through
``export_reference_checkpoint``) and three 16px PNGs go through both
CLIs at ``--size 16 --num_trans 1 --step 4 --batch 2``, so the second
batch holds one image padded to two.  The CLIs draw their latent
statistics and noise from different generators (JAX keys, a seeded
``torch.Generator``), so the outputs are compared by file, shape and
finiteness, the targets (``origin_i.png``) pixel for pixel, and the
padded row is shown not to leak into the latents.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from transeditor_tpu.cli.project import main as jax_main
from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.io.torch_export import export_reference_checkpoint
from transeditor_tpu.models import Generator as JaxGenerator

from transeditor_tpu_torch.cli.project import main as port_main
from transeditor_tpu_torch.utils.image import load_png, save_png
import torch_port_disk as disk
from torch_port_threads import torch_worker_threads  # noqa: F401

SIZE, N_IMAGES = 16, 3
FLAGS = ["--size", str(SIZE), "--num_trans", "1", "--step", "4",
         "--batch", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("project")
    cfg = JaxConfig(size=SIZE, n_trans=1)
    z0 = jnp.zeros((1, cfg.n_tokens, cfg.style_dim))
    params = JaxGenerator(cfg).init(jax.random.PRNGKey(0), z0, z0)
    ckpt = str(root / "g.pt")
    export_reference_checkpoint(ckpt, cfg, g_ema=params)
    data = root / "imgs"
    data.mkdir()
    rng = np.random.RandomState(0)
    for i in range(N_IMAGES):
        save_png(str(data / f"{i}.png"),
                 rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8))
    common = ["--ckpt", ckpt, "--dataset_dir", str(data), *FLAGS]
    jax_main([*common, "--output_dir", str(root / "jax")])
    with pytest.warns(UserWarning, match="random LPIPS"):
        port_main([*common, "--output_dir", str(root / "port"),
                   "--device", "cpu"])
    yield root / "jax", root / "port"
    disk.tidy(root)


def test_the_same_files(runs):
    jax_out, port_out = runs
    want = {f"{k}_{i}.png" for k in ("origin", "project")
            for i in range(N_IMAGES)} | {"latents.npy", "param.npy"}
    assert set(os.listdir(jax_out)) == set(os.listdir(port_out)) == want


def test_latents_shapes_and_no_padded_row(runs):
    for out in runs:
        z = np.load(out / "latents.npy")
        p = np.load(out / "param.npy")
        assert z.shape == p.shape == (N_IMAGES, 16, 512), out
        assert np.isfinite(z).all() and np.isfinite(p).all()
        # image 2 was inverted beside a copy of itself; only its own row
        # is kept, and it is not image 1's
        assert not np.allclose(z[1], z[2]) and not np.allclose(p[1], p[2])


def test_images_match_targets_and_shapes(runs):
    jax_out, port_out = runs
    for i in range(N_IMAGES):
        want = load_png(str(jax_out / f"origin_{i}.png"))
        got = load_png(str(port_out / f"origin_{i}.png"))
        np.testing.assert_array_equal(got, want)
        a = load_png(str(jax_out / f"project_{i}.png"))
        b = load_png(str(port_out / f"project_{i}.png"))
        assert a.shape == b.shape == (SIZE, SIZE, 3)
