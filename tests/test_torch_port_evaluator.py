"""The port's FID and PRDC protocols (``transeditor_tpu_torch/metrics/
evaluator.py``: ``evaluate_fid``, ``real_stats_from_source``,
``evaluate_prdc``) against the JAX package's, on the CPU in float32, each
with the JAX package's draws (``draws=``).

A 32px generator holds the same weights in both packages; the
InceptionV3 and VGG16 are random reference-layout state dicts at their
default widths.  ``evaluate_fid``'s Fréchet distance is a 2,048-wide
``sqrtm`` (about 10 s on this CPU), so both packages' ``frechet_distance``
is replaced by a recorder here: the statistics it is handed are held
(``STATS_REL`` of the largest), and ``test_torch_port_fid_prdc.py`` holds
the distance itself to 1e-10.  The real folder holds PNGs of the same
generator's images for other codes, so PRDC's balls overlap; its four
values are held equal.
"""

import numpy as np
import pytest
import torch

from transeditor_tpu.data.dataset import ImageFolderSource as JaxFolder
from transeditor_tpu.metrics import evaluator as jev
from transeditor_tpu.metrics import inception as ji
from transeditor_tpu.zoo import backbones as jb

import torch_port_metrics_oracle as mo
from torch_port_encoder_oracle import worker_threads
from transeditor_tpu_torch.data.dataset import ImageFolderSource
from transeditor_tpu_torch.metrics import evaluator as tev
from transeditor_tpu_torch.metrics import inception as ti
from transeditor_tpu_torch.utils.image import save_png, to_uint8
from transeditor_tpu_torch.zoo.backbones import load_vgg16_fc7

TINY = dict(size=32, style_dim=32, param_dim=32, max_channels=32, n_trans=1)
STATS_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with worker_threads():
        yield


@pytest.fixture(scope="module")
def nets():
    jcfg, params, g = mo.generator_pair(0, **TINY)
    sd = mo.fid_inception_sd(1)
    return jcfg, params, g, ji.port_fid_inception_weights(sd), \
        ti.load_fid_inception(mo.torch_sd(sd))


@pytest.fixture(scope="module")
def real_dir(nets, tmp_path_factory):
    """20 PNGs of the generator's own images for seeded codes."""
    g = nets[2]
    root = tmp_path_factory.mktemp("real")
    rng = np.random.default_rng(7)
    z, p = (torch.from_numpy(rng.standard_normal((20, 16, 32)).astype(
        np.float32)) for _ in range(2))
    with torch.no_grad():
        img = g(z, p).image.numpy()
    for i, im in enumerate(to_uint8(img)):
        save_png(str(root / f"{i:03d}.png"), im)
    return root


def _recording(monkeypatch):
    seen = {}
    for tag, mod in (("jax", jev), ("port", tev)):
        def rec(m, c, rm, rc, tag=tag):
            seen[tag] = (m, c)
            return float(len(seen))
        monkeypatch.setattr(mod, "frechet_distance", rec)
    return seen


def test_evaluate_fid_streams_the_jax_statistics(nets, monkeypatch):
    """24 samples at batch 16: the second batch's surplus 8 rows dropped."""
    jcfg, params, g, jvars, inc = nets
    seen = _recording(monkeypatch)
    real = (np.zeros(2048), np.eye(2048))
    jev.evaluate_fid(jcfg, params, jvars, *real, n_samples=24, batch=16,
                     seed=3)
    draws = mo.fid_draws(2, 16, 16, 32, 32, seed=3)
    calls = []
    orig = inc.forward
    inc.forward = lambda x: calls.append(x.shape) or orig(x)
    try:
        out = tev.evaluate_fid(g, inc, *real, n_samples=24, batch=16,
                               draws=draws)
    finally:
        del inc.forward
    assert out == 2.0                      # what frechet_distance returned
    assert calls == [(16, 32, 32, 3)] * 2
    for got, want in zip(seen["port"], seen["jax"]):
        assert got.dtype == np.float64 and got.shape == want.shape
        assert mo.rel_err(got, want) <= STATS_REL


def test_evaluate_fid_draws_from_a_seeded_generator(nets, monkeypatch):
    *_, g, _, inc = nets
    seen = _recording(monkeypatch)
    real = (np.zeros(2048), np.eye(2048))
    tev.evaluate_fid(g, inc, *real, n_samples=3, batch=2, seed=5)
    first = seen.pop("port")
    tev.evaluate_fid(g, inc, *real, n_samples=3, batch=2, seed=5)
    np.testing.assert_array_equal(seen["port"][0], first[0])
    tev.evaluate_fid(g, inc, *real, n_samples=3, batch=2, seed=6)
    assert not np.array_equal(seen["port"][0], first[0])


def test_real_stats_from_a_png_folder(nets, real_dir):
    *_, jvars, inc = nets
    want = jev.real_stats_from_source(JaxFolder(str(real_dir)), jvars, 32,
                                      n_samples=18, batch=8)
    got = tev.real_stats_from_source(ImageFolderSource(str(real_dir)), inc,
                                     32, n_samples=18, batch=8)
    for a, b in zip(got, want):
        assert mo.rel_err(a, b) <= STATS_REL


def test_evaluate_prdc_on_a_png_folder(nets, real_dir):
    jcfg, params, g, *_ = nets
    sd = mo.vgg16_sd(2)
    want = jev.evaluate_prdc(jcfg, params, jb.port_vgg16_fc7(sd),
                             JaxFolder(str(real_dir)), n_samples=20,
                             batch=8, seed=1)
    got = tev.evaluate_prdc(g, load_vgg16_fc7(mo.torch_sd(sd)),
                            ImageFolderSource(str(real_dir)), n_samples=20,
                            batch=8, draws=mo.fid_draws(3, 8, 16, 32, 32,
                                                        seed=1))
    assert got == want
    assert 0 < got["precision"] and 0 < got["coverage"]


class _NoiseFolder:
    """``n`` seeded uint8 images, by the ``get(i, size)`` of a source."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i, size):
        return np.random.default_rng(i).integers(
            0, 256, (size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("protocol", ["fid", "diversity", "prdc"])
def test_seeded_draws_take_p_at_param_dim(protocol, monkeypatch):
    """With ``param_dim`` != ``style_dim``, every seeded protocol draws Z
    at ``style_dim`` and P at ``param_dim``, as the JAX package's do."""
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.models.generator import Generator

    cfg = ModelConfig(**{**TINY, "param_dim": 16})
    g = Generator(cfg, device="cpu", seed=0).eval()
    widths = []
    forward = g.forward

    def spy(z, p, *a, **kw):
        widths.append((z.shape[-1], p.shape[-1]))
        return forward(z, p, *a, **kw)

    monkeypatch.setattr(g, "forward", spy)

    def pooled(img):
        return img.mean(dim=(1, 2))

    if protocol == "fid":
        out = [tev.evaluate_fid(g, pooled, np.zeros(3), np.eye(3),
                                n_samples=6, batch=4, seed=1)]
    elif protocol == "diversity":
        out = tev.evaluate_lpips_diversity(
            g, lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3)), n_images=4,
            n_batches=1, seed=1).values()
    else:
        out = tev.evaluate_prdc(g, pooled, _NoiseFolder(8), n_samples=8,
                                batch=4, seed=1).values()
    assert widths and set(widths) == {(32, 16)}
    assert all(np.isfinite(v) for v in out)


# ------------------------------------------- mesh=: two gloo processes

@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    """Both ranks' ``eval`` case of ``tests/torch_port_mesh_worker.py``
    (one spawn of 2 gloo processes for the module)."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path_factory.mktemp("mesh_eval")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "tests",
                                      "torch_port_mesh_worker.py"),
         str(out), "cpu", "eval"],
        env=dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                 OMP_NUM_THREADS="1", PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)["eval"]
            for r in range(2)]


@pytest.fixture(scope="module")
def one_process_eval():
    import torch_port_mesh_worker as mw
    return mw.eval_case("cpu")


@pytest.mark.parametrize("protocol", ["fid", "prdc", "lpips"])
def test_mesh_on_two_ranks_equals_one_process(mesh_ranks, one_process_eval,
                                              protocol):
    """``evaluate_fid`` / ``evaluate_prdc`` / ``evaluate_lpips_diversity``
    with ``mesh=`` on 2 ranks (each decodes and scores its rows; the
    features or distances gathered in row order): every rank's value is
    the one-process value within 1e-5 relative (``mw.check_eval``)."""
    import torch_port_mesh_worker as mw

    for got in mesh_ranks:
        mw.check_eval(got, one_process_eval, (protocol,))
