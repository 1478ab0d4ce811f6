"""The port's ``cli/export_pt.py`` and ``io/checkpoint.py::
export_reference_checkpoint`` against the JAX package's, on the CPU.

A narrow 32px model (64 wide, one attention block) in both CLIs through
their ``model_config_from_args``.  Tolerances: the exported bundle equal
to the JAX CLI's tensor for tensor (names, dtypes, values); the export
reloads into the port with ``strict=True`` and gives the source's image
exactly, and into JAX through ``load_reference_generator`` giving the
JAX image of the source within 1e-5.

One deliberate difference: the reference registers ``noises.noise_i``
buffers that the forward reads only with noise injection.  The JAX
package's parameter trees hold none, so its export writes them anew
from ``np.random.RandomState(0)``; the port copies the source's.  The
round-trip source here carries the JAX export's noise buffers, so the
two bundles can be equal, and ``test_export_keeps_the_sources_buffers``
holds the port to its own rule.
"""

import numpy as np
import pytest
import torch

import transeditor_tpu.cli.common as jax_common
from transeditor_tpu.cli import export_pt as jax_export
from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.io import checkpoint as jax_checkpoint
from transeditor_tpu.io.torch_export import generator_state_dict
from transeditor_tpu.models import Generator as JaxGenerator

from transeditor_tpu_torch.cli import export_pt
from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.io.checkpoint import save_train_state
from transeditor_tpu_torch.models.discriminator import Discriminator
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.train.gan import TrainConfig, init_state
from torch_port_threads import torch_worker_threads  # noqa: F401

TINY = dict(size=32, style_dim=64, param_dim=64, max_channels=64, n_trans=1)


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(jax_common, "model_config_from_args",
                        lambda args, **kw: JaxConfig(**TINY))
    monkeypatch.setattr(export_pt, "model_config_from_args",
                        lambda args, **kw: ModelConfig(**TINY))


def _load(path):
    return torch.load(str(path), map_location="cpu", weights_only=True)


def _assert_bundles_equal(got, want):
    assert list(got) == list(want)
    for key in want:
        assert set(got[key]) == set(want[key]), key
        for name, t in want[key].items():
            assert got[key][name].dtype == t.dtype, (key, name)
            assert torch.equal(got[key][name], t), (key, name)


def _codes(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 16, 64).astype(np.float32),
            rng.randn(2, 16, 64).astype(np.float32))


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """A reference bundle of seeded port modules whose noise buffers are
    the ones the JAX export writes."""
    cfg = ModelConfig(**TINY)
    mods = {"g": Generator(cfg, device="cpu", seed=1),
            "d": Discriminator(cfg, device="cpu", seed=2),
            "g_ema": Generator(cfg, device="cpu", seed=0)}
    bundle = {k: m.state_dict() for k, m in mods.items()}
    root = tmp_path_factory.mktemp("export")
    torch.save(bundle, root / "raw.pt")
    jcfg = JaxConfig(**TINY)
    for key in ("g", "g_ema"):
        jsd = generator_state_dict(jax_checkpoint.load_reference_generator(
            str(root / "raw.pt"), jcfg, key=key), jcfg)
        for name in bundle[key]:
            if name.startswith("noises."):
                bundle[key][name] = torch.from_numpy(jsd[name])
    torch.save(bundle, root / "in.pt")
    return root, bundle


def test_ckpt_round_trip_equals_jax(source, narrow):
    root, bundle = source
    jax_export.main(["--ckpt", str(root / "in.pt"),
                     "--out", str(root / "jax.pt")])
    export_pt.main(["--ckpt", str(root / "in.pt"),
                    "--out", str(root / "port.pt")])
    got, want = _load(root / "port.pt"), _load(root / "jax.pt")
    _assert_bundles_equal(got, want)
    _assert_bundles_equal(got, bundle)


def test_ema_only_equals_jax(source, narrow):
    root, _ = source
    jax_export.main(["--ckpt", str(root / "in.pt"), "--ema_only",
                     "--out", str(root / "jax_ema.pt")])
    export_pt.main(["--ckpt", str(root / "in.pt"), "--ema_only",
                    "--out", str(root / "port_ema.pt")])
    got = _load(root / "port_ema.pt")
    assert list(got) == ["g_ema"]
    _assert_bundles_equal(got, _load(root / "jax_ema.pt"))


def test_export_reloads_into_both_packages(source, narrow):
    root, bundle = source
    export_pt.main(["--ckpt", str(root / "in.pt"),
                    "--out", str(root / "reload.pt")])
    cfg = ModelConfig(**TINY)
    g = Generator(cfg, device="cpu", seed=5)
    g.load_state_dict(_load(root / "reload.pt")["g_ema"], strict=True)
    d = Discriminator(cfg, device="cpu", seed=5)
    d.load_state_dict(_load(root / "reload.pt")["d"], strict=True)
    ref = Generator(cfg, device="cpu", seed=5)
    ref.load_state_dict(bundle["g_ema"], strict=True)
    z, p = _codes()
    with torch.no_grad():
        got = g(torch.from_numpy(z), torch.from_numpy(p)).image
        want = ref(torch.from_numpy(z), torch.from_numpy(p)).image
    assert torch.equal(got, want)

    jcfg = JaxConfig(**TINY)
    jg = JaxGenerator(jcfg)
    img = {name: np.asarray(jg.apply(
        jax_checkpoint.load_reference_generator(str(root / name), jcfg),
        z, p).image) for name in ("reload.pt", "in.pt")}
    np.testing.assert_allclose(img["reload.pt"], img["in.pt"], atol=1e-5,
                               rtol=0)


def test_export_keeps_the_sources_buffers(source, tmp_path, narrow):
    root, _ = source
    export_pt.main(["--ckpt", str(root / "raw.pt"),
                    "--out", str(tmp_path / "raw_out.pt")])
    _assert_bundles_equal(_load(tmp_path / "raw_out.pt"),
                          _load(root / "raw.pt"))


def test_state_dir_export_equals_the_state(tmp_path, narrow):
    cfg = ModelConfig(**TINY)
    state = init_state(cfg, TrainConfig(), seed=3, device="cpu")
    with torch.no_grad():
        for t in state.g_ema.parameters():
            t.mul_(0.5)                     # g_ema apart from g
    ckpt_dir = tmp_path / "checkpoint"
    save_train_state(str(ckpt_dir), 2, state)
    state.step = 4
    save_train_state(str(ckpt_dir), 4, state)
    want = {"g": state.g.state_dict(), "d": state.d.state_dict(),
            "g_ema": state.g_ema.state_dict()}
    export_pt.main(["--state_dir", str(ckpt_dir), "--out",
                    str(tmp_path / "latest.pt")])
    _assert_bundles_equal(_load(tmp_path / "latest.pt"), want)
    export_pt.main(["--state_dir", str(ckpt_dir), "--step", "2",
                    "--ema_only", "--out", str(tmp_path / "ema.pt")])
    _assert_bundles_equal(_load(tmp_path / "ema.pt"),
                          {"g_ema": want["g_ema"]})


def test_orbax_dir_and_bad_sources_are_refused(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        export_pt.main(["--orbax_dir", str(tmp_path), "--out",
                        str(tmp_path / "x.pt")])
    with pytest.raises(SystemExit):
        export_pt.main(["--out", str(tmp_path / "x.pt")])
