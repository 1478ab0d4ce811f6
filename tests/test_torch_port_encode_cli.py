"""The port's encoder CLIs (``transeditor_tpu_torch/cli/encode.py``,
``cli/train_encoder.py``) against the JAX package's ``cli.encode``, on
the CPU in float32.

``test_encode_cli_matches_jax`` is the one test of the encoder slice at
the default size: a random pSp checkpoint (``encoder.*`` keys of the
default ``GradualStyleEncoder``, IR-SE-50 with 14 + 16 heads of 512,
364.7M parameters, and the [512, 16] plus-space latent averages) and a
64px decoder encode 3 PNGs at batch 2 (a short last batch) through both
CLIs; ``encoded_z.npy`` / ``encoded_p.npy`` agree within 1e-4 of their
largest magnitude.  The checkpoint is written once and each side loads
it itself, so the process holds about three copies of the weights at
its peak (the JAX CLI's torch load, its port and its device arrays).

``test_train_encoder_then_encode`` runs ``cli.train_encoder`` for 2 steps
on ``--device cpu`` and feeds its ``best_model.pt`` to ``cli.encode``.
Training the default encoder would hold its weights, gradients and two
Ranger moments (5.8 GB) and write a 4.4 GB checkpoint, so this run trains
the reduced encoder of ``torch_port_encoder_oracle`` under a decoder of
its width: the names ``train/coach.py`` and the two CLIs look up for the
encoder and the model config are swapped for the test's.
"""

import functools
import os

import numpy as np
import pytest
import torch

from transeditor_tpu.cli.encode import main as jax_encode

import torch_port_encoder_oracle as orc
from transeditor_tpu_torch.cli import encode as cli_encode
from transeditor_tpu_torch.cli import train_encoder as cli_train
from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.io.checkpoint import load_coach_bundle
from transeditor_tpu_torch.models import psp as tp
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.train import coach as tc
from transeditor_tpu_torch.utils.image import load_png, save_png

SIZE = 64
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with orc.worker_threads():
        yield


def _pngs(root, n, seed):
    root.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n):
        save_png(str(root / f"{i:03d}.png"),
                 rng.randint(0, 256, (SIZE, SIZE, 3), dtype=np.uint8))
    return str(root)


def _decoder_pt(path, **cfg_kw):
    g = Generator(ModelConfig(size=SIZE, n_trans=1, **cfg_kw), device="cpu")
    torch.save({"g_ema": g.state_dict()}, path)
    return str(path)


@pytest.fixture(scope="module")
def psp_pt(tmp_path_factory):
    """A reference-layout pSp checkpoint at the default size."""
    sd = orc.psp_encoder_sd(0)
    rng = np.random.default_rng(1)
    ckpt = {"state_dict": {f"encoder.{k}": torch.from_numpy(v)
                           for k, v in sd.items()},
            "z_plus_latent_avg": torch.from_numpy(
                rng.standard_normal((512, 16), np.float32)),
            "p_plus_latent_avg": torch.from_numpy(
                rng.standard_normal((512, 16), np.float32))}
    path = tmp_path_factory.mktemp("psp") / "psp.pt"
    torch.save(ckpt, path)
    return str(path)


def test_encode_cli_matches_jax(psp_pt, tmp_path):
    data = _pngs(tmp_path / "imgs", 3, seed=2)
    dec = _decoder_pt(tmp_path / "g.pt")
    common = ["--decoder_ckpt", dec, "--encoder_ckpt", psp_pt,
              "--data_dir", data, "--size", str(SIZE), "--num_trans", "1",
              "--batch", "2"]
    jax_encode(common + ["--out_dir", str(tmp_path / "jax")])
    cli_encode.main(common + ["--out_dir", str(tmp_path / "port"),
                              "--device", "cpu", "--save_inversions"])
    for name in ("encoded_z.npy", "encoded_p.npy"):
        want = np.load(tmp_path / "jax" / name)
        got = np.load(tmp_path / "port" / name)
        assert got.shape == (3, 16, 512) and got.dtype == np.float32
        orc.assert_close(got, want, REL, name)
    for i in range(3):
        img = load_png(str(tmp_path / "port" / f"inversion_{i}.png"))
        assert img.shape == (SIZE, SIZE, 3)


def test_encode_reads_no_orbax_directory(tmp_path):
    (tmp_path / "best_model").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        cli_encode.load_encoder(str(tmp_path / "best_model"))


def test_train_encoder_then_encode(tmp_path, monkeypatch):
    width = dict(style_dim=orc.HEAD, param_dim=orc.HEAD)
    monkeypatch.setattr(tc, "GradualStyleEncoder", functools.partial(
        tp.GradualStyleEncoder, head_channels=orc.HEAD, **orc.REDUCED))
    for cli in (cli_train, cli_encode):
        build = cli.model_config_from_args
        monkeypatch.setattr(cli, "model_config_from_args",
                            lambda args, build=build: build(args, **width))
    train = _pngs(tmp_path / "train", 4, seed=3)
    val = _pngs(tmp_path / "val", 3, seed=4)
    dec = _decoder_pt(tmp_path / "g.pt", **width)
    exp = tmp_path / "exp"
    model = ["--size", str(SIZE), "--num_trans", "1", "--device", "cpu"]
    with pytest.warns(UserWarning) as warned:
        cli_train.main(["--ckpt", dec, "--dataset_dir", train,
                        "--test_dataset_dir", val, "--exp_dir", str(exp),
                        "--max_steps", "3", "--batch_size", "2",
                        "--val_interval", "2", "--save_interval", "2",
                        "--use_fake_lambda", "0.5", "--fake_every", "2",
                        *model])
    said = " ".join(str(w.message) for w in warned)
    assert "LPIPS" in said and "--arcface" in said
    assert sorted(os.listdir(exp)) == ["best_model.pt", "ckpt_000002.pt",
                                       "logs", "val_000000.png",
                                       "val_000002.png"]
    # the last validation batch (1 image) over its inversion
    grid = load_png(str(exp / "val_000000.png"))
    assert grid.shape == (SIZE + 4, 4 * SIZE + 10, 3)
    ckpt = load_coach_bundle(str(exp / "ckpt_000002.pt"))
    assert ckpt["step"] == 3
    lines = (exp / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3          # step 0's losses, two val_loss lines

    out = tmp_path / "enc"
    cli_encode.main(["--decoder_ckpt", dec, "--encoder_ckpt",
                     str(exp / "best_model.pt"), "--data_dir", val,
                     "--out_dir", str(out), "--batch", "2", *model])
    z = np.load(out / "encoded_z.npy")
    assert z.shape == (3, 16, orc.HEAD) and np.isfinite(z).all()
