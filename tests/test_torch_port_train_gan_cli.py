"""The port's command-line entry points against the JAX package's, on
the CPU: ``cli/train_gan.py`` (flags and configs, a tiny two-step run
from an LMDB and its resume) and ``cli/prepare_data.py`` (the same LMDB
layout, images within 40 dB PSNR of the JAX CLI's: the port encodes
with its own JPEG codec and resizes in numpy, the JAX CLI through
PIL)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import transeditor_tpu.cli.prepare_data as jax_prepare
import transeditor_tpu.cli.train_gan as jax_cli

from torch_port_encoder_oracle import worker_threads
from transeditor_tpu_torch.cli import prepare_data, train_gan
from transeditor_tpu_torch.data.native import NativeLMDB, decode_jpeg
from transeditor_tpu_torch.io.checkpoint import checkpoint_steps
from transeditor_tpu_torch.utils.image import save_png

ARGV_SETS = [
    [],
    ["--batch", "8", "--iter", "1000", "--lr", "0.001", "--r1", "5",
     "--d_reg_every", "8", "--g_reg_every", "2", "--spatial_regu",
     "--regu_space", "p", "--seed", "3", "--size", "64",
     "--channel_multiplier", "1", "--num_trans", "2", "--dtype",
     "bfloat16"],
    ["--grad_accum", "2", "--path_batch_shrink", "4", "--n_sample", "16",
     "--path_regularize", "1.5", "--spatial_path_regularize", "0.5",
     "--no_spatial_map", "--pixel_norm_op_dim", "2", "--inject_noise",
     "--para_num", "16", "--num_region", "2", "--no_trans"],
]
TINY = ["--size", "16", "--num_trans", "1", "--batch", "4",
        "--d_reg_every", "2", "--g_reg_every", "2", "--n_sample", "4",
        "--log_every", "1", "--device", "cpu"]


def _smooth(n, size, seed=0):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(n):
        a, b = rng.uniform(0.5, 2.0, 2)
        img = np.stack([np.sin(a * 6.3 * x), np.cos(b * 6.3 * y),
                        np.sin(3.0 * (x + y))], -1)
        out.append(((img + 1) * 127.5).round().astype(np.uint8))
    return out


@pytest.fixture
def png_folder(tmp_path):
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i, img in enumerate(_smooth(8, 40)):
        save_png(str(folder / f"{i:03d}.png"), img)
    return folder


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("argv", ARGV_SETS, ids=["defaults", "train-flags",
                                                 "model-flags"])
def test_build_configs_equal_the_jax_cli(argv, png_folder, monkeypatch):
    seen = {}

    def capture(cfg, tcfg, data, **kw):
        seen.update(cfg=cfg, tcfg=tcfg)
    monkeypatch.setattr(jax_cli, "train", capture)
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    jax_cli.main([str(png_folder), *argv])
    cfg, tcfg = train_gan.build_configs(
        train_gan.parser().parse_args([str(png_folder), *argv]))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(seen["cfg"])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(seen["tcfg"])


def test_two_steps_then_resume(png_folder, tmp_path, capsys):
    db = str(tmp_path / "db")
    assert prepare_data.main(["--in_dir", str(png_folder), "--out", db,
                              "--size", "16"]) == 8
    run = ["--out_dir", str(tmp_path / "out"), "--exp_name", "r", *TINY]
    state = train_gan.main([db, "--iter", "2", *run])
    assert state.step == 2
    state = train_gan.main([db, "--iter", "4", "--resume",
                            str(tmp_path / "out" / "r" / "checkpoint"),
                            *run])
    assert state.step == 4                     # restored 2, then 2 more
    assert "resumed from step 1 -> continuing at 2" in capsys.readouterr().out
    out = tmp_path / "out" / "r"
    lines = [json.loads(s) for s in
             (out / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1, 2, 3]
    for r in lines:
        assert all(np.isfinite(v) for v in r.values()), r
        assert 0 <= r["data_wait_share"] < 1
    # R1 and path length every 2 steps, counted from step 0 across resume
    assert [r["r1"] > 0 for r in lines] == [True, False, True, False]
    assert [r["path_length"] > 0 for r in lines] == [True, False, True,
                                                     False]
    # the cadence's step 0 and each run's last step
    assert checkpoint_steps(str(out / "checkpoint")) == [0, 1, 3]
    assert sorted(os.listdir(out / "sample")) == ["000000.png"]


def test_image_folder_training_without_lmdb(png_folder, tmp_path):
    state = train_gan.main([str(png_folder), "--iter", "1", "--out_dir",
                            str(tmp_path / "out"), *TINY])
    assert state.step == 1


def test_prepare_data_matches_the_jax_cli(png_folder, tmp_path):
    jax_prepare.main(["--in_dir", str(png_folder), "--out",
                      str(tmp_path / "jax"), "--size", "32"])
    prepare_data.main(["--in_dir", str(png_folder), "--out",
                       str(tmp_path / "port"), "--size", "32"])
    want, got = NativeLMDB(str(tmp_path / "jax")), NativeLMDB(
        str(tmp_path / "port"))
    try:
        assert len(got) == len(want) == 8
        assert got.entries == want.entries == 9
        assert got.get(b"length") == want.get(b"length") == b"8"
        worst = min(
            _psnr(decode_jpeg(got.get(f"32-{i:05d}".encode()), 32, 32),
                  decode_jpeg(want.get(f"32-{i:05d}".encode()), 32, 32))
            for i in range(8))
        assert worst >= 40.0, worst
    finally:
        got.close()
        want.close()


def test_main_runs_on_cuda_unless_told(png_folder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_gan.main([str(png_folder), "--iter", "1"])


def test_fsdp_is_not_ported(png_folder, tmp_path):
    """``--fsdp`` is ported now (``parallel/mesh.py``): in one process it
    trains, and its checkpoint equals the run without it, bit for bit
    (JAX shards only on a data axis of more than one device)."""
    files = []
    for flags in ([], ["--fsdp"]):
        out = tmp_path / ("fsdp" if flags else "plain")
        with worker_threads():
            state = train_gan.main([str(png_folder), "--iter", "2",
                                    "--out_dir", str(out), *TINY, *flags])
        assert state.step == 2 and state.sharding is None
        files.append(torch.load(out / "test" / "checkpoint" / "000001.pt",
                                weights_only=True))
    for tag in ("g", "d", "g_ema"):
        for k, v in files[0][tag].items():
            assert torch.equal(v, files[1][tag][k]), (tag, k)
    for tag in ("g_optim", "d_optim"):
        for i, st in files[0][tag]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, files[1][tag]["state"][i][k]), (tag, k)
