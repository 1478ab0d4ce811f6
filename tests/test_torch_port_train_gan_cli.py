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

from transeditor_tpu_torch.cli import prepare_data, train_gan
from transeditor_tpu_torch.data.native import NativeLMDB, decode_jpeg
from transeditor_tpu_torch.io.checkpoint import (checkpoint_steps,
                                                  load_train_state_bundle,
                                                  restore_train_state)
from transeditor_tpu_torch.train.gan import init_state
from transeditor_tpu_torch.utils.image import save_png
from torch_port_disk import small_tmp_path  # noqa: F401
from torch_port_threads import torch_worker_threads  # noqa: F401

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


def test_two_steps_then_resume(png_folder, small_tmp_path, capsys):
    _two_steps_then_resume(png_folder, small_tmp_path, capsys)


def _two_steps_then_resume(png_folder, tmp_path, capsys, *flags):
    """Two steps of ``TINY`` from an LMDB, then ``--resume`` for two
    more; returns the resumed run's state."""
    db = str(tmp_path / "db")
    assert prepare_data.main(["--in_dir", str(png_folder), "--out", db,
                              "--size", "16"]) == 8
    run = ["--out_dir", str(tmp_path / "out"), "--exp_name", "r", *TINY,
           *flags]
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
    return state


def test_bf16_two_steps_then_resume(png_folder, small_tmp_path, capsys):
    """``--dtype bfloat16``: the same two steps and resume, computing in
    bfloat16 (R1 and path length at step 0 and 2)."""
    state = _two_steps_then_resume(png_folder, small_tmp_path, capsys,
                                   "--dtype", "bfloat16")
    assert state.g.cfg.compute_dtype == torch.bfloat16
    assert state.d.cfg.compute_dtype == torch.bfloat16


def _floats(tree, path=()):
    """(path, tensor) of every floating tensor in a nested bundle."""
    if torch.is_tensor(tree):
        if tree.is_floating_point():
            yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _floats(v, (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _floats(v, (*path, i))


def test_bf16_state_is_written_and_read_back_in_float32(png_folder,
                                                        small_tmp_path):
    """A ``--dtype bfloat16`` run keeps its state in float32, as flax
    keeps its parameters: the checkpoint's weights, g_ema, Adam moments
    and path-length means are float32, and ``restore_train_state`` reads
    them into a bfloat16-computing state unchanged, in float32."""
    out = small_tmp_path / "out"
    argv = [str(png_folder), "--iter", "2", "--out_dir", str(out),
            "--dtype", "bfloat16", *TINY]
    state = train_gan.main(argv)
    bundle, step = load_train_state_bundle(str(out / "test" / "checkpoint"))
    assert step == 1
    floats = dict(_floats(bundle))
    assert {p[0] for p in floats} == {"g", "d", "g_ema", "g_optim",
                                      "d_optim", "mean_path_length",
                                      "mean_spatial_path_length"}
    wrong = {p: t.dtype for p, t in floats.items()
             if t.dtype != torch.float32}
    assert not wrong, wrong
    moments = [p for p in floats if p[-1] in ("exp_avg", "exp_avg_sq")]
    assert moments
    for tag, module in (("g", state.g), ("d", state.d),
                        ("g_ema", state.g_ema)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, bundle[tag][k]), (tag, k)
    cfg, tcfg = train_gan.build_configs(train_gan.parser().parse_args(
        argv))
    assert cfg.dtype == "bfloat16"
    fresh, _ = restore_train_state(
        str(out / "test" / "checkpoint"),
        init_state(cfg, tcfg, seed=tcfg.seed + 1, device="cpu"))
    for tag, module in (("g", fresh.g), ("d", fresh.d),
                        ("g_ema", fresh.g_ema)):
        for k, v in module.state_dict().items():
            assert v.dtype == bundle[tag][k].dtype, (tag, k)
            assert torch.equal(v, bundle[tag][k]), (tag, k)
    for tag, opt, module in (("g_optim", fresh.opt_g, fresh.g),
                             ("d_optim", fresh.opt_d, fresh.d)):
        saved = bundle[tag]["state"]
        for i, p in enumerate(module.parameters()):
            assert p.dtype == torch.float32
            for k in ("exp_avg", "exp_avg_sq"):
                got = opt.state[p][k]
                assert got.dtype == torch.float32, (tag, i, k)
                assert torch.equal(got, saved[i][k]), (tag, i, k)
    assert fresh.mean_path_length.dtype == torch.float32
    assert float(fresh.mean_path_length) == float(
        state.mean_path_length) > 0


def test_image_folder_training_without_lmdb(png_folder, small_tmp_path):
    state = train_gan.main([str(png_folder), "--iter", "1", "--out_dir",
                            str(small_tmp_path / "out"), *TINY])
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


def test_fsdp_trains_and_equals_the_run_without_it(png_folder,
                                                   small_tmp_path):
    """``--fsdp`` in one process trains, and its checkpoint equals the
    run without it, bit for bit (JAX shards only on a data axis of more
    than one device, and so does the port: ``parallel/mesh.py``)."""
    files = []
    for flags in ([], ["--fsdp"]):
        out = small_tmp_path / ("fsdp" if flags else "plain")
        state = train_gan.main([str(png_folder), "--iter", "2",
                                "--out_dir", str(out), *TINY, *flags])
        assert state.step == 2 and state.sharding is None
        files.append(torch.load(out / "test" / "checkpoint" /
                                "000001.pt", weights_only=True))
    for tag in ("g", "d", "g_ema"):
        for k, v in files[0][tag].items():
            assert torch.equal(v, files[1][tag][k]), (tag, k)
    for tag in ("g_optim", "d_optim"):
        for i, st in files[0][tag]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, files[1][tag]["state"][i][k]), \
                    (tag, k)
