"""The port's paired folder metrics (``transeditor_tpu_torch/metrics/
paired.py``) and ``cli.img_metrics`` against the JAX package's, on the
CPU in float32.

Both CLIs score the same result / ground-truth PNG folders, in all three
modes, from the same weight files (a random richzhang AlexNet LPIPS, a
random IR-SE-50 ArcFace): the same report files
(``<data_path>/../inference_metrics/stat_{mode}.txt`` and
``scores_{mode}.json``), the same text, scores within ``SCORE_REL`` of
the largest.  Some ground truths are 300px and some 200px, so both
packages resize them with PIL's BILINEAR filter (the port's
``resize_bilinear``, byte for byte), and the batch of 2 leaves a padded
tail.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from transeditor_tpu.cli.img_metrics import main as jax_img_metrics
from transeditor_tpu.metrics import paired as jpaired

import torch_port_encoder_oracle as orc
import torch_port_metrics_oracle as mo
from transeditor_tpu_torch.cli import img_metrics
from transeditor_tpu_torch.metrics import paired as tpaired
from transeditor_tpu_torch.utils.image import resize_bilinear, save_png

SCORE_REL = 1e-4
RES = 256
GT_SIZES = (300, 256, 200)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with orc.worker_threads():
        yield


def _smooth(rng, size):
    """A smooth random image (low-frequency noise upscaled)."""
    small = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    return np.asarray(Image.fromarray(small).resize((size, size),
                                                    Image.BICUBIC))


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("paired")
    res, gt = root / "results", root / "gt"
    res.mkdir()
    gt.mkdir()
    rng = np.random.default_rng(0)
    for i, size in enumerate(GT_SIZES):
        base = _smooth(rng, RES).astype(np.int16)
        noisy = np.clip(base + rng.integers(-30, 31, base.shape), 0, 255)
        save_png(str(res / f"{i:05d}.png"), noisy.astype(np.uint8))
        save_png(str(gt / f"{i:05d}.png"), np.asarray(
            Image.fromarray(base.astype(np.uint8)).resize((size, size),
                                                          Image.BICUBIC)))
    return {"root": root, "res": str(res), "gt": str(gt),
            "alex": mo.save_sd(root / "alex.pth", mo.lpips_sd("alex", 1)),
            "arcface": mo.save_sd(root / "ir_se50.pth", orc.arcface_sd(2))}


@pytest.mark.parametrize("mode", ["l2", "lpips", "id"])
def test_img_metrics_matches_the_jax_cli(folders, tmp_path, mode):
    extra = {"l2": [], "lpips": ["--lpips_weights", folders["alex"]],
             "id": ["--arcface", folders["arcface"], "--arcface_depth", "50",
                    "--arcface_mode", "ir_se"]}[mode]
    reports = {}
    for name, main in (("jax", jax_img_metrics), ("port", img_metrics.main)):
        out = tmp_path / name
        argv = ["--mode", mode, "--data_path", folders["res"], "--gt_path",
                folders["gt"], "--batch_size", "2", "--out", str(out),
                *extra]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        reports[name] = {f: (out / f).read_text()
                         for f in sorted(os.listdir(out))}
    got, want = reports["port"], reports["jax"]
    assert list(got) == list(want) == [f"scores_{mode}.json",
                                       f"stat_{mode}.txt"]
    assert got[f"stat_{mode}.txt"] == want[f"stat_{mode}.txt"]
    gs, ws = (json.loads(r[f"scores_{mode}.json"]) for r in (got, want))
    assert list(gs) == list(ws) == [f"{i:05d}.png" for i in range(3)]
    top = max(abs(v) for v in ws.values())
    assert max(abs(gs[k] - ws[k]) for k in ws) <= SCORE_REL * top


def test_default_report_dir_is_beside_the_results(folders, capsys):
    img_metrics.main(["--mode", "l2", "--data_path", folders["res"],
                      "--gt_path", folders["gt"], "--device", "cpu"])
    out = folders["root"] / "inference_metrics"
    assert sorted(os.listdir(out)) == ["scores_l2.json", "stat_l2.txt"]
    assert f"-> {out}" in capsys.readouterr().out


def test_load_pair_batch_resizes_as_pil_bilinear(folders):
    pairs = tpaired.pair_folders(folders["res"], folders["gt"])
    got = tpaired.load_pair_batch(pairs, RES)
    want = jpaired.load_pair_batch(pairs, RES)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,out", [
    ((300, 300), (256, 256)), ((200, 200), (256, 256)),
    ((1024, 1024), (256, 256)), ((37, 53), (64, 20)),
    ((256, 128), (100, 300))],
    ids=["300-256", "200-256", "1024-256", "odd", "non-square"])
def test_resize_bilinear_equals_pil(shape, out):
    img = np.random.RandomState(3).randint(0, 256, (*shape, 3)).astype(
        np.uint8)
    want = np.asarray(Image.fromarray(img).resize((out[1], out[0]),
                                                  Image.BILINEAR))
    got = resize_bilinear(img, out[1], out[0])
    np.testing.assert_array_equal(got, want)


def _touch(d, *names):
    d.mkdir(exist_ok=True)
    for n in names:
        (d / n).write_bytes(b"")


def test_pair_folders_falls_back_across_extensions_as_jax(tmp_path):
    _touch(tmp_path / "r", "a.png", "b.png", "c.jpg", "notes.txt", "d.webp")
    _touch(tmp_path / "g", "a.png", "b.jpg", "c.jpeg", "d.png")
    got = tpaired.pair_folders(str(tmp_path / "r"), str(tmp_path / "g"))
    assert got == jpaired.pair_folders(str(tmp_path / "r"),
                                       str(tmp_path / "g"))
    assert [os.path.basename(g) for _, g in got] == ["a.png", "b.jpg",
                                                     "c.jpeg", "d.png"]


def test_pair_folders_errors_as_jax(tmp_path):
    _touch(tmp_path / "r", "a.png")
    _touch(tmp_path / "g", "b.png")
    _touch(tmp_path / "empty", "x.txt")
    for mod in (jpaired, tpaired):
        with pytest.raises(FileNotFoundError, match="no ground-truth match "
                                                    "for a.png"):
            mod.pair_folders(str(tmp_path / "r"), str(tmp_path / "g"))
        with pytest.raises(ValueError, match="no images under"):
            mod.pair_folders(str(tmp_path / "empty"), str(tmp_path / "g"))


def test_unread_formats_raise_naming_the_file(tmp_path):
    """The port pairs ``.webp`` as JAX does and reads it now, equal to the
    JAX package's PIL read (12px, resized to 8); a file cut short raises
    naming it."""
    (tmp_path / "r").mkdir()
    (tmp_path / "g").mkdir()
    rng = np.random.RandomState(5)
    Image.fromarray(rng.randint(0, 256, (12, 12, 3)).astype(np.uint8)).save(
        tmp_path / "r" / "a.webp", quality=80)
    save_png(str(tmp_path / "g" / "a.png"), np.zeros((8, 8, 3), np.uint8))
    pairs = tpaired.pair_folders(str(tmp_path / "r"), str(tmp_path / "g"))
    got = tpaired.load_pair_batch(pairs, 8)
    want = jpaired.load_pair_batch(pairs, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    data = (tmp_path / "r" / "a.webp").read_bytes()
    (tmp_path / "r" / "a.webp").write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="a.webp"):
        tpaired.load_pair_batch(pairs, 8)


def test_bmp_pairs_load_as_the_jax_package(tmp_path):
    """A ``.bmp`` result (24-bit, 12px, resized to 8) against a ``.png``
    ground truth: both packages load the same arrays."""
    (tmp_path / "r").mkdir()
    (tmp_path / "g").mkdir()
    rng = np.random.RandomState(4)
    Image.fromarray(rng.randint(0, 256, (12, 12, 3)).astype(np.uint8)).save(
        tmp_path / "r" / "a.bmp")
    save_png(str(tmp_path / "g" / "a.png"),
             rng.randint(0, 256, (8, 8, 3)).astype(np.uint8))
    pairs = tpaired.pair_folders(str(tmp_path / "r"), str(tmp_path / "g"))
    got = tpaired.load_pair_batch(pairs, 8)
    want = jpaired.load_pair_batch(pairs, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_id_mode_needs_arcface_and_paired_scores_need_a_card(folders,
                                                             monkeypatch):
    for main in (jax_img_metrics, img_metrics.main):
        with pytest.raises(SystemExit, match="requires --arcface"):
            main(["--mode", "id", "--data_path", folders["res"],
                  "--gt_path", folders["gt"]]
                 + (["--device", "cpu"] if main is img_metrics.main else []))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pairs = tpaired.pair_folders(folders["res"], folders["gt"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpaired.paired_scores(tpaired.make_l2_fn(), pairs)
