"""The port's editing CLIs (``transeditor_tpu_torch/cli/edit.py``,
``cli/edit_eval.py``) against the JAX package's, on the CPU in float32.

A 16px generator at the CLIs' 512 width (one interaction block) is saved
as a reference ``.pt`` bundle that both CLIs load.  The inversion variant
(``--encoded_z/--encoded_p``, the boundaries cached as ``.npy`` in both
output folders, a random ClassifyModel pose checkpoint) writes the same
file tree in both packages; frames agree within one uint8 level (images
within 5e-4 before rounding) and frame names where JAX's pose score is
not within ``SCORE_ATOL`` of 0.5.  ``cli.edit_eval`` reads JAX's strips
in both packages with the pose and a narrowed CelebA-HQ classifier and
``--boundaries``: the JSON reports agree within ``SCORE_ATOL`` (scores)
and 1e-5 (cosines).  ``--arcface`` runs on 224px strips written by the
test (the ArcFace crop needs 224px): ID similarities within 1e-4;
``--id_inception`` reads one random pytorch-fid InceptionV3 checkpoint
in both: InceptionV3 ID similarities within 1e-5.  The
sampled variant draws with ``jax.random`` in JAX and a
``torch.Generator`` in the port, and without ``--classifier_ckpt`` the
random classifiers differ too, so there only the file tree is compared,
scores left out of the names.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from transeditor_tpu.cli.edit import main as jax_edit
from transeditor_tpu.cli.edit_eval import main as jax_edit_eval

import torch_port_disk as disk
import torch_port_edit_oracle as eo
import torch_port_encoder_oracle as orc
import torch_port_metrics_oracle as mo
from transeditor_tpu_torch.cli import edit as cli_edit
from transeditor_tpu_torch.cli import edit_eval as cli_eval
from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.utils.image import load_png, save_png
from torch_port_disk import small_tmp_path  # noqa: F401
from torch_port_threads import torch_worker_threads  # noqa: F401

SIZE = 16
MODEL = ["--size", str(SIZE), "--num_trans", "1", "--dtype", "float32"]
SCORE_ATOL = 1e-3
_SCORE_RE = re.compile(r"_(-?\d+)\.png$")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("edit_assets")
    g = Generator(ModelConfig(size=SIZE, n_trans=1), device="cpu", seed=3)
    torch.save({"g_ema": g.state_dict()}, root / "g.pt")
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 16, 512)).astype(np.float32)
    p = rng.standard_normal((2, 16, 512)).astype(np.float32)
    np.save(root / "encoded_z.npy", z)
    np.save(root / "encoded_p.npy", p)
    bounds = {}
    for k in ("z", "p"):
        b = rng.standard_normal((1, 16 * 512)).astype(np.float32)
        bounds[k] = b / np.linalg.norm(b)
    with eo.narrow_celebahq():
        celeb = eo.save_sd(root / "smiling.pth", eo.celebahq_sd(1))
    yield {"g": str(root / "g.pt"), "z": str(root / "encoded_z.npy"),
           "p": str(root / "encoded_p.npy"), "bounds": bounds,
           "pose": eo.save_sd(root / "pose.pth", eo.pose_sd(2)),
           "smiling": celeb}
    disk.tidy(root)


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            out[rel] = os.path.join(dirpath, f)
    return out


def _unscored(names):
    return sorted(_SCORE_RE.sub("_S.png", n) if "_edit_" in n else n
                  for n in names)


@pytest.fixture(scope="module")
def inversion_runs(assets, tmp_path_factory):
    """Both CLIs' inversion variant, from cached boundaries."""
    outs = {}
    for name, run in (("jax", jax_edit), ("port", cli_edit.main)):
        out = tmp_path_factory.mktemp(f"edit_{name}")
        np.save(out / "boundary_pose_z.npy", assets["bounds"]["z"])
        np.save(out / "boundary_pose_p.npy", assets["bounds"]["p"])
        argv = ["--ckpt", assets["g"], "--attribute", "pose",
                "--classifier_ckpt", assets["pose"], "--steps", "5",
                "--n_edit_samples", "2", "--encoded_z", assets["z"],
                "--encoded_p", assets["p"], "--out_dir", str(out), *MODEL]
        run(argv + (["--device", "cpu"] if name == "port" else []))
        outs[name] = out
    return outs


def test_edit_cli_inversion_variant_matches_jax(assets, inversion_runs):
    want = _tree(inversion_runs["jax"])
    got = _tree(inversion_runs["port"])
    strip_dir = os.path.join("pose", "3.0_7.0_0")
    assert _unscored(got) == _unscored(want)
    assert sum(strip_dir in n for n in got) == 3 * 2 * 6
    want_frames = {_SCORE_RE.sub("", n): n for n in want if "_edit_" in n}
    for name in got:
        if "_edit_" not in name:
            if name.endswith(".png"):
                a, b = load_png(got[name]), load_png(want[name])
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            continue
        wname = want_frames[_SCORE_RE.sub("", name)]
        a, b = load_png(got[name]), load_png(want[wname])
        assert a.shape == b.shape == (SIZE, SIZE, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
    # the scores in the names, where JAX's pose score is not near 0.5
    report = json.loads(_eval_report(cli_eval.main, inversion_runs["jax"],
                                     [f"pose={assets['pose']}"]))
    checked = 0
    for space, trajs in report["trajectories"]["pose"].items():
        for i, traj in enumerate(trajs):
            for j, s in enumerate(traj):
                if abs(s - 0.5) <= SCORE_ATOL:
                    continue
                pre = os.path.join(strip_dir, space, f"origin_{i}_edit_{j}_")
                gn = [n for n in got if n.startswith(pre)]
                wn = [n for n in want if n.startswith(pre)]
                assert gn == wn, (gn, wn)
                checked += 1
    assert checked > 20


def _eval_report(run, strips_root, specs, extra=()):
    """The JSON text of ``run`` (either package's ``cli.edit_eval``) on
    the pose strips under ``strips_root`` with ``attr=ckpt`` specs."""
    strips = os.path.join(strips_root, "pose", "3.0_7.0_0")
    out = os.path.join(strips_root, f"report_{run.__module__}.json")
    argv = ["--strips_dir", strips, "--edited_attr", "pose",
            "--classifier", *specs, "--out", out, *extra]
    if run is cli_eval.main:
        argv += ["--device", "cpu"]
    run(argv)
    with open(out) as f:
        return f.read()


def test_edit_eval_matches_jax_on_the_same_strips(assets, inversion_runs):
    root = inversion_runs["jax"]
    bounds = [os.path.join(root, f"boundary_pose_{k}.npy") for k in "zp"]
    specs = [f"pose={assets['pose']}", f"Smiling={assets['smiling']}"]
    with eo.narrow_celebahq():
        want = json.loads(_eval_report(jax_edit_eval, root, specs,
                                       ["--boundaries", *bounds]))
        got = json.loads(_eval_report(cli_eval.main, root, specs,
                                      ["--boundaries", *bounds]))
    assert set(got) == set(want) == {"trajectories", "disentanglement",
                                     "boundary_cosine"}
    for attr in ("pose", "Smiling"):
        for space in ("pz_plus", "p_plus", "z_plus"):
            np.testing.assert_allclose(got["trajectories"][attr][space],
                                       want["trajectories"][attr][space],
                                       atol=SCORE_ATOL, rtol=0)
    assert set(got["disentanglement"]) == set(want["disentanglement"])
    for k, v in want["disentanglement"].items():
        if k.startswith("corr_"):
            assert np.isclose(got["disentanglement"][k], v, rtol=0,
                              atol=1e-3, equal_nan=True), k
        else:       # a ratio of drifts: near-zero drifts amplify rounding
            assert np.isfinite(got["disentanglement"][k]) == np.isfinite(v)
    (k, v), = want["boundary_cosine"].items()
    assert abs(got["boundary_cosine"][k] - v) < 1e-5


def test_edit_eval_arcface_matches_jax(small_tmp_path):
    d = small_tmp_path / "strips" / "z_plus"
    d.mkdir(parents=True)
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (224, 224, 3)).astype(np.int16)
    for j in range(3):
        frame = np.clip(base + rng.integers(-20, 21, base.shape), 0, 255)
        save_png(str(d / f"origin_0_edit_{j}_age_{j}.png"),
                 frame.astype(np.uint8))
    arc = eo.save_sd(small_tmp_path / "ir_se50.pth", orc.arcface_sd(0))
    reports = {}
    for name, run in (("jax", jax_edit_eval), ("port", cli_eval.main)):
        out = str(small_tmp_path / f"{name}.json")
        argv = ["--strips_dir", str(small_tmp_path / "strips"),
                "--edited_attr", "age", "--arcface", arc, "--out", out]
        run(argv + (["--device", "cpu"] if name == "port" else []))
        with open(out) as f:
            reports[name] = json.load(f)
    want = reports["jax"]["id_preservation"]["z_plus"]
    got = reports["port"]["id_preservation"]["z_plus"]
    assert 0 < want < 1
    assert abs(got - want) < 1e-4


def test_edit_eval_id_inception_matches_jax(small_tmp_path):
    """``--id_inception WEIGHTS``: the same pytorch-fid checkpoint in both
    CLIs (a random one, He-scaled: ``torch_port_metrics_oracle``), two
    spaces' 64px strips: the InceptionV3 ID similarities within 1e-5."""
    rng = np.random.default_rng(5)
    for space in ("z_plus", "p_plus"):
        d = small_tmp_path / "strips" / space
        d.mkdir(parents=True)
        base = rng.integers(0, 256, (64, 64, 3)).astype(np.int16)
        for j in range(3):
            frame = np.clip(base + rng.integers(-40, 41, base.shape), 0, 255)
            save_png(str(d / f"origin_0_edit_{j}_age_{j}.png"),
                     frame.astype(np.uint8))
    inc = mo.save_sd(small_tmp_path / "pt_inception.pth",
                     mo.fid_inception_sd(3))
    reports = {}
    for name, run in (("jax", jax_edit_eval), ("port", cli_eval.main)):
        out = str(small_tmp_path / f"{name}.json")
        argv = ["--strips_dir", str(small_tmp_path / "strips"),
                "--edited_attr", "age", "--id_inception", inc, "--out", out]
        run(argv + (["--device", "cpu"] if name == "port" else []))
        with open(out) as f:
            reports[name] = json.load(f)
    assert list(reports["port"]) == list(reports["jax"]) == [
        "id_preservation_inception"]
    want = reports["jax"]["id_preservation_inception"]
    got = reports["port"]["id_preservation_inception"]
    assert set(got) == set(want) == {"z_plus", "p_plus"}
    for space in want:
        assert 0 < want[space] < 1
        assert abs(got[space] - want[space]) < 1e-5


def test_edit_eval_id_inception_needs_weights(tmp_path):
    with pytest.raises(ValueError, match="InceptionV3 weights"):
        cli_eval.main(["--strips_dir", str(tmp_path), "--edited_attr",
                       "age", "--id_inception", "--device", "cpu"])


def test_edit_cli_sampled_variant_writes_the_jax_tree(assets, tmp_path,
                                                      capsys):
    trees = {}
    for name, run in (("jax", jax_edit), ("port", cli_edit.main)):
        out = tmp_path / name
        argv = ["--ckpt", assets["g"], "--attribute", "pose",
                "--num_sample", "32", "--batch", "16", "--ratio", "0.25",
                "--steps", "3", "--n_edit_samples", "1", "--config",
                "preset", "--out_dir", str(out), *MODEL]
        run(argv + (["--device", "cpu"] if name == "port" else []))
        said = capsys.readouterr().out
        assert "WARNING: no --classifier_ckpt" in said
        assert said.count("boundary: train acc") == 2
        assert "edit sweep done" in said
        trees[name] = _tree(out)
    assert _unscored(trees["port"]) == _unscored(trees["jax"])
    assert os.path.join("pose", "1_17_0", "origin_image",
                        "sample_gen.png") in trees["port"]
    for k in "zp":
        b = np.load(trees["port"][f"boundary_pose_{k}.npy"])
        assert b.shape == (1, 16 * 512) and abs(np.linalg.norm(b) - 1) < 1e-5


def test_edit_cli_flag_errors_as_jax(assets):
    for argv in (["--encoded_z", assets["z"]], ["--attribute_index", "40"]):
        for run in (jax_edit, cli_edit.main):
            with pytest.raises(SystemExit):
                run(["--ckpt", assets["g"], *argv, *MODEL])


def test_edit_cli_json_config_memmap_store_and_retrain(assets, tmp_path,
                                                       capsys):
    """A JSON ``--config`` (2 style distances x seeds 0-1) writes one
    folder a combination (with ``--latent_store memmap``); a second run
    reuses the cached boundaries, and ``--retrain_boundary`` fits them
    again."""
    config = tmp_path / "cfg.json"
    config.write_text(json.dumps({"style_end_distance": [1, 2.5],
                                  "content_end_distance": [4],
                                  "seed": [0, 2]}))
    out = tmp_path / "out"
    argv = ["--ckpt", assets["g"], "--attribute", "pose", "--classifier_ckpt",
            assets["pose"], "--num_sample", "24", "--batch", "8", "--ratio",
            "0.25", "--steps", "3", "--n_edit_samples", "1", "--config",
            str(config), "--latent_store", "memmap", "--out_dir", str(out),
            "--device", "cpu", *MODEL]
    cli_edit.main(argv)
    assert capsys.readouterr().out.count("boundary: train acc") == 2
    assert sorted(os.listdir(out / "pose")) == ["1_4_0", "1_4_1", "2.5_4_0",
                                                "2.5_4_1"]
    for combo in os.listdir(out / "pose"):
        tree = _tree(out / "pose" / combo)
        assert len([n for n in tree if "_edit_" in n]) == 3 * 3
    first = np.load(out / "boundary_pose_z.npy")
    cli_edit.main(argv)
    assert "boundary: train" not in capsys.readouterr().out
    cli_edit.main(argv + ["--retrain_boundary", "--seed", "1"])
    assert capsys.readouterr().out.count("boundary: train acc") == 2
    assert not np.array_equal(np.load(out / "boundary_pose_z.npy"), first)


def test_edit_cli_attribute_index_takes_the_celebahq_preset(assets,
                                                            tmp_path,
                                                            capsys):
    """``--attribute_index 1`` edits Smiling with a random CelebA-HQ net
    (narrowed) and the preset of index 1 (style 30, content 5)."""
    out = tmp_path / "out"
    with eo.narrow_celebahq():
        cli_edit.main(["--ckpt", assets["g"], "--attribute_index", "1",
                       "--num_sample", "16", "--batch", "8", "--ratio",
                       "0.25", "--steps", "3", "--n_edit_samples", "1",
                       "--config", "preset", "--out_dir", str(out),
                       "--device", "cpu", *MODEL])
    assert "WARNING: no --classifier_ckpt" in capsys.readouterr().out
    assert os.listdir(out / "Smiling") == ["30_5_0"]
    assert (out / "boundary_Smiling_p.npy").exists()
    names = _tree(out / "Smiling" / "30_5_0")
    assert any(n.endswith("_Smiling_0.png") or n.endswith("_Smiling_1.png")
               for n in names)
