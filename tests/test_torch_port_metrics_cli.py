"""The port's metric CLIs ``cli.calc_stats`` and ``cli.evaluate``
(``transeditor_tpu_torch/cli/``) against the JAX package's, on the CPU in
float32, from the same weight files.

A 32px generator at the CLIs' 512 width (one interaction block) is saved
as a reference ``.pt`` bundle that both CLIs load; the real folder holds
PNGs of its own images.  ``cli.calc_stats``'s pickles agree within
``STATS_REL``.  ``cli.evaluate --fid --lpips --ppl --prdc`` draws with
``jax.random`` in JAX and a ``torch.Generator`` in the port, so its runs
compare the JSON lines' structure and finiteness; the values behind
them are held with the JAX draws in ``test_torch_port_{evaluator,
diversity,ppl}.py``.  The Fréchet distance of 2,048-wide statistics is
a ~10 s ``sqrtm`` here, so both packages' evaluator modules take a cheap
stand-in for it (``_cheap_frechet``); ``test_torch_port_fid_prdc.py``
holds the real one.
"""

import contextlib
import io
import json
import pickle

import numpy as np
import pytest
import torch

from transeditor_tpu.cli.calc_stats import main as jax_calc_stats
from transeditor_tpu.cli.evaluate import main as jax_evaluate
from transeditor_tpu.metrics import evaluator as jev

import torch_port_metrics_oracle as mo
from torch_port_encoder_oracle import worker_threads
from transeditor_tpu_torch.cli import calc_stats, evaluate
from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.metrics import evaluator as tev
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.utils.image import save_png, to_uint8

SIZE = 32
MODEL = ["--size", str(SIZE), "--num_trans", "1", "--dtype", "float32"]
STATS_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with worker_threads():
        yield


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("metric_assets")
    g = Generator(ModelConfig(size=SIZE, n_trans=1), device="cpu", seed=4)
    torch.save({"g_ema": g.state_dict()}, root / "g.pt")
    g2 = Generator(ModelConfig(size=SIZE, n_trans=1), device="cpu", seed=5)
    (root / "ckpts").mkdir()
    torch.save({"g_ema": g.state_dict()}, root / "ckpts" / "000100.pt")
    torch.save({"g_ema": g2.state_dict()}, root / "ckpts" / "000200.pt")
    real = root / "real"
    real.mkdir()
    rng = np.random.default_rng(8)
    z, p = (torch.from_numpy(rng.standard_normal((6, 16, 512)).astype(
        np.float32)) for _ in range(2))
    with torch.no_grad():
        img = g(z, p).image.numpy()
    for i, im in enumerate(to_uint8(img)):
        save_png(str(real / f"{i:02d}.png"), im)
    return {
        "g": str(root / "g.pt"), "ckpts": str(root / "ckpts"),
        "real": str(real), "root": root,
        "inception": mo.save_sd(root / "pt_inception.pth",
                                mo.fid_inception_sd(6)),
        "alex": mo.save_sd(root / "lpips_alex.pth", mo.lpips_sd("alex", 7)),
        "vgg": mo.save_sd(root / "lpips_vgg.pth", mo.lpips_sd("vgg", 8)),
        "vgg16": mo.save_sd(root / "vgg16.pth", mo.vgg16_sd(9)),
    }


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_calc_stats_writes_the_jax_pickle(assets, tmp_path):
    stats = {}
    for name, main in (("jax", jax_calc_stats), ("port", calc_stats.main)):
        out = tmp_path / f"{name}.pkl"
        argv = ["--data_dir", assets["real"], "--out", str(out), "--size",
                str(SIZE), "--batch", "4", "--inception_weights",
                assets["inception"]]
        said = _run(main, argv + (["--device", "cpu"] if name == "port"
                                  else []))
        assert said.strip().endswith(f"wrote stats for 6 images to {out}")
        with open(out, "rb") as f:
            stats[name] = pickle.load(f)
    assert set(stats["port"]) == set(stats["jax"]) == {"mean", "cov", "n"}
    assert stats["port"]["n"] == stats["jax"]["n"] == 6
    for k in ("mean", "cov"):
        assert stats["port"][k].dtype == np.float64
        assert mo.rel_err(stats["port"][k], stats["jax"][k]) <= STATS_REL
    # the evaluator reads it back
    m, c = tev.load_real_stats(str(tmp_path / "port.pkl"))
    assert m.shape == (2048,) and c.shape == (2048, 2048)


def _cheap_frechet(m1, c1, m2, c2):
    """A finite stand-in for the Fréchet distance of the statistics."""
    return float(((m1 - m2) ** 2).sum() + np.trace(c1) + np.trace(c2))


@pytest.fixture
def cheap_frechet(monkeypatch):
    for mod in (jev, tev):
        monkeypatch.setattr(mod, "frechet_distance", _cheap_frechet)


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def _stats_file(tmp_path):
    path = tmp_path / "stats.npz"
    rng = np.random.default_rng(10)
    np.savez(path, mu=rng.standard_normal(2048), sigma=np.eye(2048))
    return str(path)


def test_evaluate_all_metrics_prints_the_jax_lines(assets, tmp_path,
                                                   cheap_frechet):
    lines = {}
    for name, main in (("jax", jax_evaluate), ("port", evaluate.main)):
        argv = ["--ckpt", assets["g"], "--fid", "--lpips", "--ppl",
                "--prdc", "--fid_samples", "3", "--lpips_batches", "1",
                "--ppl_samples", "2", "--prdc_samples", "4", "--batch", "2",
                "--inception_stats", _stats_file(tmp_path),
                "--inception_weights", assets["inception"],
                "--lpips_weights", assets["alex"], "--ppl_lpips_weights",
                assets["vgg"], "--real_data", assets["real"],
                "--vgg16_weights", assets["vgg16"], *MODEL]
        said = _run(main, argv + (["--device", "cpu"] if name == "port"
                                  else []))
        assert "WARNING" not in said
        lines[name] = _json_lines(said)
    got, want = lines["port"], lines["jax"]
    assert [list(d) for d in got] == [list(d) for d in want] == [
        ["prdc"], ["ckpt", "fid", "lpips", "ppl", "prdc"]]
    rep, jrep = got[1], want[1]
    assert rep["ckpt"] == jrep["ckpt"] == assets["g"]
    assert list(rep["lpips"]) == list(jrep["lpips"]) == ["all", "fix_z",
                                                         "fix_p"]
    assert list(rep["ppl"]) == list(jrep["ppl"]) == ["all", "p", "z"]
    assert list(rep["prdc"]) == list(jrep["prdc"]) == [
        "precision", "recall", "density", "coverage"]
    assert got[0]["prdc"] == rep["prdc"]
    values = [rep["fid"], *rep["lpips"].values(), *rep["ppl"].values(),
              *rep["prdc"].values()]
    assert all(np.isfinite(values))
    assert all(v > 0 for v in rep["lpips"].values())


def test_evaluate_ckpt_dir_reports_the_best_fid(assets, tmp_path,
                                                cheap_frechet):
    lines = {}
    for name, main in (("jax", jax_evaluate), ("port", evaluate.main)):
        argv = ["--ckpt_dir", assets["ckpts"], "--fid", "--fid_samples",
                "2", "--batch", "2", "--inception_stats",
                _stats_file(tmp_path), "--inception_weights",
                assets["inception"], *MODEL]
        lines[name] = _json_lines(_run(main, argv + (
            ["--device", "cpu"] if name == "port" else [])))
    got, want = lines["port"], lines["jax"]
    assert [list(d) for d in got] == [list(d) for d in want] == [
        ["ckpt", "fid", "lpips", "ppl"]] * 2 + [["best_fid", "best_ckpt"]]
    assert [d["ckpt"] for d in got[:2]] == [d["ckpt"] for d in want[:2]]
    assert got[0]["lpips"] is got[0]["ppl"] is None
    best = min(got[:2], key=lambda d: d["fid"])
    assert got[2] == {"best_fid": best["fid"], "best_ckpt": best["ckpt"]}


def test_evaluate_without_weights_warns_as_jax(assets, tmp_path,
                                               cheap_frechet):
    said = _run(evaluate.main, [
        "--ckpt", assets["g"], "--fid", "--lpips", "--fid_samples", "2",
        "--lpips_batches", "1", "--batch", "2", "--inception_stats",
        _stats_file(tmp_path), *MODEL, "--device", "cpu"])
    assert "WARNING: random InceptionV3 (pass --inception_weights)" in said
    assert "WARNING: random alex-LPIPS (pass --lpips_weights)" in said
    rep = _json_lines(said)[-1]
    assert set(rep["lpips"]) == {"all", "fix_z", "fix_p"}


def test_evaluate_flag_errors_as_jax(assets):
    for main in (jax_evaluate, evaluate.main):
        with pytest.raises(AssertionError, match="--fid needs "
                                                 "--inception_stats"):
            main(["--ckpt", assets["g"], "--fid", *MODEL, "--device", "cpu"]
                 if main is evaluate.main else
                 ["--ckpt", assets["g"], "--fid", *MODEL])


def test_clis_run_on_the_card_unless_the_cpu_is_asked_for(assets,
                                                          monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in (
            (evaluate.main, ["--ckpt", assets["g"], *MODEL]),
            (calc_stats.main, ["--data_dir", assets["real"], "--out",
                               str(tmp_path / "s.pkl")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


def test_evaluate_decodes_ppl_in_float32_under_default_flags(assets,
                                                              monkeypatch):
    """Under the default ``--dtype bfloat16``, ``cli.evaluate`` hands PPL
    a float32 generator (its eps-1e-4 steps lie under a bf16 ulp of the
    codes) and LPIPS diversity the bfloat16 one."""
    seen = {"ppl": [], "lpips": []}

    def ppl(g, *args, **kwargs):
        seen["ppl"].append((g.cfg.dtype, g.cfg.compute_dtype))
        return 1.0

    def diversity(g, *args, **kwargs):
        seen["lpips"].append((g.cfg.dtype, g.cfg.compute_dtype))
        return {"all": 1.0}

    monkeypatch.setattr(tev, "compute_ppl", ppl)
    monkeypatch.setattr(tev, "evaluate_lpips_diversity", diversity)
    out = _run(evaluate.main, [
        "--ckpt", assets["g"], "--ppl", "--lpips", "--ppl_samples", "2",
        "--lpips_batches", "1", "--batch", "2", "--lpips_weights",
        assets["alex"], "--ppl_lpips_weights", assets["vgg"], "--size",
        str(SIZE), "--num_trans", "1", "--device", "cpu"])
    assert seen["ppl"] == [("float32", torch.float32)] * 3
    assert seen["lpips"] == [("bfloat16", torch.bfloat16)]
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep["ppl"] == {"all": 1.0, "p": 1.0, "z": 1.0}
