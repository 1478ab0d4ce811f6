"""The port's serving engine and HTTP front, on the CPU.

The decode parity test runs the JAX ``InferenceEngine`` and the port's
on the same weights and codes; their uint8 images may differ by one
level (float32 sums in another order can straddle a rounding edge).
The other tests are those of tests/test_serve.py, against the port.
"""

import base64
import http.client
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.models import Generator as JaxGenerator
from transeditor_tpu.serve import InferenceEngine as JaxEngine

import transeditor_tpu_torch.serve as serve_mod
from transeditor_tpu_torch.config import ModelConfig, TrainConfig
from transeditor_tpu_torch.data.native import decode_jpeg, encode_jpeg
from transeditor_tpu_torch.io.checkpoint import save_train_state
from transeditor_tpu_torch.io.torch_export import \
    generator_state_dict_from_jax
from transeditor_tpu_torch.serve import (InferenceEngine, _pad_pow2,
                                         make_http_server)
from transeditor_tpu_torch.train.gan import init_state
from torch_port_threads import torch_worker_threads  # noqa: F401

KW = dict(size=16, style_dim=32, param_dim=32, max_channels=32, n_trans=1)
CFG = ModelConfig(**KW)


@pytest.fixture(scope="module")
def weights():
    g = JaxGenerator(JaxConfig(**KW))
    z = jnp.zeros((1, 16, 32))
    params = g.init(jax.random.PRNGKey(0), z, z)
    params_np = jax.tree.map(np.asarray, params)
    return params, generator_state_dict_from_jax(params_np, CFG)


def _engine(weights, **kw):
    return InferenceEngine(CFG, weights[1], device="cpu", **kw)


def test_decode_matches_jax_engine(weights):
    rng = np.random.RandomState(0)
    z = rng.randn(3, 16, 32).astype(np.float32)
    p = rng.randn(3, 16, 32).astype(np.float32)
    jax_eng = JaxEngine(JaxConfig(**KW), weights[0])
    eng = _engine(weights)
    for plus in (True, False):
        want = jax_eng.decode(z, p, plus_space=plus)
        got = eng.decode(z, p, plus_space=plus)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_pad_pow2():
    assert _pad_pow2(1) == 1
    assert _pad_pow2(3) == 4
    assert _pad_pow2(65) == 128
    assert _pad_pow2(1000) == serve_mod._MAX_DEVICE_BATCH


def test_large_requests_chunk_not_truncate(weights, monkeypatch):
    """A merged request bigger than the device-batch cap runs in chunks
    and returns EVERY image."""
    monkeypatch.setattr(serve_mod, "_MAX_DEVICE_BATCH", 4)
    eng = _engine(weights)
    img, zp, pp = eng.sample(11)            # 4+4+3 device chunks
    assert img.shape == (11, 16, 16, 3)
    assert zp.shape == (11, 16, 32) and np.isfinite(zp).all()
    assert not np.array_equal(img[0], img[4])   # fresh draws per chunk
    assert {s[1] for s in eng.shapes_run} == {4}
    dec = eng.decode(zp, pp, plus_space=True)
    assert dec.shape == (11, 16, 16, 3)
    np.testing.assert_allclose(dec.astype(int), img.astype(int), atol=1)


def test_engine_endpoints(weights):
    eng = _engine(weights)
    img, zp, pp = eng.sample(3)
    assert img.shape == (3, 16, 16, 3) and img.dtype == np.uint8
    dec = eng.decode(zp, pp, plus_space=True)
    # decode(sample's plus codes) reproduces the sampled images
    np.testing.assert_allclose(dec.astype(int), img.astype(int), atol=1)
    boundary = np.random.RandomState(0).randn(1, 16 * 32).astype(np.float32)
    boundary /= np.linalg.norm(boundary)
    strip = eng.edit_strip(zp[0], pp[0], boundary, space="p", steps=5)
    assert strip.shape == (5, 16, 16, 3)
    strip_z = eng.edit_strip(zp[0], pp[0], boundary, space="z", steps=2)
    assert strip_z.shape == (2, 16, 16, 3)


def test_warmup_runs_the_pow2_ladder(weights):
    eng = _engine(weights)
    eng.warmup(max_batch=4)
    assert {s for s in eng.shapes_run if s[0] == "sample"} == {
        ("sample", 1), ("sample", 2), ("sample", 4)}
    assert len([s for s in eng.shapes_run if s[0] == "decode"]) == 6
    warm = set(eng.shapes_run)
    img, _, _ = eng.sample(3)                               # pads to 4
    assert img.shape == (3, 16, 16, 3)
    assert eng.shapes_run == warm                           # no new shape


def test_request_coalescing(weights):
    """Concurrent decode requests merge into fewer forwards and return
    per-request slices identical to serial calls."""
    eng = _engine(weights, coalesce_window_ms=50.0)
    rng = np.random.RandomState(3)
    reqs = [(rng.randn(2, 16, 32).astype(np.float32),
             rng.randn(2, 16, 32).astype(np.float32)) for _ in range(6)]
    serial = [eng.decode(zc, pc) for zc, pc in reqs]
    calls_before = eng._decode_batchers[True].calls
    with ThreadPoolExecutor(8) as ex:
        parallel = list(ex.map(lambda a: eng.decode(*a), reqs))
    merged_calls = eng._decode_batchers[True].calls - calls_before
    for s, q in zip(serial, parallel):
        np.testing.assert_allclose(s.astype(int), q.astype(int), atol=1)
    assert merged_calls < len(reqs), merged_calls


def test_http_server_endpoints(weights):
    """Drive the real HTTP surface: /health, /sample, /decode,
    /edit_strip, and base64 JPEG answers (``"format": "jpeg_b64"``)."""
    eng = _engine(weights)
    server = make_http_server(eng, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/health")
        health = json.loads(conn.getresponse().read())
        assert health["ok"] and health["size"] == 16

        conn.request("POST", "/sample", json.dumps({"n": 2}))
        out = json.loads(conn.getresponse().read())
        img = np.asarray(out["images"], np.uint8)
        assert img.shape == (2, 16, 16, 3)

        conn.request("POST", "/decode",
                     json.dumps({"z": out["z_plus"], "p": out["p_plus"]}))
        dec = np.asarray(json.loads(conn.getresponse().read())["images"],
                         np.uint8)
        np.testing.assert_allclose(dec.astype(int), img.astype(int), atol=1)

        boundary = np.ones((1, 16 * 32), np.float32) / np.sqrt(16 * 32)
        conn.request("POST", "/edit_strip", json.dumps({
            "z_plus": out["z_plus"][0], "p_plus": out["p_plus"][0],
            "boundary": boundary.tolist(), "steps": 3}))
        strip = json.loads(conn.getresponse().read())["images"]
        assert np.asarray(strip, np.uint8).shape == (3, 16, 16, 3)

        conn.request("POST", "/sample", json.dumps(
            {"n": 2, "format": "jpeg_b64", "quality": 95}))
        resp = conn.getresponse()
        assert resp.status == 200
        out = json.loads(resp.read())
        jpegs = [decode_jpeg(base64.b64decode(b)) for b in out["images"]]
        conn.request("POST", "/decode",
                     json.dumps({"z": out["z_plus"], "p": out["p_plus"]}))
        same = np.asarray(json.loads(conn.getresponse().read())["images"],
                          np.uint8)
        for jpeg, arr in zip(jpegs, same):
            # the array answer through the same codec at the same quality
            # (a 16px noisy sample loses much to JPEG itself)
            want = decode_jpeg(encode_jpeg(arr, 95))
            assert jpeg.shape == want.shape == (16, 16, 3)
            mse = np.mean((jpeg.astype(float) - want.astype(float)) ** 2)
            assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_engine_serves_g_ema_of_a_train_state(tmp_path):
    """``engine_from_checkpoint(state_dir=...)`` serves the g_ema of the
    latest (or the given) train-state checkpoint."""
    tcfg = TrainConfig(batch_size=2)
    state = init_state(CFG, tcfg, seed=4, device="cpu")
    with torch.no_grad():
        for p in state.g_ema.parameters():
            p.add_(0.01)                    # g_ema != g
    ckpt = str(tmp_path / "checkpoint")
    save_train_state(ckpt, 3, state)
    save_train_state(ckpt, 7, state)
    eng = serve_mod.engine_from_checkpoint(CFG, state_dir=ckpt,
                                           device="cpu")
    z = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = state.g_ema(z, z).image
        got = eng.gen(z, z).image
        other = state.g(z, z).image
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.allclose(got, other)
    assert serve_mod.engine_from_checkpoint(
        CFG, state_dir=ckpt, step=3, device="cpu").cfg == CFG
    with pytest.raises(ValueError, match="exactly one"):
        serve_mod.engine_from_checkpoint(CFG, device="cpu")
    with pytest.raises(FileNotFoundError):
        serve_mod.engine_from_checkpoint(CFG, state_dir=str(tmp_path),
                                         device="cpu")


def test_engine_without_device_raises_when_no_cuda(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(CFG, weights[1])


def test_main_requires_a_checkpoint():
    with pytest.raises(SystemExit):
        serve_mod.main([])

