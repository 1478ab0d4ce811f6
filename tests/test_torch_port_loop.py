"""The port's training loop on the CPU: ``train()`` with its metrics,
samples and checkpoints, the checkpoint round trip, the end of the data,
preemption, and the PNG writer.  Small model (16px, one interaction
block, 32 wide), float32."""

import itertools
import json
import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from transeditor_tpu_torch.config import ModelConfig, TrainConfig
from transeditor_tpu_torch.io.checkpoint import (checkpoint_steps,
                                                 restore_train_state,
                                                 save_train_state)
from transeditor_tpu_torch.train import loop
from transeditor_tpu_torch.train.gan import init_state, make_train_step
from transeditor_tpu_torch.utils.image import make_grid, save_png
from torch_port_threads import torch_worker_threads  # noqa: F401

CFG = ModelConfig(size=16, style_dim=32, param_dim=32, max_channels=32,
                  n_trans=1)
TCFG = TrainConfig(batch_size=4, d_reg_every=2, g_reg_every=2, n_sample=4)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (4, 16, 16, 3)).astype(np.uint8)
            for _ in range(n)]


def _with_timeout(fn, seconds=120):
    """Run ``fn`` on a thread; a hang fails the test instead of the
    suite."""
    with ThreadPoolExecutor(1) as ex:
        return ex.submit(fn).result(timeout=seconds)


def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + w * 3)
    assert depth == 8 and color == 2 and rows[:, 0].max() <= 4
    # the rows are filtered (Sub, Up, Average, Paeth): PIL unfilters them
    return np.asarray(Image.open(path))


def _params(state):
    return {k: v.clone() for k, v in state.g.state_dict().items()} | {
        "d." + k: v.clone() for k, v in state.d.state_dict().items()}


def test_train_three_steps_writes_metrics_samples_checkpoint(tmp_path):
    state = loop.train(CFG, TCFG, iter(_batches(3)), out_dir=str(tmp_path),
                       exp_name="run", max_steps=3, device="cpu",
                       log_every=1)
    assert state.step == 3
    run = tmp_path / "run"
    lines = [json.loads(s) for s in
             (run / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1, 2]
    for r in lines:
        assert all(np.isfinite(v) for v in r.values()), r
        assert r["imgs_per_sec"] > 0
    # R1 and path length on steps 0 and 2 only
    assert [r["r1"] > 0 for r in lines] == [True, False, True]
    assert [r["path_length"] > 0 for r in lines] == [True, False, True]
    img = _read_png(run / "sample" / "000000.png")
    assert img.shape == (2 * 18 + 2, 2 * 18 + 2, 3)
    # the cadence's (step 0) and the state after the last step
    assert checkpoint_steps(str(run / "checkpoint")) == [0, 2]


def test_checkpoint_round_trip_continues_identically(tmp_path):
    batches = _batches(4, seed=1)
    whole = loop.train(CFG, TCFG, iter(batches), out_dir=str(tmp_path),
                       exp_name="whole", max_steps=4, device="cpu")

    first = loop.train(CFG, TCFG, iter(batches[:2]), out_dir=str(tmp_path),
                       exp_name="split", max_steps=2, device="cpu")
    ckpt = str(tmp_path / "split" / "checkpoint")
    save_train_state(ckpt, 1, first)
    template = init_state(CFG, TCFG, seed=99, device="cpu")
    resumed, step = restore_train_state(ckpt, template)
    assert step == 1 and resumed.step == 2
    torch.testing.assert_close(resumed.mean_path_length,
                               first.mean_path_length)
    second = loop.train(CFG, TCFG, iter(batches[2:]), out_dir=str(tmp_path),
                        exp_name="split", state=resumed, start_step=step + 1,
                        max_steps=2, device="cpu")
    assert second.step == whole.step == 4
    want, got = _params(whole), _params(second)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    for a, b in zip(whole.g_ema.parameters(), second.g_ema.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(second.mean_path_length,
                               whole.mean_path_length, rtol=0, atol=0)


def test_finite_data_ends_with_stop_iteration(tmp_path):
    before = set(threading.enumerate())

    def run():
        with pytest.raises(StopIteration):
            loop.train(CFG, TCFG, iter(_batches(2)), out_dir=str(tmp_path),
                       max_steps=5, device="cpu")
    _with_timeout(run)
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()
            and not t.name.startswith("ThreadPoolExecutor")]
    assert not left, left


def test_prefetcher_ends_and_repeats_errors():
    def boom():
        yield np.zeros((1, 2, 2, 3), np.uint8)
        raise OSError("loader broke")

    def run():
        pf = loop.DevicePrefetcher(iter(_batches(2)), torch.device("cpu"))
        got = [next(pf) for _ in range(2)]
        assert all(torch.equal(g, torch.from_numpy(b))
                   for g, b in zip(got, _batches(2)))
        for _ in range(3):
            with pytest.raises(StopIteration):
                next(pf)
        pf.close()
        assert not pf.alive

        pf = loop.DevicePrefetcher(boom(), torch.device("cpu"))
        next(pf)
        for _ in range(3):
            with pytest.raises(OSError, match="loader broke"):
                next(pf)
        pf.close()
        assert not pf.alive

        endless = loop.DevicePrefetcher(itertools.repeat(np.zeros(3)),
                                        torch.device("cpu"), depth=2)
        next(endless)
        endless.close()
        assert not endless.alive
    _with_timeout(run)


def test_preemption_checkpoints_the_state_after_the_step(tmp_path,
                                                         monkeypatch):
    class Requested(loop.GracefulShutdown):
        def __enter__(self):
            self.requested = True
            return self

    monkeypatch.setattr(loop, "GracefulShutdown", Requested)
    tcfg = TrainConfig(batch_size=4, n_sample=4, checkpoint_every=1000,
                       sample_every=1000)
    state = loop.train(CFG, tcfg, iter(_batches(5)), out_dir=str(tmp_path),
                       start_step=3, max_steps=5, device="cpu")
    assert state.step == 1                 # one step, then the checkpoint
    ckpt = str(tmp_path / "default" / "checkpoint")
    assert checkpoint_steps(ckpt) == [3]
    restored, step = restore_train_state(
        ckpt, init_state(CFG, tcfg, seed=7, device="cpu"))
    assert step == 3 and restored.step == 1
    for k, v in _params(state).items():
        torch.testing.assert_close(_params(restored)[k], v, rtol=0, atol=0)


def test_graceful_shutdown_handler_sets_the_flag():
    stop = loop.GracefulShutdown(signals=())
    with stop:
        assert not stop.requested
        stop._handler(15, None)
    assert stop.requested


def test_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(CFG, TCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(CFG, TCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.train(CFG, TCFG, iter(_batches(1)), max_steps=1)


def test_png_writer_round_trips(tmp_path):
    rng = np.random.RandomState(0)
    imgs = rng.uniform(-1, 1, (5, 6, 7, 3)).astype(np.float32)
    grid = make_grid(imgs, nrow=3)
    assert grid.shape == (2 * 8 + 2, 3 * 9 + 2, 3) and grid.dtype == np.uint8
    save_png(str(tmp_path / "g.png"), grid)
    np.testing.assert_array_equal(_read_png(tmp_path / "g.png"), grid)
    with pytest.raises(ValueError):
        save_png(str(tmp_path / "gray.png"), grid[..., 0])
