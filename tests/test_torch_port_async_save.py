"""The port's background train-state saves
(``transeditor_tpu_torch/io/checkpoint.py``: ``save_train_state(...,
async_save=True)``, ``wait_for_saves``; ``transeditor_tpu/io/
checkpoint.py:31-67``) and the loop's use of them (JAX ``train/loop.py:
305-307, 320-321, 329``), on the CPU at 16px.

An async save copies the state to host memory before it returns, so the
file equals a synchronous save of the same state even while the next
step changes the modules in place; the file appears whole or not at
all; one write is in flight at a time; a failed write raises at the next
wait.  ``train()`` saves in the background on its cadence, waits before
the synchronous save on SIGTERM and before it returns."""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from torch_port_encoder_oracle import worker_threads
from transeditor_tpu_torch.config import ModelConfig, TrainConfig
from transeditor_tpu_torch.io import checkpoint
from transeditor_tpu_torch.io.checkpoint import (save_train_state,
                                                 wait_for_saves)
from transeditor_tpu_torch.parallel import multihost
from transeditor_tpu_torch.train import loop
from transeditor_tpu_torch.train.gan import init_state, make_train_step

CFG = ModelConfig(size=16, style_dim=32, param_dim=32, max_channels=32,
                  n_trans=1)
TCFG = TrainConfig(batch_size=4, d_reg_every=2, g_reg_every=2, n_sample=4,
                   sample_every=100, checkpoint_every=2)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with worker_threads():
        yield


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (4, 16, 16, 3)).astype(np.uint8)
            for _ in range(n)]


def _stepped():
    state = init_state(CFG, TCFG, seed=0, device="cpu")
    step = make_train_step(CFG, TCFG, device="cpu")
    real = torch.from_numpy(_batches(1)[0])
    state, _ = step(state, real, torch.Generator().manual_seed(0),
                    do_d_reg=True, do_g_reg=True)
    return state, step, real


def _assert_same(a, b, where="bundle"):
    if torch.is_tensor(a):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_async_file_equals_sync_file_while_the_next_step_runs(tmp_path):
    state, step, real = _stepped()
    sync = save_train_state(str(tmp_path / "sync"), 1, state)
    done = threading.Event()
    real_write = checkpoint._write

    def slow_write(bundle, path):
        done.wait(60)                 # the next step runs meanwhile
        real_write(bundle, path)

    checkpoint._write = slow_write
    try:
        path = save_train_state(str(tmp_path / "async"), 1, state,
                                async_save=True)
        before = state.g.convs[0].conv.weight.detach().clone()
        state, _ = step(state, real, torch.Generator().manual_seed(1),
                        do_d_reg=True, do_g_reg=True)
        assert not torch.equal(before, state.g.convs[0].conv.weight)
        done.set()
        wait_for_saves()
    finally:
        checkpoint._write = real_write
        done.set()
    _assert_same(torch.load(sync, weights_only=True),
                 torch.load(path, weights_only=True))


def test_the_file_is_whole_or_absent_and_one_write_is_in_flight(tmp_path,
                                                                monkeypatch):
    state, _, _ = _stepped()
    gate, started = threading.Event(), []
    real_save = torch.save

    def gated_save(obj, f):
        started.append(os.path.basename(f))
        with open(f, "wb") as fh:
            fh.write(b"half")             # a partial file, held open
            gate.wait(60)
        real_save(obj, f)

    monkeypatch.setattr(checkpoint.torch, "save", gated_save)
    ckpt = tmp_path / "ckpt"
    first = save_train_state(str(ckpt), 1, state, async_save=True)
    second = threading.Thread(target=save_train_state,
                              args=(str(ckpt), 2, state),
                              kwargs=dict(async_save=True))
    second.start()
    second.join(0.5)
    assert second.is_alive()                 # waits for the first write
    assert started == ["000001.pt.tmp"]
    assert not os.path.exists(first)         # only the .tmp, half written
    assert os.path.exists(first + ".tmp")
    gate.set()
    second.join(60)
    assert not second.is_alive()
    wait_for_saves()
    assert started == ["000001.pt.tmp", "000002.pt.tmp"]
    assert sorted(os.listdir(ckpt)) == ["000001.pt", "000002.pt"]
    torch.load(first, weights_only=True)


def test_a_failed_background_write_raises_at_the_next_wait(tmp_path,
                                                           monkeypatch):
    state, _, _ = _stepped()

    def failing_save(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", failing_save)
    path = save_train_state(str(tmp_path), 3, state, async_save=True)
    with pytest.raises(RuntimeError, match="000003.pt.*disk full"):
        wait_for_saves()
    assert not os.path.exists(path)
    wait_for_saves()                         # the error is raised once


def _recorded(monkeypatch):
    events = []
    real_save, real_wait = loop.save_train_state, loop.wait_for_saves

    def save(ckpt_dir, step, state, async_save=False):
        events.append(("save", step, async_save))
        return real_save(ckpt_dir, step, state, async_save=async_save)

    def wait():
        events.append(("wait",))
        real_wait()

    monkeypatch.setattr(loop, "save_train_state", save)
    monkeypatch.setattr(loop, "wait_for_saves", wait)
    return events


def test_train_saves_in_the_background_and_waits_at_the_end(tmp_path,
                                                            monkeypatch):
    events = _recorded(monkeypatch)
    loop.train(CFG, TCFG, iter(_batches(5)), out_dir=str(tmp_path),
               max_steps=5, device="cpu")
    # the cadence's steps 0, 2, 4 in the background; step 4 is also the
    # last, so no other save; then the wait
    assert events[:4] == [("save", 0, True), ("save", 2, True),
                          ("save", 4, True), ("wait",)]
    ckpt = tmp_path / "default" / "checkpoint"
    assert sorted(os.listdir(ckpt)) == ["000000.pt", "000002.pt",
                                        "000004.pt"]


def test_shutdown_waits_then_saves_synchronously(tmp_path, monkeypatch):
    events = _recorded(monkeypatch)
    calls = []

    def any_flag(flag):
        calls.append(flag)
        return len(calls) == 4                # after step 3

    monkeypatch.setattr(multihost, "any_flag", any_flag)
    state = loop.train(CFG, dataclasses.replace(TCFG, total_steps=10),
                       iter(_batches(10)), out_dir=str(tmp_path),
                       device="cpu")
    assert state.step == 4
    assert events[:4] == [("save", 0, True), ("save", 2, True), ("wait",),
                          ("save", 3, False)]
    assert sorted(os.listdir(tmp_path / "default" / "checkpoint")) == [
        "000000.pt", "000002.pt", "000003.pt"]
