"""The port's remaining utilities against the JAX package's, on the CPU:
``utils/image.py`` (``colorize_heatmap``, ``make_grid``'s
``normalize_range``), ``utils/profiling.py`` (``StepTimer`` on the same
patched clock; ``trace`` as torch.profiler) and ``utils/capture.py``
(``capture_fd2``, held as ``tests/test_capture.py`` holds JAX's).
Tolerance: byte-equal images, equal timer statistics (the same float64
arithmetic on the same clock readings).
"""

import json
import os
import select
import time

import numpy as np
import pytest
import torch

from transeditor_tpu.utils import image as jimage
from transeditor_tpu.utils import profiling as jprofiling

from transeditor_tpu_torch.utils import image, profiling
from transeditor_tpu_torch.utils.capture import capture_fd2
from torch_port_threads import torch_worker_threads  # noqa: F401


@pytest.mark.parametrize("shape,upscale", [((16, 16), 16), ((5, 7), 3),
                                           ((4, 4), 1)])
def test_colorize_heatmap_is_byte_equal(shape, upscale):
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = jimage.colorize_heatmap(x, upscale)
    got = image.colorize_heatmap(x, upscale)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_colorize_heatmap_of_a_constant():
    x = np.full((3, 3), 0.25, np.float32)
    np.testing.assert_array_equal(image.colorize_heatmap(x),
                                  jimage.colorize_heatmap(x))


@pytest.mark.parametrize("kw", [{}, {"normalize_range": (0.0, 1.0)},
                                {"normalize_range": (-2.0, 3.0), "pad": 0,
                                 "nrow": 3}])
def test_make_grid_equals_jax(kw):
    imgs = np.random.RandomState(1).randn(7, 6, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(image.make_grid(imgs, **kw),
                                  jimage.make_grid(imgs, **kw))


def test_step_timer_equals_jax(monkeypatch):
    """Both timers read ``time.perf_counter``; the same readings give the
    same statistics."""
    readings = np.cumsum(np.random.RandomState(2).rand(40) * 0.1)
    timers = {"jax": jprofiling.StepTimer(window=16, items_per_step=8),
              "port": profiling.StepTimer(window=16, items_per_step=8)}
    stats = {}
    for name, timer in timers.items():
        it = iter(readings.tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
        assert timer.stats() == {}
        for _ in readings:
            timer.tick()
        stats[name] = timer.stats()
    assert stats["port"] == stats["jax"]
    assert len(timers["port"].times) == 16


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = logdir / profiling.TRACE_FILE
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trace_without_logdir_is_a_no_op(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(""):
        pass
    assert not os.listdir(tmp_path)


def _read_fd2_via_pipe():
    """Redirect the real fd 2 to a pipe, to see what capture_fd2 tees."""
    r, w = os.pipe()
    saved = os.dup(2)
    os.dup2(w, 2)
    os.close(w)
    return r, saved


def test_capture_fd2_captures_and_reemits():
    r, saved = _read_fd2_via_pipe()
    try:
        box = []
        with capture_fd2(box):
            os.write(2, b"native warning line\n")
        assert box[-1] == "native warning line\n"
    finally:
        os.dup2(saved, 2)
        os.close(saved)
    assert os.read(r, 4096) == b"native warning line\n"
    os.close(r)


def test_capture_fd2_tee_is_live():
    """Text written inside the block reaches the real fd 2 before the
    block exits."""
    r, saved = _read_fd2_via_pipe()
    try:
        box = []
        with capture_fd2(box):
            os.write(2, b"live line\n")
            deadline = time.time() + 10
            got = b""
            while b"live line" not in got and time.time() < deadline:
                ready, _, _ = select.select([r], [], [], 0.2)
                if ready:
                    got += os.read(r, 4096)
        assert got == b"live line\n"
        assert box[-1] == "live line\n"
    finally:
        os.dup2(saved, 2)
        os.close(saved)
    os.close(r)


def test_capture_fd2_reemits_on_exception():
    r, saved = _read_fd2_via_pipe()
    try:
        box = []
        with pytest.raises(RuntimeError):
            with capture_fd2(box):
                os.write(2, b"abort explanation\n")
                raise RuntimeError("boom")
        assert box[-1] == "abort explanation\n"
    finally:
        os.dup2(saved, 2)
        os.close(saved)
    assert os.read(r, 4096) == b"abort explanation\n"
    os.close(r)
