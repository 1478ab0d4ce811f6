"""Training driver: schedule, logging, sampling, checkpointing
(``transeditor_tpu/train/loop.py``), on one device or one process of a
data-parallel group.

The lazy-regularisation cadence (R1 every ``d_reg_every`` steps, path
length every ``g_reg_every``), a fixed grid of ``n_sample`` images from
g_ema every ``sample_every`` steps, a checkpoint every
``checkpoint_every`` steps and after the last one (the JAX loop keeps
only the cadence's), and scalar logs, around ``make_train_step``.

Unlike the JAX loop's prefetcher, ``DevicePrefetcher`` ends: when the
data runs out it raises ``StopIteration`` (and again on every later
call), a loader error is raised to the caller (again on every later
call) instead of leaving it blocked, and ``train`` closes it in a
``finally``, so no thread outlives the loop.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from transeditor_tpu_torch.config import ModelConfig, TrainConfig
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.io.checkpoint import (full_state_dicts,
                                                 host_copy, save_train_state,
                                                 wait_for_saves)
from transeditor_tpu_torch.parallel import multihost
from transeditor_tpu_torch.parallel.data_parallel import (broadcast_module,
                                                          data_axis)
from transeditor_tpu_torch.parallel.mesh import Mesh, create_mesh
from transeditor_tpu_torch.train.gan import (GANTrainState, init_state,
                                             make_train_step, needs_sharding,
                                             shard_state)
from transeditor_tpu_torch.utils.image import make_grid, save_png
from transeditor_tpu_torch.utils.sampling import sample_zp


class GracefulShutdown:
    """SIGTERM / SIGINT set a flag the loop polls: it finishes the step
    in flight, checkpoints the state after it and returns.  A second
    signal falls through to the previous handler, so a wedged process
    can still be killed.  Off the main thread no handler can be set and
    only the flag works."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._signals = signals
        self._prev = {}

    def __enter__(self):
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:               # not the main thread
                break
        return self

    def _handler(self, signum, frame):
        self.requested = True
        self._restore()

    def _restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = {}

    def __exit__(self, *exc):
        self._restore()
        return False


class MetricLogger:
    """Scalar logs: one JSON line a call to ``<logdir>/metrics.jsonl``
    (when ``logdir`` is set), a stdout line every ``log_every`` steps,
    and wandb when ``use_wandb`` is set and the package is installed
    (a soft dependency, as in the reference: without it the other sinks
    still run)."""

    def __init__(self, logdir: Optional[str], log_every: int = 50,
                 use_wandb: bool = False):
        self.log_every = log_every
        self.jsonl = None
        self.wandb = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        if use_wandb:
            try:
                import wandb
            except ImportError:
                print("wandb is not installed: logging to metrics.jsonl "
                      "and stdout only", flush=True)
            else:
                wandb.init(project="transeditor_tpu")
                self.wandb = wandb

    def log(self, step: int, metrics: dict) -> None:
        values = {k: float(v) for k, v in metrics.items()}
        if self.jsonl is not None:
            self.jsonl.write(json.dumps({"step": step, **values}) + "\n")
            self.jsonl.flush()
        if self.wandb is not None:
            self.wandb.log(values, step=step)
        if step % self.log_every == 0:
            msg = "; ".join(f"{k}: {v:.4f}" for k, v in sorted(values.items()))
            print(f"[{step}] {msg}", flush=True)

    def close(self) -> None:
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None
        if self.wandb is not None:
            self.wandb.finish()
            self.wandb = None


class _End:
    """The producer's last item: the exception ``__next__`` raises."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class DevicePrefetcher:
    """Reads ``data_iter`` on a thread, ``depth`` batches ahead, and
    copies each batch to ``device``; on CUDA the copy runs on a side
    stream from pinned memory and the consumer's stream waits for it.
    Values and order are those of the iterator."""

    def __init__(self, data_iter, device: torch.device, depth: int = 2):
        self._device = device
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._end: Optional[BaseException] = None
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self._thread = threading.Thread(target=self._work,
                                        args=(iter(data_iter),), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Enqueue unless closed; False once closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _upload(self, x):
        t = torch.as_tensor(np.asarray(x))
        if self._stream is None:
            return t.to(self._device), None
        t = t.pin_memory()
        with torch.cuda.stream(self._stream):
            t = t.to(self._device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return t, ready

    def _work(self, it) -> None:
        try:
            for x in it:
                if self._stop.is_set() or not self._put(self._upload(x)):
                    return
            self._put(_End(StopIteration()))
        except Exception as e:                   # handed to the consumer
            self._put(_End(e))

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        if self._end is None:
            item = self._q.get()
            if not isinstance(item, _End):
                t, ready = item
                if ready is not None:
                    stream = torch.cuda.current_stream(self._device)
                    stream.wait_event(ready)
                    t.record_stream(stream)
                return t
            self._end = item.exc
        if isinstance(self._end, StopIteration):
            raise StopIteration
        raise self._end

    def close(self, timeout: float = 30.0) -> None:
        """Stop the thread and wait for it; batches read ahead are
        dropped."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()


def step_seed(seed: int, rank: int, step: int) -> int:
    """The seed of data rank ``rank``'s draws at step ``step``: they
    depend on (seed, rank, step) alone, so a resumed run continues as the
    whole run, each data rank draws its own latents and noise, and the
    ranks of one model group draw the same."""
    return int(np.random.SeedSequence([seed, rank, step])
               .generate_state(1, np.uint64)[0])


def _save(ckpt_dir: str, step: int, state: GANTrainState,
          async_save: bool = False) -> None:
    """Rank 0 writes the checkpoint of ``step``; every rank calls this (a
    sharded state is gathered first, a collective).  A synchronous save
    waits for any save in flight first, and every process waits for it,
    so none reads or exits against a half-written file; an async one
    returns once rank 0 holds the state in host memory."""
    rank0 = multihost.is_main()
    if state.sharding is not None or rank0:
        entries = full_state_dicts(state)
        if rank0:
            save_train_state(ckpt_dir, step, host_copy(entries),
                             async_save=async_save)
        del entries
    if not async_save:
        multihost.synchronize()


def train(cfg: ModelConfig, tcfg: TrainConfig,
          data_iter: Iterator[np.ndarray], out_dir: str = "out",
          exp_name: str = "default", state: Optional[GANTrainState] = None,
          start_step: int = 0, max_steps: Optional[int] = None,
          prefetch: int = 2, device: str | torch.device | None = None,
          log_every: int = 50, use_wandb: bool = False,
          mesh: Optional[Mesh] = None, fsdp: bool = False) -> GANTrainState:
    """Train from ``start_step`` to ``tcfg.total_steps`` (or for
    ``max_steps``) on uint8 NHWC batches from ``data_iter``.

    Runs on ``device`` (default "cuda"; raises without a card unless
    "cpu").  Writes ``<out_dir>/<exp_name>/log/metrics.jsonl`` (every
    ``log_every`` steps; each log waits for the step), ``sample/`` PNG
    grids from g_ema and ``checkpoint/<step>.pt``, every
    ``checkpoint_every`` steps (written in the background while the run
    goes on) and after the last step.  Raises ``StopIteration`` if the
    data runs out first.  On SIGTERM / SIGINT it checkpoints the state
    after the step in flight and returns.  It returns only once every
    checkpoint is written.

    Under a process group (``parallel/multihost.py``) ``data_iter``
    yields this process's share of each global batch; rank 0's modules
    are copied to every process first, and rank 0 alone writes logs,
    samples and checkpoints.  Logged values are means over processes,
    and ``data_wait_share`` is the share of the interval's wall time the
    loop spent waiting for its next batch.

    ``mesh`` (``parallel/mesh.py``; with ``fsdp`` it defaults to
    ``create_mesh()``): ``data_iter`` yields this data rank's share, and
    the ranks of a model group read the same rows.  With ``fsdp``, or a
    model axis of more than one rank, the state is sharded
    (``train/gan.py::shard_state``) after rank 0's modules are copied to
    every process; checkpoints gather it and keep the one-process
    format.
    """
    dev = resolve_device(device)
    if state is None:
        state = init_state(cfg, tcfg, seed=tcfg.seed, device=dev)
    if mesh is None and fsdp:
        mesh = create_mesh()
    if state.sharding is None:
        for m in (state.g, state.d, state.g_ema):
            broadcast_module(m)
        if needs_sharding(mesh, fsdp):
            shard_state(state, mesh, fsdp)
    step_fn = make_train_step(cfg, tcfg, device=dev, mesh=mesh, fsdp=fsdp)
    rng = torch.Generator(dev)
    world, rank, _, _ = data_axis(mesh)
    rank0 = multihost.is_main()
    ema_layout = state.sharding.g_ema if state.sharding else None

    run_dir = os.path.join(out_dir, exp_name)
    sample_dir = os.path.join(run_dir, "sample")
    ckpt_dir = os.path.join(run_dir, "checkpoint")
    if rank0:
        os.makedirs(sample_dir, exist_ok=True)
    sample_z, sample_p = sample_zp(
        torch.Generator(dev).manual_seed(tcfg.seed + 1), tcfg.n_sample,
        cfg.n_tokens, cfg.style_dim)
    end = tcfg.total_steps if not max_steps else min(
        tcfg.total_steps, start_step + max_steps)

    logger = MetricLogger(os.path.join(run_dir, "log") if rank0 else None,
                          log_every, use_wandb=use_wandb and rank0)
    fetcher = (DevicePrefetcher(data_iter, dev, prefetch) if prefetch > 0
               else None)
    try:
        t0, imgs_seen, waited = time.perf_counter(), 0, 0.0
        with GracefulShutdown() as stop:
            i = start_step - 1
            for i in range(start_step, end):
                t_wait = time.perf_counter()
                real = (next(fetcher) if fetcher is not None
                        else torch.as_tensor(np.asarray(next(data_iter))))
                waited += time.perf_counter() - t_wait
                rng.manual_seed(step_seed(tcfg.seed, rank, i))
                state, metrics = step_fn(
                    state, real, rng,
                    do_d_reg=i % tcfg.d_reg_every == 0,
                    do_g_reg=i % tcfg.g_reg_every == 0,
                    do_spatial_reg=(tcfg.spatial_regu
                                    and i % tcfg.g_reg_every == 0))
                imgs_seen += real.shape[0] * world
                if i % log_every == 0:
                    values = multihost.reduce_loss_dict(metrics)
                    dt = max(time.perf_counter() - t0, 1e-9)
                    values["imgs_per_sec"] = imgs_seen / dt
                    values["data_wait_share"] = waited / dt
                    if rank0:
                        logger.log(i, values)
                    t0, imgs_seen, waited = time.perf_counter(), 0, 0.0
                if i % tcfg.sample_every == 0 and (rank0 or ema_layout is not None):
                    if ema_layout is not None:
                        ema_layout.gather_()         # every rank
                    if rank0:
                        with torch.no_grad():
                            img = state.g_ema(sample_z, sample_p).image
                        grid = make_grid(img.float().cpu().numpy(),
                                         nrow=max(1, int(tcfg.n_sample
                                                         ** 0.5)))
                        save_png(os.path.join(sample_dir, f"{i:06d}.png"),
                                 grid)
                    if ema_layout is not None:
                        ema_layout.release_()
                saved = i % tcfg.checkpoint_every == 0
                if saved:
                    # written in the background while the run goes on
                    _save(ckpt_dir, i, state, async_save=True)
                # every process breaks at the same step (see any_flag)
                if multihost.any_flag(stop.requested):
                    # checkpoint i is the state after step i: a resume
                    # starts at i + 1 with at most this step's work
                    # redone; written whole before the process leaves
                    wait_for_saves()
                    if not saved:
                        _save(ckpt_dir, i, state)
                    else:
                        multihost.synchronize()
                    if rank0:
                        print(f"[{i}] shutdown signal: checkpointed the "
                              f"state after step {i}", flush=True)
                    return state
            if i >= start_step and i % tcfg.checkpoint_every:
                _save(ckpt_dir, i, state)        # the state after the run
            else:
                wait_for_saves()
                multihost.synchronize()
    finally:
        if fetcher is not None:
            fetcher.close()
        logger.close()
        wait_for_saves()
    return state
