"""Traffic kind ``gan_train``: GAN training at the reference recipe.

Seeded uint8 real batches go through the training loop's
``DevicePrefetcher`` into ``make_train_step``'s step, with the lazy
regularisation cadence of the configuration's ``train`` section (R1 every
``d_reg_every`` steps, path length every ``g_reg_every``), Adam and the EMA.
Set-up builds the train state, loads the seeded weights, and drives the
same step object through one step of each variant, which the check reads
(``harness/train_check.py``).  The window then starts at cadence step 0 and
runs whole cadence periods until ``--seconds`` have passed, so each run
holds the variants in the cadence's proportion; it closes when the last
step has finished on the device.

Parameters (the cell file's ``params``): ``real_batches``, the number of
distinct real batches cycled through the window.

With ``--trace 1`` the window's first period synchronises after each step
and times it, and its second period is profiled.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import program, train_check
from portbench.harness.trace import Traced, warm_profiler


def _pool_iter(pool: np.ndarray):
    k = 0
    while True:
        yield pool[k % len(pool)]
        k += 1


class Training:
    """The program's train state, step object and feed for one cell and
    seed: weights made from the seed and loaded with ``strict=True``, the
    seeded real batches through ``DevicePrefetcher``, each step's latents
    and path noise through ``draws=``."""

    def __init__(self, cell, seed: int, dev):
        from transeditor_tpu_torch.train.gan import (init_state,
                                                     make_train_step)
        from transeditor_tpu_torch.train.loop import DevicePrefetcher

        self.m, self.seed, self.dev = cell.model, seed, dev
        self.marks = [("imports", time.perf_counter())]
        cfg = program.model_config(cell.config)
        self.tcfg = tcfg = program.train_config(cell.config)
        self.batch = tcfg.batch_size
        self.path_batch = max(1, self.batch // tcfg.path_batch_shrink)
        init = train_check.initial_weights(self.m, seed, dev)
        self.mark("weights made")
        self.state = init_state(cfg, tcfg, seed=0, device=dev)
        self.mark("program's state built")
        self.state.g.load_state_dict(init["g"], strict=True)
        self.state.g_ema.load_state_dict(init["g"], strict=True)
        self.state.d.load_state_dict(init["d"], strict=True)
        del init
        self.step = make_train_step(cfg, tcfg, device=dev)
        self.pool = train_check.real_pool(seed, cell.params["real_batches"],
                                          self.batch, self.m["size"])
        self.fetcher = DevicePrefetcher(_pool_iter(self.pool), dev, depth=2)
        self.rng = torch.Generator(dev).manual_seed(0)
        self.mark("weights loaded, step and feed built")

    def mark(self, what: str) -> None:
        """Note the end of a phase of set-up (on the host's clock, after the
        device has finished it)."""
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.marks.append((what, time.perf_counter()))

    def one(self, k: int, r1: bool, path: bool, real):
        """Step ``k`` of the run (its draws are step ``k``'s)."""
        dr = train_check.step_draws(self.m, self.seed, k, self.batch,
                                    self.path_batch, path, self.dev)
        return self.step(self.state, real, self.rng, do_d_reg=r1,
                         do_g_reg=path, draws=dr)

    def checked_steps(self) -> dict:
        """Steps 0-2 (plain, R1 + path, path) through the feed, and the
        readings the check holds against the reference."""
        st = self.state
        prog = {"losses": [], "grads": []}
        for k, (r1, path) in enumerate(train_check.CHECK_VARIANTS):
            _, met = self.one(k, r1, path, next(self.fetcher))
            prog["losses"].append({t: float(met[t])
                                   for t in train_check.terms(r1, path)})
            if k < 2:
                prog["grads"].append(train_check.moments(
                    (("g", st.g, st.opt_g), ("d", st.d, st.opt_d))))
        self.mark("checked steps")
        init = train_check.initial_weights(self.m, self.seed, self.dev)
        prog["change"] = train_check.change_norms(
            {"g": st.g, "d": st.d, "g_ema": st.g_ema}, init)
        self.mark("their readings")
        return prog

    def close(self) -> None:
        """Stop the feed and drop the program's state."""
        self.fetcher.close()
        self.state = self.step = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run(run) -> None:
    cell, dev, seed = run.cell, run.device, run.seed
    # --- set-up
    t = Training(cell, seed, dev)
    tcfg = t.tcfg
    if run.trace:
        warm_profiler(dev)
        t.mark("profiler warmed")
    try:
        prog = t.checked_steps()
        k0 = len(train_check.CHECK_VARIANTS)
        last = run.t_start
        for what, at in t.marks:
            run.notes.append(f"set-up: {what} {at - last:.3f} s")
            last = at

        # --- window
        period = np.lcm(tcfg.d_reg_every, tcfg.g_reg_every)
        steps = {"plain": 0, "r1+path": 0, "path": 0, "r1": 0}
        wait = 0.0
        step_ms = {"plain": [], "reg": []}
        traced = traced_steps = None
        run.window_start()
        t0 = time.perf_counter()
        p = 0
        while True:
            timed = run.trace and p == 0
            profiled = run.trace and p == 1
            tracer = Traced(dev) if profiled else None
            if tracer is not None:
                tracer.__enter__()
            in_period = dict.fromkeys(steps, 0)
            for i in range(period):
                r1 = i % tcfg.d_reg_every == 0
                path = i % tcfg.g_reg_every == 0
                tw = time.perf_counter()
                with torch.profiler.record_function("bench.next_batch"):
                    real = next(t.fetcher)
                wait += time.perf_counter() - tw
                ts = time.perf_counter()
                with torch.profiler.record_function("bench.train_step"):
                    t.one(k0 + p * period + i, r1, path, real)
                if timed:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    step_ms["reg" if r1 or path else "plain"].append(
                        (time.perf_counter() - ts) * 1e3)
                kind = ("r1+path" if r1 and path else "r1" if r1
                        else "path" if path else "plain")
                in_period[kind] += 1
            if tracer is not None:
                tracer.__exit__(None, None, None)
                traced, traced_steps = tracer, in_period
            for kind, n in in_period.items():
                steps[kind] += n
            p += 1
            if time.perf_counter() - t0 >= run.seconds and (
                    not run.trace or p >= 3):
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run.window_s = time.perf_counter() - t0
        run.read_memory()
        if traced is not None:
            run.traced = traced.reduce()
    finally:
        t.close()
    n_steps = sum(steps.values())
    run.attempted = n_steps
    run.data.update(
        batch=t.batch, path_batch=t.path_batch, steps=steps,
        train_img_s=n_steps * t.batch / run.window_s,
        data_wait_share=wait / run.window_s, step_ms=step_ms,
        traced_steps=traced_steps)

    # --- check, with the program's state freed
    reals = t.pool[:len(train_check.CHECK_VARIANTS)]
    ref = train_check.reference_readings(cell.config, seed, reals, dev)
    train_check.judge(run, prog, ref)
