#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py          # from the root of a checkout

Phases; any failure exits nonzero before the result lines are printed.
They run in the order 1, 2a, 3, 2b, 3b, 4: everything timed by the host
clock comes before the first use of torch.profiler.

  1. card: name and power limit (nvidia-smi); build the CUDA kernel from
     transeditor_tpu_torch/csrc/ and print the build seconds;
  2a. kernel vs plain: ``fused_blur4`` against ``fused_blur4_plain`` on
     the card at the six shapes of a 256px forward at batches 1, 2, 4 and
     8 (the serving ladder and the generator phase) and at odd shapes
     (ragged last segment and strip, pad (2, 1), C=20, a misaligned
     view), in float32 (limit 1e-5) and bfloat16 (limit 2 bf16 ulps of
     the plain result computed in float32, beyond the 1e-5 float32
     allowance that matters only next to zero), without epilogue, with
     scale, with scale + bias + activation, and with a bf16 scale; each
     case on the path ``plan_tiles`` chose for it; and the wrapper's host
     time per call (host clock over enqueues at the 9x9 shape);
  2b. per main-path shape at batch 64 in bfloat16: both paths held
     against the plain version (2 bf16 ulps: at this batch every block
     walks several tiles, so the ring runs on across tile boundaries);
     the kernel's device time per launch (a CUDA graph of back-to-back
     launches replayed between two events) on the TMA path and on the
     general path (the first design); the wrapper + kernel time (CUDA
     events around back-to-back wrapper calls), the plain version and
     one depthwise F.conv2d, beside the bound from the bytes moved;
  3. generator: the full-width 256px ``ModelConfig()`` with seeded random
     weights, bf16 at batch 8 (finite, 6 kernel launches per forward, all
     on the TMA path);
     float32 at batch 2 on the card vs the same weights and codes on the
     CPU (plain path); img/s at batches 1 / 8 / 64;
  3b. device time by kernel for one forward at batches 1 and 64
     (torch.profiler);
  4. serve (a main path, counted): an ``InferenceEngine`` on the card,
     warmed to batch 8, answers concurrent sample / decode / edit_strip
     requests and one HTTP ``POST /sample`` + ``GET /health``.  The
     kernel's launch counts are set to 0 just before and read just after;
     every launch must have taken the TMA path.
  5a. the kernel's backward: at the six main-path shapes at batches 2 and
     16, in float32 and bfloat16, the gradients of ``fused_blur4`` (its
     ``autograd.Function``: adjoint and recompute launches) in x, scale
     and bias against autograd through ``fused_blur4_plain`` on the card
     (grad_x 1e-5 in float32 / 2 bf16 ulps; grad_scale and grad_bias,
     sums over H*W products, 1e-5 of their largest magnitude; gy is 0
     where the pre-activation is within 1e-4 of 0, see off_the_kink), and one
     double-backward product per dtype (1e-5 / 2 bf16 ulps of each
     tensor's largest magnitude); then, at float32 batch 16, the device
     time of the forward, the adjoint and the recompute launches (CUDA
     graph replay) and of the whole composed backward (events), beside
     their bounds;
  5b. training (the second main path, counted): ``train()`` on the
     full-width 256px ``ModelConfig()`` in float32 at batch 16 (path
     batch 8) on seeded uint8 batches, steps 2-6 with R1 every 2 and path
     length every 3 steps (variants r1, path, r1, plain, then r1 + path
     + the spatial path regulariser), counted by role and path: every
     launch on the TMA path, adjoint and recompute launches present.
     Then ms per step by variant (host clock around synchronised steps,
     after one warm step each), launches per step by variant, peak
     memory; and one reg step of a 64px model (max_channels 128,
     n_trans 2, batch 4) on the card against the same step on the CPU,
     same weights and draws, at lr 0 and without cuDNN (see
     train_card_vs_cpu): metrics within 1e-4, gradients (Adam's first
     moments, beta1 = 0, and the root of the second moments) within 1e-4
     of each tensor's largest magnitude.

The phases run in the order 1, 2a, 3, 2b, 3b, 4, 5a, 5b.  The last
three lines are the card line, the kernels line and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM float32, outside tensor cores
TAPS = tuple((np.asarray([1., 3., 3., 1.]) / 8.0 * 2.0).tolist())
MAIN_SHAPES = [(9, 512), (17, 512), (33, 512), (65, 512), (129, 256),
               (257, 128)]          # fused_blur4 inputs of a 256px forward
ODD_CASES = [((2, 17, 17, 64), (1, 1)), ((2, 11, 23, 20), (1, 1)),
             ((2, 12, 9, 8), (2, 1)),
             ((1, 68, 300, 64), (1, 1))]   # ragged last segment and strip
CHECK_BATCHES = (1, 2, 4, 8)       # main-path batches held against plain
TIME_BATCH = 64
L2_BYTES = 50e6                    # H100 L2


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


# ---------------------------------------------------------------- phase 2

def misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose storage starts one element into
    its buffer, so its address is not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def hold_to_plain(got: torch.Tensor, want: torch.Tensor, tag: str):
    """(max abs err, bf16 ulps) of ``got`` against the plain result
    ``want`` computed in float32; fails beyond 1e-5 in float32, or beyond
    2 bf16 ulps past the 1e-5 float32 sum-order allowance in bfloat16."""
    diff = (got.float() - want).abs()
    err = diff.max().item()
    if got.dtype == torch.float32:
        check(err <= 1e-5, f"{tag}: err {err}")
        return err, 0.0
    ulps = ((diff - 1e-5).clamp_min(0) / bf16_ulp(want)).max().item()
    check(ulps <= 2.0, f"{tag}: {ulps} ulps")
    return err, ulps


def kernel_vs_plain(fb, dev) -> dict:
    g = torch.Generator(dev).manual_seed(0)
    cases = [((b, h, h, c), (1, 1), False)
             for b in CHECK_BATCHES for h, c in MAIN_SHAPES]
    cases += [(shape, pad, False) for shape, pad in ODD_CASES]
    cases += [((2, 17, 17, 64), (1, 1), True)]          # storage offset
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_ulps = 0.0
    fb.launches.reset()
    n = 0
    for shape, pad, offset in cases:
        b, c = shape[0], shape[-1]
        x32 = torch.randn(shape, generator=g, device=dev)
        scale = torch.rand((b, c), generator=g, device=dev) + 0.5
        bias = torch.randn((c,), generator=g, device=dev)
        epis = ({}, {"scale": scale},
                {"scale": scale, "bias": bias, "act": True},
                {"scale": scale.to(torch.bfloat16), "bias": bias,
                 "act": True})
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            if offset:
                x = misaligned(x)
            want_path = fb.plan_tiles(*shape, dtype, pad,
                                      x.data_ptr() % 16 == 0).path
            for epi in epis:
                before = fb.launches.by_path.get(want_path, 0)
                got = fb.fused_blur4(x, TAPS, pad, **epi)
                check(fb.launches.by_path.get(want_path, 0) == before + 1,
                      f"{shape} {dtype} did not take the {want_path} path")
                n += 1
                want = fb.fused_blur4_plain(x.float(), TAPS, pad, **epi)
                e, ulps = hold_to_plain(
                    got, want, f"{dtype} {shape} pad {pad} offset {offset} "
                               f"{sorted(epi)}")
                err[dtype] = max(err[dtype], e)
                worst_ulps = max(worst_ulps, ulps)
    torch.cuda.synchronize()
    paths = fb.launches.by_path
    check(sum(paths.values()) == n and paths.get("general", 0) > 0
          and paths.get("tma", 0) > 0, f"launches by path {paths}")
    print(f"kernel vs plain: {len(cases)} shapes x 4 epilogues x 2 dtypes; "
          f"max abs err f32 {err[torch.float32]:.3e} (limit 1e-5), "
          f"bf16 {err[torch.bfloat16]:.3e} = {worst_ulps:.3f} ulp "
          f"(limit 2 ulp); launches by path {paths}", flush=True)
    return {"max_err_f32": err[torch.float32],
            "max_err_bf16": err[torch.bfloat16], "max_bf16_ulps": worst_ulps}


def _dev_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn``: a CUDA graph of ``reps``
    back-to-back calls, replayed between two events.  Unlike events
    around the calls themselves, it leaves out the wrapper's host time;
    it includes the graph's short gaps between kernels."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def kernel_times(fb, dev) -> list:
    """Per main-path shape, bf16 at TIME_BATCH, scale + bias + act."""
    g = torch.Generator(dev).manual_seed(1)
    rows = []
    for h, c in MAIN_SHAPES:
        b = TIME_BATCH
        x = torch.randn((b, h, h, c), generator=g, device=dev,
                        dtype=torch.bfloat16)
        scale = (torch.rand((b, c), generator=g, device=dev) + 0.5).to(
            torch.bfloat16)
        bias = torch.randn((c,), generator=g, device=dev)
        taps_flipped = torch.tensor(TAPS[::-1], device=dev)
        wdw = torch.outer(taps_flipped, taps_flipped).to(torch.bfloat16) \
            .reshape(1, 1, 4, 4).expand(c, 1, 4, 4).contiguous(
                memory_format=torch.channels_last)
        xc = x.permute(0, 3, 1, 2)
        epi = dict(scale=scale, bias=bias, act=True)
        plan = fb.plan_tiles(b, h, h, c, x.dtype, (1, 1),
                             n_sm=fb._sm_count(torch.cuda.current_device()))
        check(plan.path == "tma", f"{[b, h, h, c]} planned {plan.path}")
        general = fb.plan_tiles(b, h, h, c, x.dtype, (1, 1), aligned=False)
        runs = {"tma": lambda: fb.fused_blur4(x, TAPS, (1, 1), **epi),
                "general": lambda: fb.launch(general, x, TAPS, **epi)}
        want = fb.fused_blur4_plain(x.float(), TAPS, (1, 1), **epi)
        err = {}
        for name, fn in runs.items():
            err[name] = hold_to_plain(fn(), want,
                                      f"{name} path bf16 {[b, h, h, c]}")
        del want
        dev_ms = {name: device_ms(fn) for name, fn in runs.items()}
        wrapper = time_ms(lambda: fb.fused_blur4(x, TAPS, (1, 1), **epi))
        plain = time_ms(lambda: fb.fused_blur4_plain(x, TAPS, (1, 1), **epi),
                        reps=5)
        conv = time_ms(lambda: F.conv2d(xc, wdw, padding=1, groups=c))
        ho = h - 1
        in_bytes = b * h * h * c * 2
        nbytes = in_bytes + b * ho * ho * c * 2 + b * c * 2 + c * 4
        flops = b * ho * ho * c * 20       # 8 FMAs + scale, bias, lrelu
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        ms = dev_ms["tma"]
        rows.append({"in": [b, h, h, c], "ms": ms,
                     "general_path_ms": dev_ms["general"],
                     "max_abs_err": err["tma"][0],
                     "bf16_ulps": err["tma"][1],
                     "general_path_ulps": err["general"][1],
                     "wrapper_ms": wrapper, "plain_ms": plain,
                     "depthwise_conv_ms": conv, "bound_ms": bound,
                     "share_of_bound": bound / ms, "bytes": nbytes,
                     "input_fits_l2": in_bytes < L2_BYTES,
                     "plan": {k: getattr(plan, k) for k in (
                         "cc", "wt", "seg", "stages", "n_tiles",
                         "grid", "threads", "smem")},
                     "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                  >= flops / F32_FLOPS_PER_S
                                  else "operations")})
        l2 = " (input fits in L2 on repeats)" if in_bytes < L2_BYTES else ""
        print(f"  fused_blur4 bf16 {[b, h, h, c]}: vs plain "
              f"{err['tma'][1]:.3f} ulp TMA ({plan.n_tiles} tiles on "
              f"{plan.grid} blocks), {err['general'][1]:.3f} ulp general; "
              f"device {ms:.4f} ms TMA, {dev_ms['general']:.4f} ms general "
              f"path (graph replay); wrapper + kernel {wrapper:.4f} ms; "
              f"plain {plain:.4f} ms; depthwise F.conv2d (blur alone) "
              f"{conv:.4f} ms; bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), "
              f"{bound / ms:.1%} of it{l2}", flush=True)
        del x, xc
    torch.cuda.empty_cache()
    return rows


def wrapper_host_us(fb, dev, reps: int = 200) -> float:
    """Host time per ``fused_blur4`` call: a host clock over ``reps``
    enqueues at the 9x9 main-path shape (the device keeps up), then a
    synchronize."""
    b, (h, c) = TIME_BATCH, MAIN_SHAPES[0]
    x = torch.randn((b, h, h, c), device=dev, dtype=torch.bfloat16)
    epi = dict(scale=torch.ones((b, c), device=dev, dtype=torch.bfloat16),
               bias=torch.zeros((c,), device=dev), act=True)
    for _ in range(3):
        fb.fused_blur4(x, TAPS, (1, 1), **epi)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fb.fused_blur4(x, TAPS, (1, 1), **epi)
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    print(f"fused_blur4 wrapper host time: {us:.2f} us per call "
          f"({reps} enqueues, bf16 {[b, h, h, c]})", flush=True)
    return us


# ---------------------------------------------------------------- phase 3

def codes(batch: int, dim: int = 512, seed: int = 0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(batch, 16, dim).astype(np.float32)),
            torch.from_numpy(rng.randn(batch, 16, dim).astype(np.float32)))


def generator_phase(fb, dev, card: str, **cfg_kw):
    """``cfg_kw`` narrows the model for a CPU rehearsal; none on the card."""
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.models.generator import Generator

    cfg = ModelConfig(dtype="bfloat16", **cfg_kw)
    size, dim, ups = cfg.size, cfg.style_dim, cfg.log_size - 2
    g = Generator(cfg, device=dev, seed=0).eval()
    z, p = codes(8, dim)
    with torch.inference_mode():
        g(z.to(dev), p.to(dev))                      # cuDNN picks algos
        torch.cuda.synchronize()
        fb.launches.reset()
        out = g(z.to(dev), p.to(dev))
        torch.cuda.synchronize()
    n, paths = fb.launches.value, fb.launches.by_path
    check(n == ups, f"fused_blur4 launched {n} times in one forward, "
                    f"not {ups}")
    check(paths == {"tma": ups}, f"forward launches by path {paths}")
    check(tuple(out.image.shape) == (8, size, size, 3), str(out.image.shape))
    check(out.image.dtype == torch.bfloat16, str(out.image.dtype))
    check(bool(torch.isfinite(out.image.float()).all()), "non-finite image")
    print(f"generator bf16 batch 8: image {tuple(out.image.shape)} finite, "
          f"fused_blur4 launches per forward {n} {paths}", flush=True)

    cfg32 = ModelConfig(**cfg_kw)
    z2, p2 = codes(2, dim, seed=1)
    with torch.inference_mode():
        ref = Generator(cfg32, device="cpu", seed=0)(z2, p2)
        got = Generator(cfg32, device=dev, seed=0)(z2.to(dev), p2.to(dev))
    img_err = (got.image.cpu() - ref.image).abs().max().item()
    lat_err = (got.latent.cpu() - ref.latent).abs().max().item()
    check(img_err <= 1e-3, f"f32 card vs cpu image err {img_err}")
    check(lat_err <= 1e-3, f"f32 card vs cpu latent err {lat_err}")
    print(f"generator f32 batch 2, card vs CPU (plain path): max abs err "
          f"image {img_err:.3e}, latent {lat_err:.3e} (limit 1e-3)",
          flush=True)

    rates = {}
    with torch.inference_mode():
        for b in (1, 8, 64):
            zb, pb = (t.to(dev) for t in codes(b, dim, seed=2))
            ms = time_ms(lambda: g(zb, pb), reps=10 if b < 64 else 5,
                         warm=2)
            rates[b] = b / (ms / 1e3)
            print(f"generator bf16 {size}px batch {b}: {ms:.3f} ms/forward, "
                  f"{rates[b]:.1f} img/s on {card}", flush=True)
    return g, {"img_err_f32": img_err, "latent_err_f32": lat_err,
               "img_per_s": rates}


def profile_forward(g, dev, batch: int, top: int = 6) -> dict:
    """Device time by kernel for one bf16 forward (torch.profiler).  The
    busy share is summed kernel time over the profiled forward's wall
    time; the profiler's own host cost makes it a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    zb, pb = (t.to(dev) for t in codes(batch, g.cfg.style_dim, seed=4))
    with torch.inference_mode():
        g(zb, pb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            g(zb, pb)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

    # kernels only: CPU-side ops also carry the device time they launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]
    busy_us = sum(_dev_us(e) for e in events)
    blur_us = sum(_dev_us(e) for e in events if "fused_blur4" in e.key)
    events.sort(key=_dev_us, reverse=True)
    rows = [{"name": e.key[:60], "calls": e.count, "ms": _dev_us(e) / 1e3}
            for e in events[:top]]
    print(f"profile bf16 batch {batch}: device busy {busy_us / 1e3:.3f} ms "
          f"of {wall_us / 1e3:.3f} ms wall ({busy_us / wall_us:.1%}); "
          f"fused_blur4 {blur_us / 1e3:.3f} ms", flush=True)
    for r in rows:
        print(f"  {r['ms']:9.3f} ms  x{r['calls']:<4d} {r['name']}",
              flush=True)
    return {"batch": batch, "busy_ms": busy_us / 1e3,
            "wall_ms": wall_us / 1e3, "top": rows}


# ---------------------------------------------------------------- phase 4

def serve_phase(fb, dev, g) -> dict:
    import http.client
    from transeditor_tpu_torch.serve import InferenceEngine, make_http_server

    size, dim, ups = g.cfg.size, g.cfg.style_dim, g.cfg.log_size - 2
    eng = InferenceEngine(g.cfg, g.state_dict(), seed=0, device=dev)
    t0 = time.time()
    eng.warmup(8)
    print(f"serve: warmed batches 1..8 in {time.time() - t0:.1f} s",
          flush=True)
    rng = np.random.RandomState(3)
    z = rng.randn(2, 16, dim).astype(np.float32)
    p = rng.randn(2, 16, dim).astype(np.float32)
    boundary = rng.randn(1, 16 * dim).astype(np.float32)
    boundary /= np.linalg.norm(boundary)
    server = make_http_server(eng, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)

    torch.cuda.synchronize()
    fb.launches.reset()                      # the main path starts here
    with ThreadPoolExecutor(4) as ex:
        f1 = ex.submit(eng.sample, 1)
        f3 = ex.submit(eng.sample, 3)
        fz = ex.submit(eng.decode, z, p, False)
        img1, _, _ = f1.result()
        img3, zp3, pp3 = f3.result()
        dec_z = fz.result()
    dec_plus = eng.decode(zp3, pp3, plus_space=True)
    strip = eng.edit_strip(zp3[0], pp3[0], boundary, space="p", steps=4)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=120)
        conn.request("GET", "/health")
        health = json.loads(conn.getresponse().read())
        conn.request("POST", "/sample", json.dumps({"n": 1}))
        resp = conn.getresponse()
        http_img = np.asarray(json.loads(resp.read())["images"], np.uint8)
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    torch.cuda.synchronize()
    launches = fb.launches.value              # ... and ends here
    paths = fb.launches.by_path

    for name, a, n in (("sample(1)", img1, 1), ("sample(3)", img3, 3),
                       ("decode z/p", dec_z, 2), ("decode z+/p+", dec_plus, 3),
                       ("edit_strip", strip, 4), ("POST /sample", http_img, 1)):
        check(a.dtype == np.uint8 and a.shape == (n, size, size, 3),
              f"{name}: {a.dtype} {a.shape}")
    check(health.get("ok") is True and health.get("size") == size,
          f"/health: {health}")
    check(resp.status == 200, f"POST /sample: HTTP {resp.status}")
    diff = np.abs(dec_plus.astype(int) - img3.astype(int))
    check(diff.mean() < 1.0, f"decode(z+,p+) vs sample: mean diff "
                             f"{diff.mean()}")
    check(launches > 0 and launches % ups == 0,
          f"serve run launched fused_blur4 {launches} times")
    check(paths == {"tma": launches}, f"serve launches by path {paths}")
    check(not thread.is_alive(), "HTTP thread still running")
    print(f"serve: sample(1) {img1.shape}, sample(3) {img3.shape}, "
          f"decode z/p {dec_z.shape}, decode z+/p+ {dec_plus.shape} "
          f"(vs sample: max diff {diff.max()}, mean {diff.mean():.4f} "
          f"levels), edit_strip {strip.shape}, POST /sample "
          f"{http_img.shape}, GET /health {health}; fused_blur4 launches "
          f"{launches} {paths}", flush=True)
    return paths


# ---------------------------------------------------------------- phase 5

TRAIN_BATCH = 16                   # TrainConfig(batch_size=16): path batch 8
GRAD_BATCHES = (2, 16)             # backward held against plain
VARIANTS = {"plain": (False, False, False), "r1": (True, False, False),
            "path": (False, True, False), "r1+path": (True, True, False),
            "r1+path+spatial": (True, True, True)}


def blur_grads(fb, kernel: bool, x, scale, bias, gy, create_graph=False):
    """(leaves, their gradients of <blur(x, scale, bias), gy>) through the
    kernel's autograd.Function or through autograd of the plain version,
    scale + bias + activation, pad (1, 1)."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]
    fn = fb.fused_blur4 if kernel else fb.fused_blur4_plain
    y = fn(leaves[0], TAPS, (1, 1), scale=leaves[1], bias=leaves[2],
           act=True)
    return leaves, torch.autograd.grad(y, leaves, gy,
                                       create_graph=create_graph)


def off_the_kink(fb, gy, x, scale, bias):
    """``gy`` zeroed where the pre-activation lies within 1e-4 of 0.  The
    kernel takes the activation's slope from its own output and autograd
    of the plain version from its own pre-activation; float32 sums in two
    orders can put such an element on opposite sides of 0, and the two
    slopes then differ by 0.8 * sqrt(2), which no tolerance covers."""
    pre = fb.fused_blur4_plain(x.float(), TAPS, (1, 1), scale=scale.float(),
                               bias=bias)
    return gy * (pre.abs() >= 1e-4).to(gy.dtype)


def hold_grad(got, want, name: str, tag: str):
    """(max abs err, bf16 ulps, share of the largest magnitude).  A
    bfloat16 gradient: 2 ulps past 1e-5.  A float32 grad_x: 1e-5.  A
    float32 grad_scale / grad_bias (sums over H*W products): 1e-5 of its
    largest magnitude."""
    if got.dtype == torch.bfloat16 or name == "x":
        err, ulps = hold_to_plain(got, want.float(), f"grad_{name} {tag}")
        return err, ulps, 0.0
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    check(rel <= 1e-5, f"grad_{name} {tag}: {rel} of its largest")
    return err, 0.0, rel


def backward_vs_plain(fb, dev) -> dict:
    g = torch.Generator(dev).manual_seed(5)
    worst = {"x_err_f32": 0.0, "x_ulps_bf16": 0.0, "sb_rel_f32": 0.0,
             "sb_ulps_bf16": 0.0, "max_abs_err": 0.0}
    fb.launches.reset()
    n = 0
    for b in GRAD_BATCHES:
        for h, c in MAIN_SHAPES:
            x32 = torch.randn((b, h, h, c), generator=g, device=dev)
            s32 = torch.rand((b, c), generator=g, device=dev) + 0.5
            bias = torch.randn((c,), generator=g, device=dev)
            gy32 = torch.randn((b, h - 1, h - 1, c), generator=g, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                x, s = x32.to(dtype), s32.to(dtype)
                gy = off_the_kink(fb, gy32.to(dtype), x, s, bias)
                _, got = blur_grads(fb, True, x, s, bias, gy)
                _, want = blur_grads(fb, False, x, s, bias, gy)
                n += 1
                tag = f"{dtype} {[b, h, h, c]}"
                for name, a, w in zip(("x", "scale", "bias"), got, want):
                    check(a.dtype == w.dtype, f"grad_{name} {tag} dtype")
                    err, ulps, rel = hold_grad(a, w, name, tag)
                    worst["max_abs_err"] = max(worst["max_abs_err"], err)
                    if name == "x":
                        key = ("x_err_f32", err) if dtype == torch.float32 \
                            else ("x_ulps_bf16", ulps)
                    elif a.dtype == torch.bfloat16:
                        key = ("sb_ulps_bf16", ulps)
                    else:
                        key = ("sb_rel_f32", rel)
                    worst[key[0]] = max(worst[key[0]], key[1])
                del got, want
            del x32, s32, gy32
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    roles, paths = fb.launches.by_role, fb.launches.by_path
    check(roles == {"forward": n, "adjoint": n, "recompute": n},
          f"backward launches by role {roles}, {n} backwards")
    check(paths == {"tma": 3 * n}, f"backward launches by path {paths}")
    print(f"backward vs plain: {len(GRAD_BATCHES)} batches x "
          f"{len(MAIN_SHAPES)} shapes x 2 dtypes; grad_x max abs err f32 "
          f"{worst['x_err_f32']:.3e} (limit 1e-5), bf16 "
          f"{worst['x_ulps_bf16']:.3f} ulp (limit 2); grad_scale/grad_bias "
          f"f32 {worst['sb_rel_f32']:.3e} of their largest (limit 1e-5), "
          f"bf16 {worst['sb_ulps_bf16']:.3f} ulp; launches {roles} {paths}",
          flush=True)

    # one double-backward product per dtype: d<grad_x, v> + <grad_s, w>
    # / d(gy, scale, x), which runs each Function's own backward again
    b, (h, c) = 2, MAIN_SHAPES[2]
    x32 = torch.randn((b, h, h, c), generator=g, device=dev)
    s32 = torch.rand((b, c), generator=g, device=dev) + 0.5
    bias = torch.randn((c,), generator=g, device=dev)
    gy32 = torch.randn((b, h - 1, h - 1, c), generator=g, device=dev)
    v = torch.randn(x32.shape, generator=g, device=dev)
    w = torch.randn(s32.shape, generator=g, device=dev)
    double = {}
    for dtype in (torch.float32, torch.bfloat16):
        out = {}
        gy_d = off_the_kink(fb, gy32.to(dtype), x32.to(dtype),
                            s32.to(dtype), bias)
        for kernel in (True, False):
            gy = gy_d.clone().requires_grad_()
            (xl, sl, _), (gx, gs, _) = blur_grads(
                fb, kernel, x32.to(dtype), s32.to(dtype), bias, gy, True)
            inner = (gx.float() * v).sum() + (gs.float() * w).sum()
            out[kernel] = torch.autograd.grad(inner, [gy, sl, xl])
        share = 0.0
        for name, a, want in zip(("gy", "scale", "x"), out[True], out[False]):
            top = want.float().abs().max()
            err = (a.float() - want.float()).abs().max().item()
            limit = (1e-5 * top.item() if dtype == torch.float32
                     else 2 * bf16_ulp(top).item())
            check(err <= limit, f"double backward {dtype} d/d{name}: "
                                f"{err} > {limit}")
            share = max(share, err / max(top.item(), 1e-30))
        double[str(dtype).split(".")[-1]] = share
    print(f"double backward {[b, h, h, c]}: max err / largest magnitude "
          f"{double} (limits 1e-5 f32, 2 bf16 ulps of the largest)",
          flush=True)
    worst["double_backward"] = double
    return worst


def backward_times(fb, dev) -> list:
    """Per main-path shape at float32, batch 16 (training), scale + bias
    + act: device ms of the forward, adjoint and recompute launches (CUDA
    graph replay), and of the whole composed backward and its plain
    counterpart (events around autograd.grad calls)."""
    g = torch.Generator(dev).manual_seed(6)
    n_sm = fb._sm_count(torch.cuda.current_device())
    rows = []
    for h, c in MAIN_SHAPES:
        b, ho = TRAIN_BATCH, h - 1
        x = torch.randn((b, h, h, c), generator=g, device=dev)
        s = torch.rand((b, c), generator=g, device=dev) + 0.5
        bias = torch.randn((c,), generator=g, device=dev)
        gy = torch.randn((b, ho, ho, c), generator=g, device=dev)
        adj = fb.plan_tiles(b, ho, ho, c, torch.float32, (2, 2), n_sm=n_sm)
        fwd = fb.plan_tiles(b, h, h, c, torch.float32, (1, 1), n_sm=n_sm)
        check(adj.path == fwd.path == "tma",
              f"{[b, h, h, c]} f32 planned {fwd.path} / adjoint {adj.path}")
        times = {
            "forward_ms": device_ms(lambda: fb.fused_blur4(
                x, TAPS, (1, 1), scale=s, bias=bias, act=True)),
            "adjoint_ms": device_ms(lambda: fb.fused_blur4(
                gy, TAPS[::-1], (2, 2), scale=s)),
            "recompute_ms": device_ms(lambda: fb.fused_blur4(
                x, TAPS, (1, 1)))}
        for kernel, key, reps in ((True, "backward_ms", 10),
                                  (False, "plain_backward_ms", 3)):
            leaves = [t.clone().requires_grad_() for t in (x, s, bias)]
            fn = fb.fused_blur4 if kernel else fb.fused_blur4_plain
            y = fn(leaves[0], TAPS, (1, 1), scale=leaves[1],
                   bias=leaves[2], act=True)
            times[key] = time_ms(lambda: torch.autograd.grad(
                y, leaves, gy, retain_graph=True), reps=reps, warm=1)
            del y, leaves
        in_b, out_b = b * h * h * c * 4, b * ho * ho * c * 4
        epi_b = b * c * 4 + c * 4
        bound = {
            "forward_bound_ms": (in_b + out_b + epi_b) / HBM_BYTES_PER_S,
            "adjoint_bound_ms": (out_b + in_b + b * c * 4) / HBM_BYTES_PER_S,
            "recompute_bound_ms": (in_b + out_b) / HBM_BYTES_PER_S,
            # a fused backward reads gy, y and x, writes grad_x (+ grad_s,
            # grad_b): the least any backward moves
            "backward_bound_ms": (2 * out_b + 2 * in_b + epi_b)
            / HBM_BYTES_PER_S}
        row = {"in": [b, h, h, c], "adjoint_path": adj.path,
               **times, **{k: v * 1e3 for k, v in bound.items()}}
        rows.append(row)
        print(f"  fused_blur4 f32 {[b, h, h, c]}: forward "
              f"{times['forward_ms']:.4f} ms (bound "
              f"{row['forward_bound_ms']:.4f}), adjoint "
              f"{times['adjoint_ms']:.4f} ms on the {adj.path} path (bound "
              f"{row['adjoint_bound_ms']:.4f}), recompute "
              f"{times['recompute_ms']:.4f} ms; composed backward "
              f"{times['backward_ms']:.4f} ms (fused bound "
              f"{row['backward_bound_ms']:.4f}), plain backward "
              f"{times['plain_backward_ms']:.4f} ms", flush=True)
        del x, s, bias, gy
        torch.cuda.empty_cache()
    return rows


def synthetic_batches(n: int, batch: int, size: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (batch, size, size, 3)).astype(np.uint8)
            for _ in range(n)]


def train_phase(fb, dev, out_root: pathlib.Path, **cfg_kw) -> dict:
    """``cfg_kw`` narrows the model for a CPU rehearsal; none on the card."""
    from transeditor_tpu_torch.config import ModelConfig, TrainConfig
    from transeditor_tpu_torch.train.gan import init_state, make_train_step
    from transeditor_tpu_torch.train.loop import train

    cfg = ModelConfig(**cfg_kw)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, d_reg_every=2, g_reg_every=3,
                       n_sample=16, sample_every=4, checkpoint_every=1000)
    state = init_state(cfg, tcfg, seed=0, device=dev)
    batches = synthetic_batches(5, TRAIN_BATCH, cfg.size)
    run = dict(out_dir=str(out_root), exp_name="train", state=state,
               device=dev, log_every=1)

    torch.cuda.synchronize()
    fb.launches.reset()                      # the main path starts here
    t0 = time.perf_counter()
    state = train(cfg, tcfg, iter(batches[:4]), start_step=2, max_steps=4,
                  **run)
    run["state"] = state
    state = train(cfg, dataclasses.replace(tcfg, spatial_regu=True),
                  iter(batches[4:]), start_step=6, max_steps=1, **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fb.launches.by_role_path         # ... and ends here

    log = out_root / "train" / "log" / "metrics.jsonl"
    lines = [json.loads(s) for s in log.read_text().splitlines()]
    check([r["step"] for r in lines] == [2, 3, 4, 5, 6],
          f"logged steps {[r['step'] for r in lines]}")
    for r in lines:
        check(all(np.isfinite(v) for v in r.values()), f"step {r}")
        i = r["step"]
        check((r["r1"] > 0) == (i % 2 == 0), f"r1 at step {i}: {r['r1']}")
        check((r["path_length"] > 0) == (i % 3 == 0),
              f"path length at step {i}: {r['path_length']}")
        check((r["spatial_path_length"] > 0) == (i == 6),
              f"spatial path length at step {i}")
    check((out_root / "train" / "sample" / "000004.png").stat().st_size > 0,
          "no sample grid at step 4")
    paths = {p for by in counts.values() for p in by}
    check(paths == {"tma"}, f"train launches by role and path {counts}")
    check(all(counts.get(r) for r in ("forward", "adjoint", "recompute")),
          f"train launches by role {counts}")
    main_launches = counts
    print(f"train: {cfg.size}px f32 batch {TRAIN_BATCH}, steps 2-6 through "
          f"train() in {wall:.2f} s; losses finite; fused_blur4 launches "
          f"{counts}", flush=True)
    for r in lines:
        print(f"  step {r['step']}: d {r['d']:.4f} g {r['g']:.4f} r1 "
              f"{r['r1']:.4f} path {r['path']:.4f} path_length "
              f"{r['path_length']:.4f} spatial_path_length "
              f"{r['spatial_path_length']:.4f}", flush=True)

    # ms per step by variant, and launches per step by role and path
    step = make_train_step(cfg, tcfg, device=dev)
    rng = torch.Generator(dev)
    real = torch.from_numpy(batches[0]).to(dev)
    torch.cuda.reset_peak_memory_stats()
    variants = {}
    for name, (dr, gr, sr) in VARIANTS.items():
        flags = dict(do_d_reg=dr, do_g_reg=gr, do_spatial_reg=sr)
        rng.manual_seed(1)
        step(state, real, rng, **flags)                     # warm
        ms = []
        for k in range(2):
            torch.cuda.synchronize()
            fb.launches.reset()
            t1 = time.perf_counter()
            state, m = step(state, real, rng, **flags)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            if k == 0:
                launches = fb.launches.by_role_path
        check(all(bool(torch.isfinite(v)) for v in m.values()),
              f"{name}: {m}")
        variants[name] = {"ms": ms, "launches": launches}
        print(f"train step {name}: {ms[0]:.1f} / {ms[1]:.1f} ms; fused_blur4 "
              f"launches {launches}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"train: peak memory allocated {peak / 2**30:.2f} GiB",
          flush=True)
    del state, step
    torch.cuda.empty_cache()
    return {"steps_s": wall, "main_launches": main_launches,
            "variants": variants, "peak_bytes": peak, "losses": lines}


def _grad_errors(run, ref) -> dict:
    """Per optimizer, for Adam's first moment (the last phase's gradient:
    beta1 is 0) and the root of its second moment (an RMS over the
    step's phases): the worst per-tensor |a - b|_2 / |b|_2 and the worst
    |a - b|_max / |b|_max, each with its tensor.  A tensor whose gradient
    is 0 in exact arithmetic (an attention key bias: softmax ignores a
    shift) is measured against 1e-6 of its optimizer's largest."""
    out = {}
    for what, opt_a, opt_b, mod_a, mod_b in (
            ("G", run.opt_g, ref.opt_g, run.g, ref.g),
            ("D", run.opt_d, ref.opt_d, run.d, ref.d)):
        for key, fn in (("exp_avg", lambda t: t),
                        ("exp_avg_sq", torch.sqrt)):
            want = [fn(opt_b.state[p][key]) for p in mod_b.parameters()]
            got = [fn(opt_a.state[p][key].cpu()) for p in mod_a.parameters()]
            names = [n for n, _ in mod_b.named_parameters()]
            top2 = max(w.norm().item() for w in want)
            topm = max(w.abs().max().item() for w in want)
            l2 = max(((a - b).norm().item() / max(b.norm().item(),
                                                  1e-6 * top2), n)
                     for n, a, b in zip(names, got, want))
            mx = max(((a - b).abs().max().item()
                      / max(b.abs().max().item(), 1e-6 * topm), n)
                     for n, a, b in zip(names, got, want))
            out[f"{what} {key}"] = {"l2": l2[0], "l2_at": l2[1],
                                    "max": mx[0], "max_at": mx[1]}
    return out


def train_card_vs_cpu(fb, dev) -> dict:
    """One reg step (R1 + path length) of a 64px model on the card and on
    the CPU, same weights and draws.  The checked card run computes its
    convolutions without cuDNN, whose float32 algorithms (FFT among them)
    put the discriminator's bias gradients ~2e-4 off the CPU's; the same
    step with cuDNN, and with the plain version in place of the kernel,
    is reported beside it.

    At lr 0, so that every phase on both devices starts from the same
    weights: at lr > 0 Adam moves each parameter by about lr whatever the
    size of its gradient, so a gradient near 0 whose sign differs sends
    the next phase off from other weights.

    The limits are set by what float32 rounding alone does to this step:
    a second CPU step whose latents and real images are scaled by
    1 + 2**-22 (one or two float32 ulps).  The path-length gradient is so
    sensitive that this moves some of its tensors by ~0.5% in the L2
    norm (a leaky ReLU whose input lies within rounding of 0 changes its
    slope), so 1e-4 alone is out of reach for any two implementations.
    Each metric and, per optimizer and moment, the worst per-tensor L2
    error of the card must lie within 3x that rounding floor, or 1e-4
    relative where the floor is smaller."""
    from transeditor_tpu_torch.config import ModelConfig, TrainConfig
    from transeditor_tpu_torch.ops import modconv
    from transeditor_tpu_torch.train.gan import init_state, make_train_step

    cfg = ModelConfig(size=64, max_channels=128, n_trans=2)
    tcfg = TrainConfig(batch_size=4, lr=0.0)
    g = torch.Generator().manual_seed(7)

    def zp(b):
        return [torch.randn((b, 16, 512), generator=g) for _ in "zp"]

    def noise(b):
        return torch.randn((b, 64, 64, 3), generator=g) / 64
    draws = {"d": zp(4), "g": zp(4), "path": [*zp(2), noise(2)],
             "spatial": [*zp(2), noise(2)]}
    real = torch.from_numpy(synthetic_batches(1, 4, 64, seed=8)[0])
    real = real.float() / 127.5 - 1.0

    def run(d, scale=1.0):
        state = init_state(cfg, tcfg, seed=3, device=d)
        step = make_train_step(cfg, tcfg, device=d)
        scaled = {k: [t * scale for t in v[:2]] + v[2:]
                  for k, v in draws.items()}
        return step(state, real * scale, torch.Generator(d), do_d_reg=True,
                    do_g_reg=True, draws=scaled)

    cpu, m_cpu = run(torch.device("cpu"))
    nudged, m_nudged = run(torch.device("cpu"), 1.0 + 2.0 ** -22)
    with_cudnn, _ = run(dev)
    torch.backends.cudnn.enabled = False
    try:
        fb.launches.reset()
        card, m_card = run(dev)
        torch.cuda.synchronize()
        roles = fb.launches.by_role
        modconv.fused_blur4 = fb.fused_blur4_plain
        plain, _ = run(dev)
    finally:
        modconv.fused_blur4 = fb.fused_blur4
        torch.backends.cudnn.enabled = True
    metrics = {k: {"card": float(m_card[k]), "cpu": float(m_cpu[k]),
                   "nudged_cpu": float(m_nudged[k])} for k in m_cpu}
    errs = {"kernel": _grad_errors(card, cpu),
            "kernel_with_cudnn": _grad_errors(with_cudnn, cpu),
            "plain": _grad_errors(plain, cpu),
            "rounding_floor": _grad_errors(nudged, cpu)}

    def fmt(e):
        return {k: f"l2 {v['l2']:.2e} ({v['l2_at']}), max {v['max']:.2e} "
                   f"({v['max_at']})" for k, v in e.items()}
    print(f"train step card vs CPU (64px, R1 + path length, batch 4, lr 0): "
          f"metrics {metrics}; gradients, worst per tensor: kernel, no "
          f"cuDNN {fmt(errs['kernel'])}; kernel with cuDNN (not checked) "
          f"{fmt(errs['kernel_with_cudnn'])}; the plain version on the "
          f"card, no cuDNN {fmt(errs['plain'])}; rounding floor (CPU, inputs x (1 + "
          f"2**-22)) {fmt(errs['rounding_floor'])}; launches {roles}",
          flush=True)
    check(all(roles.get(r) for r in ("forward", "adjoint", "recompute")),
          f"card-vs-CPU step launches by role {roles}")
    for k, m in metrics.items():
        err, floor = abs(m["card"] - m["cpu"]), abs(m["nudged_cpu"] - m["cpu"])
        check(err <= max(3 * floor, 1e-4 * abs(m["cpu"]) + 1e-6),
              f"metric {k}: {m}")
    for tag, e in errs["kernel"].items():
        limit = max(3 * errs["rounding_floor"][tag]["l2"], 1e-4)
        check(e["l2"] <= limit, f"{tag} {e['l2_at']}: L2 {e['l2']} > {limit}")
    return {"metrics": metrics, "grad_errors": errs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from transeditor_tpu_torch.ops import cuda_build
    from transeditor_tpu_torch.ops import fused_blur as fb

    dev = torch.device("cuda")
    started = time.time()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    fb.build()
    print(f"built {cuda_build.library_path('fused_blur4').name} in "
          f"{time.time() - t0:.1f} s", flush=True)
    log = cuda_build.library_path("fused_blur4").with_suffix(".so.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    errs = kernel_vs_plain(fb, dev)
    # host-clock measurements first: once torch.profiler has run, the
    # process keeps paying for its tracing on every launch
    host_us = wrapper_host_us(fb, dev)
    g, gen = generator_phase(fb, dev, card)
    rows = kernel_times(fb, dev)
    gen["profile"] = [profile_forward(g, dev, b) for b in (1, 64)]
    paths = serve_phase(fb, dev, g)
    del g
    torch.cuda.empty_cache()
    grad_errs = backward_vs_plain(fb, dev)
    brows = backward_times(fb, dev)
    out_root = pathlib.Path(__file__).resolve().parent / "build" / "smoke"
    try:
        trained = train_phase(fb, dev, out_root)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    trained["card_vs_cpu"] = train_card_vs_cpu(fb, dev)
    train_counts = trained["variants"]   # per step, by role and path

    def total(by_role_path):
        return sum(n for by in by_role_path.values() for n in by.values())

    def summed(key):
        return sum(r[key] for r in brows)

    kernel = {
        "name": "fused_blur4", "route": "cuda",
        "source": "transeditor_tpu_torch/csrc/fused_blur4.cu",
        "replaces": "transeditor_tpu/ops/pallas_blur.py:131",
        # the two main paths, each counted from 0: serving and training
        "launches": sum(paths.values()) + total(trained["main_launches"]),
        "path_launches": paths,
        "train_launches": trained["main_launches"],
        "launches_per_train_step": {k: v["launches"]
                                    for k, v in train_counts.items()},
        "max_abs_err": max(errs["max_err_f32"], errs["max_err_bf16"],
                           grad_errs["max_abs_err"],
                           *(r["max_abs_err"] for r in rows)),
        "max_err_f32": errs["max_err_f32"],
        "max_err_bf16": max(errs["max_err_bf16"],
                            *(r["max_abs_err"] for r in rows)),
        # device time per launch, TMA path, by CUDA graph replay
        "ms": sum(r["ms"] for r in rows),
        "general_path_ms": sum(r["general_path_ms"] for r in rows),
        "wrapper_ms": sum(r["wrapper_ms"] for r in rows),
        "wrapper_host_us": host_us,
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "share_of_bound": sum(r["bound_ms"] for r in rows)
        / sum(r["ms"] for r in rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        # no single PyTorch call computes blur + scale + bias + lrelu;
        # the yardstick is one depthwise F.conv2d computing the blur alone
        "library_ms": None,
        "depthwise_conv_ms": sum(r["depthwise_conv_ms"] for r in rows),
        "launches_per_forward": 6,
        "timed": f"bf16, batch {TIME_BATCH}, six main-path shapes summed",
        "shapes": rows,
        # the backward: f32, batch 16, six main-path shapes summed; the
        # launches by graph replay, the composed backward by events
        "backward_ms": summed("backward_ms"),
        "backward_bound_ms": summed("backward_bound_ms"),
        "plain_backward_ms": summed("plain_backward_ms"),
        "adjoint_ms": summed("adjoint_ms"),
        "adjoint_bound_ms": summed("adjoint_bound_ms"),
        "recompute_ms": summed("recompute_ms"),
        "recompute_bound_ms": summed("recompute_bound_ms"),
        "forward_f32_ms": summed("forward_ms"),
        "forward_f32_bound_ms": summed("forward_bound_ms"),
        "backward_errors": grad_errs,
        "backward_shapes": brows,
    }
    print(json.dumps({"generator": gen}), flush=True)
    print(json.dumps({"train": trained}), flush=True)
    print(f"chip_smoke: all phases in {time.time() - started:.1f} s",
          flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
