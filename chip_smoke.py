#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py          # from the root of a checkout

Phases; any failure exits nonzero before the result lines are printed:

  1. card: name and power limit (nvidia-smi); build the CUDA kernel from
     transeditor_tpu_torch/csrc/ and print the build seconds;
  2. kernel vs plain: ``fused_blur4`` against ``fused_blur4_plain`` on
     the card at the six shapes of a 256px forward and at odd shapes, in
     float32 (limit 1e-5) and bfloat16 (limit 2 bf16 ulps of the plain
     result computed in float32, beyond the 1e-5 float32 allowance that
     matters only next to zero), without epilogue, with scale, and with
     scale + bias + activation; then CUDA-event times at batch 64 in
     bfloat16 beside the bound from the bytes moved;
  3. generator: the full-width 256px ``ModelConfig()`` with seeded random
     weights, bf16 at batch 8 (finite, 6 kernel launches per forward);
     float32 at batch 2 on the card vs the same weights and codes on the
     CPU (plain path); img/s at batches 1 / 8 / 64; device time by
     kernel for one forward at batches 1 and 64 (torch.profiler);
  4. serve (the main path, counted): an ``InferenceEngine`` on the card,
     warmed to batch 8, answers concurrent sample / decode / edit_strip
     requests and one HTTP ``POST /sample`` + ``GET /health``.  The
     kernel's launch count is set to 0 just before and read just after.

The last three lines are the card line, the kernels line and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
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
             ((2, 12, 9, 8), (2, 1))]
TIME_BATCH = 64


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

def kernel_vs_plain(fb, dev) -> dict:
    g = torch.Generator(dev).manual_seed(0)
    cases = [((2, h, h, c), (1, 1)) for h, c in MAIN_SHAPES] + ODD_CASES
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_ulps = 0.0
    for shape, pad in cases:
        b, c = shape[0], shape[-1]
        x32 = torch.randn(shape, generator=g, device=dev)
        scale = torch.rand((b, c), generator=g, device=dev) + 0.5
        bias = torch.randn((c,), generator=g, device=dev)
        for epi in ({}, {"scale": scale},
                    {"scale": scale, "bias": bias, "act": True}):
            want = fb.fused_blur4_plain(x32, TAPS, pad, **epi)
            got = fb.fused_blur4(x32, TAPS, pad, **epi)
            e32 = (got - want).abs().max().item()
            check(e32 <= 1e-5, f"f32 {shape} {sorted(epi)}: err {e32}")
            xb = x32.to(torch.bfloat16)
            want = fb.fused_blur4_plain(xb.float(), TAPS, pad, **epi)
            got = fb.fused_blur4(xb, TAPS, pad, **epi).float()
            diff = (got - want).abs()
            # bf16 rounding, plus the f32 sum-order allowance near zero
            ulps = ((diff - 1e-5).clamp_min(0) / bf16_ulp(want)).max().item()
            check(ulps <= 2.0, f"bf16 {shape} {sorted(epi)}: {ulps} ulps")
            err[torch.float32] = max(err[torch.float32], e32)
            err[torch.bfloat16] = max(err[torch.bfloat16],
                                      diff.max().item())
            worst_ulps = max(worst_ulps, ulps)
    torch.cuda.synchronize()
    print(f"kernel vs plain: {len(cases)} shapes x 3 epilogues x 2 dtypes; "
          f"max abs err f32 {err[torch.float32]:.3e} (limit 1e-5), "
          f"bf16 {err[torch.bfloat16]:.3e} = {worst_ulps:.3f} ulp "
          f"(limit 2 ulp)", flush=True)
    return {"max_err_f32": err[torch.float32],
            "max_err_bf16": err[torch.bfloat16], "max_bf16_ulps": worst_ulps}


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
        ms = time_ms(lambda: fb.fused_blur4(x, TAPS, (1, 1), **epi))
        plain = time_ms(lambda: fb.fused_blur4_plain(x, TAPS, (1, 1), **epi),
                        reps=5)
        conv = time_ms(lambda: F.conv2d(xc, wdw, padding=1, groups=c))
        ho = h - 1
        nbytes = (b * h * h * c + b * ho * ho * c) * 2 + b * c * 2 + c * 4
        flops = b * ho * ho * c * 20       # 8 FMAs + scale, bias, lrelu
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        rows.append({"in": [b, h, h, c], "ms": ms, "plain_ms": plain,
                     "depthwise_conv_ms": conv, "bound_ms": bound,
                     "bytes": nbytes,
                     "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                  >= flops / F32_FLOPS_PER_S
                                  else "operations")})
        print(f"  fused_blur4 bf16 {[b, h, h, c]}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, depthwise F.conv2d (blur alone) "
              f"{conv:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB at 3.35 TB/s)", flush=True)
        del x, xc
    torch.cuda.empty_cache()
    return rows


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
    n = fb.launches.value
    check(n == ups, f"fused_blur4 launched {n} times in one forward, "
                    f"not {ups}")
    check(tuple(out.image.shape) == (8, size, size, 3), str(out.image.shape))
    check(out.image.dtype == torch.bfloat16, str(out.image.dtype))
    check(bool(torch.isfinite(out.image.float()).all()), "non-finite image")
    print(f"generator bf16 batch 8: image {tuple(out.image.shape)} finite, "
          f"fused_blur4 launches per forward {n}", flush=True)

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

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    # kernels only: CPU-side ops also carry the device time they launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in events)
    events.sort(key=dev_us, reverse=True)
    rows = [{"name": e.key[:60], "calls": e.count, "ms": dev_us(e) / 1e3}
            for e in events[:top]]
    print(f"profile bf16 batch {batch}: device busy {busy_us / 1e3:.3f} ms "
          f"of {wall_us / 1e3:.3f} ms wall ({busy_us / wall_us:.1%})",
          flush=True)
    for r in rows:
        print(f"  {r['ms']:9.3f} ms  x{r['calls']:<4d} {r['name']}",
              flush=True)
    return {"batch": batch, "busy_ms": busy_us / 1e3,
            "wall_ms": wall_us / 1e3, "top": rows}


# ---------------------------------------------------------------- phase 4

def serve_phase(fb, dev, g) -> int:
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
    check(not thread.is_alive(), "HTTP thread still running")
    print(f"serve: sample(1) {img1.shape}, sample(3) {img3.shape}, "
          f"decode z/p {dec_z.shape}, decode z+/p+ {dec_plus.shape} "
          f"(vs sample: max diff {diff.max()}, mean {diff.mean():.4f} "
          f"levels), edit_strip {strip.shape}, POST /sample "
          f"{http_img.shape}, GET /health {health}; fused_blur4 launches "
          f"{launches}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from transeditor_tpu_torch.ops import cuda_build
    from transeditor_tpu_torch.ops import fused_blur as fb

    dev = torch.device("cuda")
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
    rows = kernel_times(fb, dev)
    g, gen = generator_phase(fb, dev, card)
    gen["profile"] = [profile_forward(g, dev, b) for b in (1, 64)]
    launches = serve_phase(fb, dev, g)

    kernel = {
        "name": "fused_blur4", "route": "cuda",
        "source": "transeditor_tpu_torch/csrc/fused_blur4.cu",
        "replaces": "transeditor_tpu/ops/pallas_blur.py:131",
        "launches": launches,
        "max_abs_err": max(errs["max_err_f32"], errs["max_err_bf16"]),
        "max_err_f32": errs["max_err_f32"],
        "max_err_bf16": errs["max_err_bf16"],
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        # no single PyTorch call computes blur + scale + bias + lrelu;
        # the yardstick is one depthwise F.conv2d computing the blur alone
        "library_ms": None,
        "depthwise_conv_ms": sum(r["depthwise_conv_ms"] for r in rows),
        "launches_per_forward": 6,
        "timed": f"bf16, batch {TIME_BATCH}, six main-path shapes summed",
        "shapes": rows,
    }
    print(json.dumps({"generator": gen}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
