#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py          # from the root of a checkout

Phases; any failure exits nonzero before the result lines are printed.
Everything timed by the host clock comes before the first use of
torch.profiler (the order is at the end of this list).

  1. card: name and power limit (nvidia-smi); build the CUDA kernels from
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
  6. the command-line training path (a main path, counted), in
     build/smoke, removed at the end, on the JPEG / LMDB data path: the
     port's own codec (``csrc/jpeg.cpp``) and LMDB runtime
     (``csrc/teio.cpp``), built with g++ alone (no image library).
  6a. data: 64 seeded 256px images (and 16 at 1024px) written as PNG
     with adaptively filtered rows, as libpng and PIL write them; teio
     built with g++ (seconds printed), ``cli.prepare_data`` to an LMDB
     of JPEGs, every record against its source (PSNR >= 40 dB), the
     ``NativeLMDBLoader``'s img/s with 1 and cpu_count - 1 workers; the
     PNG folder iterator's img/s (cpu_count - 1 reader threads), at
     256px and from the 1024px sources resized on read; batch 16;
  6b. ``cli.train_gan.main`` in this process on that LMDB at full width
     (f32, batch 16, R1 every 2, path length every 3) for steps 0-3,
     then ``--resume`` to step 6: the log continues at 4, every metric
     finite, launches by role and path all on the TMA path; ms per step
     by variant and each step's share of time waiting for data;
  6c. ``multihost.initialize()`` on NCCL with a world of 1 and two
     R1 + path steps with every collective forced to run (a group of one
     runs none), through ``all_reduce_grads``, against the same steps
     without a process group (Adam moments within 1e-5 of each tensor's
     largest); the all-reduce's ms per step;
  6d. ``engine_from_checkpoint(state_dir=...)`` on 6b's state (equal to
     its g_ema) and an HTTP ``POST /sample`` (``jpeg_b64``, PSNR >= 35 dB
     against the array answer), counted;
  6e. the codec held to libjpeg-turbo without libjpeg: SHA-256 digests,
     computed with libjpeg-turbo 2.1.5 and committed here, of the
     encoder's bytes (seeded images at qualities 1, 50, 95 and 100, two
     odd sizes) and of the pixels libjpeg decodes from five small JPEGs
     PIL wrote (progressive with optimised tables, 4:4:4, 4:2:2,
     grayscale, restart markers every 2 MCUs), embedded below; every
     digest must match.  Then, single-threaded, the µs to decode one
     image at 256px and at 1024px and to encode one at 256px, printed
     with 6a's loader rates, prepare_data's seconds and 6b's data-wait
     share, beside the card's name and power limit.
  6f. every image form the JAX package reads through PIL, read here
     with no image library (``utils/image.py``, ``csrc/webp.cpp``,
     ``csrc/jpeg.cpp``): 6f-1 each fixture of ``tests/image_forms``
     (WebP lossy, lossless, with ALPH, animated, and libwebp's encoder
     settings; PNG in every colour type x depth x interlace; CMYK and
     YCCK JPEG) decoded, the SHA-256 of its pixels equal to PIL's
     (``digests.json``); 6f-2 those files as a dataset, resized to 256
     on read: ``cli.prepare_data`` to an LMDB (every record >= 40 dB from
     its source as the port reads it), then ``cli.train_gan.main`` on it
     at full width (f32, batch 16, two steps: R1 + path, plain), every
     metric finite, launches by role and path all on the TMA path (a
     main path, counted); 6f-3 single-threaded, the µs to decode a 256px
     lossy q75 WebP, a 256px lossless WebP and a 256px 4:2:0 CMYK JPEG
     (100 reps each), beside the card's name and power limit.

  7. inversion (``invert/projector.py``, ``cli/project.py``):
  7a. the projector at full width (the main path, counted): the 256px
     ``ModelConfig()`` in float32 with seeded random weights and a seeded
     random VGG LPIPS, the target the generator's own image for seeded
     latents; ``estimate_latent_stats`` on its 10k draws; a warm call,
     then 60 steps at batch 8 (the lr ramps up and down): ms per step by
     the host clock between synchronised steps, the perceptual loss's
     first and last values (it must fall), launches by role and path
     (6 forward, 6 adjoint, 6 recompute a step, all TMA, and 6 forward
     for the final decode), peak memory, the step's flop count (bound at
     67 TFLOP/s).  It runs right after phase 3, before the first
     torch.profiler window; after phase 6 the same setup is built again
     for its profile (top kernels, device-busy share of a 3-step call)
     and its layer split (events: the generator half, the LPIPS half),
     7b and 7c;
  7b. one full-width projector step: each of its 18 launches replayed
     through ``fused_blur4_plain`` on its own inputs (1e-5 of the plain
     output's largest magnitude); and its gradients in z+ and p+ against
     the same step with ``fused_blur._blur`` replaced by
     ``fused_blur4_plain``, the LPIPS image pinned to the plain run's in
     both, within 3x a rounding floor (the largest change of the kernel
     run with z+ and p+ scaled by 1 + 2**-22, 1 - 2**-22 or 1 + 2**-21)
     or 1e-4 (L2, relative), a coarse hold: the generator's leaky-ReLU
     kinks make the gradient itself move that much under one ulp;
  7c. ``cli.project.main`` (a main path, counted) on 9 PNGs with
     ``--step 10 --batch 8``, so the tail batch of 1 is padded: every
     output file, latents (9, 16, 512), the tail's own row kept.

  8. encoder inversion (``train/coach.py``, ``cli/train_encoder.py``,
     ``cli/encode.py``):
  8a. the coach at full width (the main path, counted): the 256px
     ``ModelConfig()`` decoder in float32 with seeded random weights, a
     seeded random AlexNet LPIPS and IR-SE-50 ArcFace (the ID loss), the
     default ``GradualStyleEncoder`` (IR-SE-50, 14 + 16 heads, 364.7M
     parameters), ``CoachConfig()`` at batch 8 with ``use_fake_lambda
     0.5``, on the decoder's own images for seeded latents: a warm train,
     fake and eval step, then 10 train steps (both RAdam branches) timed
     by the host clock between synchronised steps, one fake and one eval
     step, launches by role and path (6 forward, 6 adjoint, 6 recompute
     a train step; 6 forward a fake step, for its no-grad decode only; 6
     forward an eval step; all TMA), peak memory, ``DualSpaceEncoder.
     encode`` img/s at batch 8, the step's flop count (bound at 67
     TFLOP/s).  It runs right after 7a, before the first torch.profiler
     window; after phase 7 the setup is built again for its profile (one
     train step: busy share, top kernels), 8b and 8c;
  8b. each of one full-width train step's 18 launches replayed through
     ``fused_blur4_plain`` on its own inputs (1e-5 of the plain output's
     largest); and one coach step of a 64px decoder and the default
     encoder on the card (the kernel, no cuDNN) against the CPU (the
     plain version): encoder gradients within 3x a rounding floor (the
     CPU step with the images x (1 + 2**-22)) or 1e-4 (worst per-tensor
     L2), the parameters after the step within 0.1 lr;
  8c. ``cli.train_encoder.main`` (a main path, counted) on 9 PNGs for 4
     steps at batch 8 with ``--val_interval 2 --save_interval 2``
     (``best_model.pt``, ``ckpt_000002.pt``, two validation grids), then
     ``cli.encode.main --save_inversions`` from that ``best_model.pt`` at
     batch 8 (a tail of 1): encoded (9, 16, 512), every PNG, counted.

  9. editing (``edit/``, ``cli/edit.py``, ``cli/edit_eval.py``), in
     build/smoke_edit, removed at the end; random reference-layout
     checkpoints (DEX age VGG16, pose resnet18, CelebA-HQ Smiling, IR-SE-50
     ArcFace) drawn from seeded generators:
  9a. the scoring sweep (a main path, counted): ``collect_scored_latents``
     of 3,200 samples at batch 64, the 256px ``ModelConfig()`` generator
     in bf16 with seeded random weights, the DEX age net loaded through
     ``load_scorer_from_checkpoint``: img/s scored (host clock), each
     batch's decode and score (events), the DEX flops a batch and its
     float32 bound, peak memory, the 150k protocol's card time
     extrapolated; one batch of the pose and the CelebA-HQ scorers (events).
     It runs right after 8a, before the first torch.profiler window;
     after phase 8 a scored batch is profiled (top kernels, busy share);
  9b. ``train_boundary`` at the protocol's size ([6000, 8192] latents,
     ``chosen_ratio=3000``: 2,100 + 2,100 training rows) on the card
     (seconds, iterations, KKT gap), the same rows solved on the CPU, the
     normals' cosine (1 - cosine within 1e-6); right after 9a;
  9c. ``edit_sample`` at 61 steps over the three spaces (a main path,
     counted) with 9b's normal: ms per edited sample; one strip decode's
     6 launches replayed through ``fused_blur4_plain``: bf16 within 2
     ulps beyond 1e-5, and a float32 generator of the same weights within
     1e-5 of the plain output's largest;
  9d. the three classifiers' scores card vs CPU on the same f32 images
     (1e-4 of the largest);
  9e. ``cli.edit.main`` at its defaults but ``--num_sample 640
     --n_edit_samples 2`` (a random DEX, as without ``--classifier_ckpt``),
     then ``--encoded_z/p`` (saved random codes) from the cached boundaries,
     each counted; ``cli.edit_eval.main`` on the sampled strips with the age
     and pose classifiers, ``--arcface`` and ``--boundaries``: file trees
     and a finite report.

  10. metrics (``metrics/``, ``cli/{calc_stats,evaluate,img_metrics}.py``),
     in build/smoke_metrics, removed at the end; the 256px
     ``ModelConfig()`` generator in bf16 with seeded random weights saved
     as a reference ``.pt``, and random reference-layout checkpoints drawn
     from seeded generators (a pytorch-fid InceptionV3 and a torchvision
     VGG16 with He-scaled layers, richzhang AlexNet and VGG LPIPS, an
     IR-SE-50 ArcFace), loaded through the port's loaders:
  10a. ``evaluate_fid`` of 3,200 samples at batch 64 (a main path,
     counted): img/s without the host's 2,048-wide Fréchet distance (its
     seconds apart), each batch's decode and Inception ms (events),
     InceptionV3's flops a batch and its float32 bound, peak memory, the
     69k protocol's card time.  It runs right after 9b, before the first
     torch.profiler window; after phase 9 the setup is built again from
     its files, one FID batch is profiled (top kernels, busy share), and
     one FID batch decode's 6 launches are replayed through
     ``fused_blur4_plain`` (bf16 within 2 ulps beyond 1e-5, a float32
     generator of the same weights within 1e-5 of the largest), and
     InceptionV3 features of 4 images are held card vs CPU (1e-4 of the
     largest);
  10b. ``compute_prdc`` at the protocol's 50,000 x 4,096 a side (seeded
     Gaussian features made on the card): seconds against the bound of
     its three distance passes, peak memory; at 4,000 x 512 card vs CPU
     (equal); ``evaluate_prdc`` of 512 decodes against 512 seeded smooth
     PNGs (a main path, counted): img/s on each side;
  10c. ``compute_ppl`` (space all, plus space, crop) over 640 pairs at
     batch 64 (a main path, counted): ms a batch in bf16; on the same
     endpoints the distances of the bf16 generator and of a float32 one
     of the same weights, their percentile means; f32 distances at eps
     1e-2 card vs CPU (1e-3);
  10d. ``evaluate_lpips_diversity`` with 2 rounds (6 groups of 40; a main
     path, counted): ms a group;
  10e. ``cli.calc_stats`` (256 images), ``cli.evaluate --fid --lpips --ppl
     --prdc`` at small counts (counted), ``cli.img_metrics`` in its three
     modes, ``cli.edit_eval --id_inception``: file trees, report text and
     finite values.

  11. the int8 mode (``ops/quant.py``; its two kernel paths
     ``csrc/conv2d_int8_wgmma.cu``, "wgmma", and ``csrc/conv2d_int8.cu``,
     "general", chosen per geometry by ``quant.plan_conv``):
  11a. ``conv2d_int8`` against ``conv2d_int8_plain`` on the card at the 13
     quantised convs of a 256px forward at batch 2 and at odd cases, with
     int32, float32 and bfloat16 out: bit-equal (``torch.equal``; integer
     sums are exact), each case on the path the plan names for it and
     printed with it -- on the general path C = 20 and 6, the stride-2
     pad-0 downsample, a 1x1 kernel; on the wgmma path batch 1 with H
     odd, Ip 32 from 20 channels, a ragged M and N, a split-K shape;
  11b. per main-path shape at batch 64, bf16 out: both paths bit-equal
     again; the wgmma kernel's and the earlier (general-path) kernel's
     device time (CUDA graph replay), TOP/s and share of the bound
     (useful MACs at 1,979 TOP/s, bytes at 3.35 TB/s); the plain float64
     version's time; as yardsticks of other functions, cuDNN's bf16
     ``F.conv2d`` / ``F.conv_transpose2d`` of the same shape and
     ``torch._int_mm`` of the same-sized int8 GEMM (per phase, summed);
     the wrapper's host time per call (host clock over enqueues);
  11c. the int8 main path (counted): the full-width 256px
     ``ModelConfig(dtype="bfloat16", quantize="int8")`` with seeded random
     weights (ToRGB at 1/32, as phase 10): 13 ``conv2d_int8`` launches a
     forward, all on the wgmma path, and 6 ``fused_blur4`` launches, all
     TMA; its PSNR against the
     unquantised bf16 and f32 images of the same weights; the f32 int8
     image card vs CPU (PSNR >= 35 dB: isolated rounding flips of the
     quantised activations); int8 img/s at batches 1 / 8 / 64 beside
     bf16; an ``InferenceEngine`` on the int8 config answering sample /
     decode requests, its launches of both kernels counted.
  11d. (after 3b) device time by kernel for one int8 forward at batch
     64 (torch.profiler): conv2d_int8, fused_blur4 and the rest.
  12. the remaining CLIs, in build/smoke_cli, removed at the end: a
     reference ``.pt`` of the seeded random generator and discriminator;
     ``cli.export_pt --ckpt`` (a round trip, tensors equal) and
     ``--state_dir`` of a one-step ``train()`` state (equal to it);
     ``cli.visualize --sample --swap_z --swap_p --interp --dat_interp``
     at small counts (a main path, counted: file tree, no one-colour
     grid, every launch on the TMA path); ``run_similarity``'s heatmaps;
     ``cli.align --landmarks`` on 8 seeded synthetic 1024px PNGs (file
     tree, seconds); ``utils.profiling.trace`` around one forward (a
     non-empty Chrome trace with the kernel's launches).
  13. the (data, model) mesh, async saves and BMP input, in
     build/smoke_mesh, removed at the end.  One card cannot hold a 2-rank
     NCCL group, so the mesh runs on a world-1 group whose collectives
     and sharding rule are forced on (``create_mesh(force=True)``):
     13a (a main path, counted) two full-width ``--fsdp`` R1 + path
     steps through the all-gathers and reduce-scatters against the
     unsharded steps (1e-5 of each tensor's largest), ms a step, bytes
     at rest and by the rule at (4, 1) and (2, 2); 13b ``fused_blur4``
     forward and adjoint on the model axis's channel slices (C / 2,
     C / 4 at every stage, f32 batch 16) against the plain version, on
     the planned TMA path, ms by graph replay; 13c ``evaluate_fid(
     mesh=)`` equal to no mesh; 13d the full-width train state saved
     synchronously and in the background (seconds, the loop's blocked
     seconds, files equal); 13e a BMP folder through the folder source
     and ``cli.prepare_data``; 13f cuDNN's
     time for the 128px stage's conv whole and as a model rank's half
     at the path batch.

Phase 1 builds the three kernel libraries at once, one ``nvcc`` each.
The phases run in the order 1, 2a, 3, 11, 7a, 8a, 9a, 9b, 10a, 2b, 3b,
4, 5a, 5b, 6, then 7a's profile, 7b, 7c, 8a's profile, 8b, 8c, 9a's
profile, 9c, 9d, 9e, 10a's profile and replays, 10b, 10c, 10d, 10e, 12,
13 (11d right after 3b).  The last three lines are the card line, the
kernels line and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import shutil
import socket
import struct
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

    busy_us, blur_us, rows = kernel_table(prof, top)
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


# ---------------------------------------------------------------- phase 6

N_IMAGES = 64                      # the dataset phase 6 prepares and reads
N_SOURCE, SOURCE_SIZE = 16, 1024   # FFHQ-size sources, resized to 256 on read
LOADER_BATCHES, LOADER_WARM = 20, 2
SOURCE_BATCHES, SOURCE_WARM = 3, 1


def smooth_images(n: int, size: int, seed: int = 0) -> np.ndarray:
    """Seeded smooth RGB images away from 0 and 255 (JPEG at quality 95
    keeps them ~45 dB from the source)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        f = rng.uniform(0.5, 3.0, (3, 2))
        ph = rng.uniform(0, 2 * np.pi, (3, 2))
        img = [128 + 45 * np.sin(2 * np.pi * f[c, 0] * x + ph[c, 0])
               + 35 * np.cos(2 * np.pi * f[c, 1] * y + ph[c, 1])
               for c in range(3)]
        img = np.stack(img, -1) + rng.uniform(-2, 2, (size, size, 3))
        out[i] = np.clip(img, 0, 255).round().astype(np.uint8)
    return out


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def png_row_filters(paths) -> list:
    """Rows by PNG filter type (none, sub, up, average, paeth) over
    files of one IDAT chunk, as ``save_png`` writes them."""
    import zlib
    counts = np.zeros(5, np.int64)
    for path in paths:
        data = pathlib.Path(path).read_bytes()
        w, h = int.from_bytes(data[16:20], "big"), \
            int.from_bytes(data[20:24], "big")
        rows = np.frombuffer(zlib.decompress(data[41:-12]), np.uint8)
        counts += np.bincount(rows.reshape(h, 1 + 3 * w)[:, 0], minlength=5)
    return counts.tolist()


def loader_rate(loader, batch: int, size: int, batches: int,
                warm: int) -> float:
    """img/s of ``loader`` over ``batches`` batches after ``warm``; the
    loader is closed."""
    try:
        for _ in range(warm):
            next(loader)
        t0 = time.perf_counter()
        for _ in range(batches):
            b = next(loader)
        dt = time.perf_counter() - t0
    finally:
        loader.close()
    check(b.shape == (batch, size, size, 3) and b.dtype == np.uint8,
          f"loader batch {b.shape} {b.dtype}")
    return batches * batch / dt


def data_phase(root: pathlib.Path, size: int, batch: int) -> dict:
    """6a: the dataset.  Seeded PNGs, their rows filtered as libpng and
    PIL filter them (``save_png``'s adaptive choice), so the reader
    unfilters every row as it would a real dataset's;
    ``cli.prepare_data`` -> LMDB of JPEGs (the port's own codec), every
    record held against its source (PSNR >= 40 dB), and the native
    loader's img/s with one worker and with cpu_count - 1; the PNG
    folder iterator's img/s (cpu_count - 1 reader threads), at 256px
    and from 1024px sources (FFHQ's size) resized on read."""
    from transeditor_tpu_torch.cli import prepare_data
    from transeditor_tpu_torch.data import native
    from transeditor_tpu_torch.data.dataset import (ImageFolderSource,
                                                    make_train_iterator)
    from transeditor_tpu_torch.utils.image import save_png

    pngs, big = root / "pngs", root / "pngs_1024"
    pngs.mkdir(parents=True)
    big.mkdir()
    imgs = smooth_images(N_IMAGES, size)
    for i, img in enumerate(imgs):
        save_png(str(pngs / f"{i:05d}.png"), img)
    for i, img in enumerate(smooth_images(N_SOURCE, SOURCE_SIZE, seed=1)):
        save_png(str(big / f"{i:05d}.png"), img)
    workers = max(1, (os.cpu_count() or 2) - 1)
    out = {"images": N_IMAGES, "size": size, "batch": batch,
           "workers": workers,
           "row_filters": png_row_filters(sorted(pngs.iterdir())),
           "row_filters_1024": png_row_filters(sorted(big.iterdir()))}
    print(f"data: PNG rows by filter type (none, sub, up, average, paeth): "
          f"{out['row_filters']} in the {N_IMAGES} {size}px files, "
          f"{out['row_filters_1024']} in the {N_SOURCE} {SOURCE_SIZE}px",
          flush=True)
    t0 = time.time()
    native.load_library()
    out["teio_build_s"] = time.time() - t0
    print(f"built {native.library_path().name} (csrc/teio.cpp, "
          f"csrc/jpeg.cpp) with g++ in {out['teio_build_s']:.1f} s",
          flush=True)
    lmdb = root / "lmdb"
    t0 = time.time()
    n = prepare_data.main(["--in_dir", str(pngs), "--out", str(lmdb),
                           "--size", str(size)])
    out["prepare_s"] = time.time() - t0
    check(n == N_IMAGES, f"prepare_data wrote {n} images")
    src = native.NativeLMDBSource(str(lmdb))
    check(len(src) == N_IMAGES, f"LMDB length {len(src)}")
    out["worst_psnr_db"] = min(psnr(src.get(i, size), imgs[i])
                               for i in range(N_IMAGES))
    src.db.close()
    check(out["worst_psnr_db"] >= 40.0,
          f"LMDB record vs source: {out['worst_psnr_db']:.2f} dB")
    for key, n_workers in (("lmdb_1_img_per_s", 1),
                           ("lmdb_img_per_s", workers)):
        out[key] = loader_rate(
            native.NativeLMDBLoader(str(lmdb), batch, size, as_uint8=True,
                                    workers=n_workers),
            batch, size, LOADER_BATCHES, LOADER_WARM)
    print(f"data: prepare_data {out['prepare_s']:.2f} s, records vs "
          f"source worst {out['worst_psnr_db']:.2f} dB (limit 40); "
          f"NativeLMDBLoader: 1 worker {out['lmdb_1_img_per_s']:.1f} "
          f"img/s, {workers} workers {out['lmdb_img_per_s']:.1f} img/s at "
          f"batch {batch}", flush=True)
    out["path"], out["data"] = str(lmdb), "lmdb"

    t0 = time.time()
    ImageFolderSource(str(pngs)).get(0, size)      # builds image_io
    out["image_io_build_s"] = time.time() - t0
    for key, folder, batches, warm, what in (
            ("folder_img_per_s", pngs, LOADER_BATCHES, LOADER_WARM,
             f"{size}px"),
            ("folder_1024_img_per_s", big, SOURCE_BATCHES, SOURCE_WARM,
             f"{SOURCE_SIZE}px sources resized to {size}")):
        out[key] = loader_rate(
            make_train_iterator(ImageFolderSource(str(folder)), batch, size,
                                normalize=False),
            batch, size, batches, warm)
        print(f"data: make_train_iterator over ImageFolderSource ({what} "
              f"PNGs), {workers} reader threads: {out[key]:.1f} img/s at "
              f"batch {batch} over {batches} batches after {warm}",
              flush=True)
    return out


def _variant(do_d_reg: bool, do_g_reg: bool, do_spatial_reg: bool) -> str:
    return {v: k for k, v in VARIANTS.items()}[
        (bool(do_d_reg), bool(do_g_reg), bool(do_spatial_reg))]


def cli_train_argv(data: dict, out_dir: pathlib.Path, name: str,
                   model_argv: list) -> list:
    """``cli.train_gan`` arguments for ``data`` (6a's or 6f's): batch 16,
    R1 every 2, path length every 3, every step logged."""
    return [data["path"], "--out_dir", str(out_dir), "--exp_name", name,
            "--batch", str(TRAIN_BATCH), "--d_reg_every", "2",
            "--g_reg_every", "3", "--n_sample", "16", "--log_every", "1",
            *(["--lmdb"] if data["data"] == "lmdb" else []), *model_argv]


@contextlib.contextmanager
def timed_steps():
    """Times each train step the loop makes by the host clock between two
    synchronisations; yields the list of (variant, ms) it fills."""
    from transeditor_tpu_torch.train import loop

    timed = []
    make_step = loop.make_train_step

    def timed_make(cfg, tcfg, device=None, **kw):
        step = make_step(cfg, tcfg, device=device, **kw)

        def run(state, real, rng, do_d_reg=False, do_g_reg=False,
                do_spatial_reg=False, draws=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = step(state, real, rng, do_d_reg=do_d_reg,
                       do_g_reg=do_g_reg, do_spatial_reg=do_spatial_reg,
                       draws=draws)
            torch.cuda.synchronize()
            timed.append((_variant(do_d_reg, do_g_reg, do_spatial_reg),
                          (time.perf_counter() - t) * 1e3))
            return got
        return run

    loop.make_train_step = timed_make
    try:
        yield timed
    finally:
        loop.make_train_step = make_step


def cli_train_phase(fb, dev, root: pathlib.Path, data: dict,
                    model_argv: list) -> dict:
    """6b: ``cli.train_gan.main`` in this process, steps 0-3 (R1 every 2,
    path length every 3: r1+path, plain, r1, path), then ``--resume`` to
    step 6; counted by role and path.  Each step is timed by the host
    clock between two synchronisations (a wrapper around the loop's
    step)."""
    from transeditor_tpu_torch.cli import train_gan

    out_dir = root / "runs"
    argv = cli_train_argv(data, out_dir, "cli", model_argv)
    with timed_steps() as timed:
        torch.cuda.synchronize()
        fb.launches.reset()                  # the main path starts here
        t0 = time.perf_counter()
        state = train_gan.main([*argv, "--iter", "4"])
        check(state.step == 4, f"first run ended at step {state.step}")
        state = train_gan.main([*argv, "--iter", "6", "--resume",
                                str(out_dir / "cli" / "checkpoint")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fb.launches.by_role_path     # ... and ends here
    check(state.step == 6, f"resumed run ended at step {state.step}")

    log = out_dir / "cli" / "log" / "metrics.jsonl"
    lines = [json.loads(s) for s in log.read_text().splitlines()]
    check([r["step"] for r in lines] == list(range(6)),
          f"logged steps {[r['step'] for r in lines]}")
    for r in lines:
        check(all(np.isfinite(v) for v in r.values()), f"step {r}")
        i = r["step"]
        check((r["r1"] > 0) == (i % 2 == 0), f"r1 at step {i}: {r['r1']}")
        check((r["path_length"] > 0) == (i % 3 == 0),
              f"path length at step {i}: {r['path_length']}")
    paths = {p for by in counts.values() for p in by}
    check(paths == {"tma"}, f"CLI launches by role and path {counts}")
    check(all(counts.get(r) for r in ("forward", "adjoint", "recompute")),
          f"CLI launches by role {counts}")
    by_variant: dict = {}
    for name, ms in timed:
        by_variant.setdefault(name, []).append(ms)
    waits = [r["data_wait_share"] for r in lines]
    print(f"cli train: {data['data']} data, {len(timed)} steps through "
          f"cli.train_gan.main (4, then --resume to 6) in {wall:.2f} s; "
          f"logged steps {[r['step'] for r in lines]}, all finite; "
          f"fused_blur4 launches {counts}", flush=True)
    for i, (name, ms) in enumerate(timed):
        print(f"  step {i} ({name}): {ms:.1f} ms; data wait "
              f"{waits[i]:.2%} of the logged interval", flush=True)
    return {"launches": counts, "wall_s": wall, "step_ms": timed,
            "ms_by_variant": by_variant, "data_wait_share": waits,
            "state_dir": str(out_dir / "cli" / "checkpoint"),
            "losses": lines}


def data_parallel_phase(dev, **cfg_kw) -> dict:
    """6c: two R1 + path steps through ``multihost.initialize()`` on NCCL
    (world 1) with every collective forced on (``all_reduce_grads``, the
    discriminator's cross-process stddev, the global path means), against
    the same two steps with no process group, from the same state and
    draws.  At lr 0 (see
    ``train_card_vs_cpu``) with cuDNN deterministic, so each Adam moment
    holds one phase's gradient: a wrong scale or a lost gradient shows
    there.  Moments within 1e-5 of each tensor's largest magnitude (1e-8
    / 1e-16 for the gradients that are 0 in exact arithmetic)."""
    import torch.distributed as dist
    from transeditor_tpu_torch.config import ModelConfig, TrainConfig
    from transeditor_tpu_torch.parallel import multihost
    from transeditor_tpu_torch.train import gan

    print("data parallel: one card cannot hold a 2-rank NCCL group (NCCL "
          "refuses two ranks on one device); the multi-rank semantics are "
          "held on the CPU on gloo by tests/test_torch_port_multihost.py",
          flush=True)
    cfg = ModelConfig(**cfg_kw)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, lr=0.0)
    g = torch.Generator().manual_seed(11)
    pb = TRAIN_BATCH // tcfg.path_batch_shrink

    def zp(b):
        return [torch.randn((b, cfg.n_tokens, cfg.style_dim), generator=g)
                for _ in "zp"]

    def noise(b):
        return torch.randn((b, cfg.size, cfg.size, 3), generator=g) \
            / cfg.size
    draws = [{"d": zp(TRAIN_BATCH), "g": zp(TRAIN_BATCH),
              "path": [*zp(pb), noise(pb)],
              "spatial": [*zp(pb), noise(pb)]} for _ in range(2)]
    reals = [torch.from_numpy(b) for b in
             synthetic_batches(2, TRAIN_BATCH, cfg.size, seed=12)]

    def two_steps():
        state = gan.init_state(cfg, tcfg, seed=0, device=dev)
        step = gan.make_train_step(cfg, tcfg, device=dev)
        for k in range(2):
            state, m = step(state, reals[k], torch.Generator(dev)
                            .manual_seed(k), do_d_reg=True, do_g_reg=True,
                            draws=draws[k])
        torch.cuda.synchronize()
        return state, m

    reduce_ms = []
    reduce_grads = gan.all_reduce_grads
    multi_process = multihost.multi_process

    def timed_reduce(grads, mesh=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = reduce_grads(grads, mesh)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t) * 1e3)
        return out

    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        ref, m_ref = two_steps()
        os.environ.update(env)
        check(multihost.initialize(dev), "multihost.initialize() joined "
                                         "no process group")
        check(dist.get_backend() == backend
              and multihost.process_count() == 1,
              f"process group {dist.get_backend()} of "
              f"{multihost.process_count()}")
        check(not multihost.multi_process(), "a group of one runs "
                                             "collectives")
        # the library runs no collective in a group of one; here they
        # are made to run, so that NCCL's all-reduces (the gradients',
        # and the discriminator's stddev and the path means through
        # all_reduce_sum) are held to the identity
        multihost.multi_process = lambda: True
        gan.all_reduce_grads = timed_reduce
        run, m_run = two_steps()
    finally:
        multihost.multi_process = multi_process
        gan.all_reduce_grads = reduce_grads
        multihost.shutdown()
        torch.backends.cudnn.deterministic = False
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    worst = (0.0, "every tensor")
    for tag, a_mod, b_mod, a_opt, b_opt in (
            ("G", run.g, ref.g, run.opt_g, ref.opt_g),
            ("D", run.d, ref.d, run.opt_d, ref.opt_d)):
        for (name, pa), pb_ in zip(a_mod.named_parameters(),
                                   b_mod.parameters()):
            pairs = [("param", pa, pb_, 0.0)] + [
                (key, a_opt.state[pa][key], b_opt.state[pb_][key], floor)
                for key, floor in (("exp_avg", 1e-8),
                                   ("exp_avg_sq", 1e-16))]
            for key, a, b, floor in pairs:
                err = (a - b).abs().max().item()
                tol = 1e-5 * b.abs().max().item() + floor
                check(err <= tol, f"{tag} {name} {key}: {err} > {tol}")
                rel = err / max(b.abs().max().item(), 1e-30)
                if rel > worst[0]:
                    worst = (rel, f"{tag} {name} {key}")
    for k in m_ref:
        check(abs(float(m_run[k]) - float(m_ref[k]))
              <= 1e-5 * abs(float(m_ref[k])) + 1e-7, f"metric {k}")
    calls = len(reduce_ms) // 2
    print(f"data parallel ({backend}, world 1, collectives forced on): 2 "
          f"R1 + path steps through all_reduce_grads ({calls} reductions a "
          f"step) and the cross-process stddev equal the steps "
          f"without a process group: worst {worst[0]:.2e} of the tensor's "
          f"largest ({worst[1]}); all-reduce {sum(reduce_ms) / 2:.2f} ms a "
          f"step", flush=True)
    return {"all_reduce_ms_per_step": sum(reduce_ms) / 2,
            "reductions_per_step": calls, "worst_rel": worst[0],
            "worst_at": worst[1], "all_reduce_ms": reduce_ms}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_state_phase(fb, dev, state_dir: str, **cfg_kw) -> dict:
    """6d: ``engine_from_checkpoint(state_dir=...)`` on 6b's state: its
    generator equals that state's g_ema; then HTTP ``POST /sample`` with
    ``"format": "jpeg_b64"`` (the port's JPEG encoder), held against the
    array answer for the same codes at 35 dB, counted."""
    import base64
    import http.client
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.io.checkpoint import (checkpoint_steps,
                                                     load_train_state_generator)
    from transeditor_tpu_torch.models.generator import Generator
    from transeditor_tpu_torch.serve import (engine_from_checkpoint,
                                             make_http_server)

    cfg = ModelConfig(**cfg_kw)
    eng = engine_from_checkpoint(cfg, state_dir=state_dir, device=dev)
    step = checkpoint_steps(state_dir)[-1]
    weights, got_step = load_train_state_generator(state_dir)
    check(got_step == step, f"served step {got_step}, latest {step}")
    served = eng.gen.state_dict()
    check(served.keys() == weights.keys() and all(
        torch.equal(served[k].cpu(), weights[k]) for k in weights),
        "the engine's weights are not the state's g_ema")
    direct = Generator(cfg, device=dev).eval()
    direct.load_state_dict(weights, strict=True)
    z, p = (t.to(dev) for t in codes(4, cfg.style_dim, seed=6))
    # cuDNN held to one deterministic algorithm a shape, as in 6c, so two
    # modules with equal weights run the same arithmetic
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with torch.inference_mode():
            served_img = eng.gen(z, p).image
            diff = (served_img - direct(z, p).image).abs().max().item()
            again = (served_img - eng.gen(z, p).image).abs().max().item()
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
    print(f"serve from train state: engine vs a module holding the state's "
          f"g_ema {diff:.3e}, engine vs itself {again:.3e} (cuDNN "
          f"deterministic, max abs)", flush=True)
    check(diff <= 1e-6, f"engine vs the state's g_ema: {diff}")

    server = make_http_server(eng, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    torch.cuda.synchronize()
    fb.launches.reset()                       # the main path starts here
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=120)
        req = {"n": 2, "format": "jpeg_b64", "quality": 95}
        conn.request("POST", "/sample", json.dumps(req))
        resp = conn.getresponse()
        out = json.loads(resp.read())
        check(resp.status == 200, f"POST /sample: HTTP {resp.status}")
        conn.request("POST", "/decode", json.dumps(
            {"z": out["z_plus"], "p": out["p_plus"]}))
        arrays = np.asarray(json.loads(conn.getresponse().read())["images"],
                            np.uint8)
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    torch.cuda.synchronize()
    paths = fb.launches.by_path               # ... and ends here
    check(not thread.is_alive(), "HTTP thread still running")
    check(arrays.shape == (2, cfg.size, cfg.size, 3), str(arrays.shape))
    check(paths == {"tma": fb.launches.value} and fb.launches.value > 0,
          f"serve-state launches by path {paths}")
    res = {"step": step, "engine_vs_state_max_abs": diff,
           "engine_vs_itself_max_abs": again, "launches": paths}
    from transeditor_tpu_torch.data.native import decode_jpeg
    imgs = [decode_jpeg(base64.b64decode(b)) for b in out["images"]]
    res["jpeg_psnr_db"] = min(psnr(a, b) for a, b in zip(imgs, arrays))
    check(res["jpeg_psnr_db"] >= 35.0,
          f"jpeg_b64 vs array answer {res['jpeg_psnr_db']:.2f} dB")
    what = (f"POST /sample jpeg_b64 vs the array answer for its codes: "
            f"worst {res['jpeg_psnr_db']:.2f} dB (limit 35)")
    print(f"serve from train state: step {step}, weights equal to the "
          f"state's g_ema, forward vs a module holding them (cuDNN "
          f"deterministic) max abs {diff:.2e} (limit 1e-6); {what}; "
          f"fused_blur4 launches {paths}",
          flush=True)
    return res


# ---------------------------------------------------------------- 6e

def seeded_rgb(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded [h, w, 3] uint8 image made from integers alone (sawtooth
    ramps plus noise), so every machine and numpy makes the same one."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    fx, fy = rng.randint(1, 9, 3), rng.randint(1, 9, 3)
    img = np.stack([(x * fx[c] + y * fy[c]) % 256 for c in range(3)], -1)
    return np.clip(img + rng.randint(-24, 25, (h, w, 3)), 0,
                   255).astype(np.uint8)


# SHA-256 of libjpeg-turbo 2.1.5's bytes for encode_jpeg(seeded_rgb(h, w,
# seed=h * w), quality): jpeg_set_defaults + jpeg_set_quality(q, TRUE),
# through the JAX package's native binding (tests/test_torch_port_jpeg.py
# recomputes them).
CODEC_ENCODE_SHA256 = {
    "37x53-q1":
        "a4e3254cd1e564d5986461a7bdf4d86de73af39bbfc44328f2f9d285a3626392",
    "37x53-q50":
        "4d758141859587623d9656266b825ab04c6e1a3976f1221924b76d00d51bad1f",
    "37x53-q95":
        "3308e04547b120eb9d5b7b411b414f6459f9aa283eacb925a21bb587189763d9",
    "37x53-q100":
        "c01ae4fc501ac9519ac1c20f3905b7aa5a795c49aa42b7fe7b55607405fb4a37",
    "131x250-q1":
        "bf4323d7cbbd0864fecbbb00f190c4b1e6ad96279e39ec212801b4d6a11731e0",
    "131x250-q50":
        "4b32ffde7963d2e2b4ab8c58505ce19ff56e43688b45ce15d6900762c4aa2212",
    "131x250-q95":
        "1b451b76234a9f24acc2c0eeaaf30007fa5a2fa5cb55bf90038b8e93566bc66c",
    "131x250-q100":
        "ea53b661404bd0424e652395703e20572ba2d7b31d960b16d193117788bed461",
}

# Small JPEGs written by PIL from seeded_rgb(23, 29, seed=i) at quality 85,
# and the SHA-256 of the RGB pixels libjpeg-turbo 2.1.5 decodes from each
# (the JAX binding's decode_jpeg).
CODEC_DECODE = {
    "progressive-optimized": (29, 23, (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8L"
        "CwkMEQ8SEhEPERETFhwXExQaFRERGCEYGh0dHx8fExciJCIeJBweHx7/2wBDAQUF"
        "BQcGBw4ICA4eFBEUHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4e"
        "Hh4eHh4eHh4eHh4eHh7/wgARCAAXAB0DASIAAhEBAxEB/8QAFwAAAwEAAAAAAAAA"
        "AAAAAAAAAAUGB//EABkBAAIDAQAAAAAAAAAAAAAAAAAFAgMEBv/aAAwDAQACEAMQ"
        "AAABzOtUVYub1CqWuilrgMTbPgbdP//EAB0QAAICAgMBAAAAAAAAAAAAAAIEAAMB"
        "EQUTIhT/2gAIAQEAAQUCVCK16ioyqvytXFA1FQzOcu+htXHlQdYcuyokHWIf/8QA"
        "HREAAQQCAwAAAAAAAAAAAAAAAwABAgQGERJRsf/aAAgBAwEBPwEplTryul4RfSnJ"
        "Y6JnFvt/F//EABwRAAICAgMAAAAAAAAAAAAAAAECAAQDEQUSIv/aAAgBAgEBPwFh"
        "KdI2snWMo1MWU1ONewg9bn//xAAjEAABAwIFBQAAAAAAAAAAAAAAAQIxISIDEBIT"
        "MkFRYXGB/9oACAEBAAY/AoyShAk+CBOxtt44Nv3qIUHPTmtrfYmo/8QAHxAAAgMA"
        "AgIDAAAAAAAAAAAAAREAITFBgWFxUbHB/9oACAEBAAE/IbvgdZiACr6lBAAHBBwz"
        "8E/s6DQjALi4QMYPqMkXa3kx+OpiLbl5RjkwpWHv8531KVB4BTn/2gAMAwEAAgAD"
        "AAAAEM7AnP/EAB0RAAICAQUAAAAAAAAAAAAAAAERACHwMUFhoeH/2gAIAQMBAT8Q"
        "Y7lJgBkpoeldmGJWVNriZka0rOTP/8QAHBEBAAIDAAMAAAAAAAAAAAAAAQARITFB"
        "UWGB/9oACAECAQE/EK4sLQCrV18x335eSwgpmjethxHFvdz/xAAkEAEBAAIBAwMF"
        "AQAAAAAAAAABESExAFGBkUFxsWGhweHw8f/aAAgBAQABPxCmI0YDS730cduTTYaO"
        "py59rqXrw5mRvDYJqJrBdY1w1hoqE+3y5FtW6O+E6SMP2oeBgK6kPx5xwqFqEb0e"
        "PnzwblBq2+YDKm45eMqhjBn0PoXEf84pEUyzqr3/AL2hETJsLFUYLmRw9eBWxlOg"
        "B7b5/9k="
    ), "16ad68a93021c61dec03b0cbd2321faca0f6dad4bcb262786666179a3c873a22"),
    "444": (29, 23, (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8L"
        "CwkMEQ8SEhEPERETFhwXExQaFRERGCEYGh0dHx8fExciJCIeJBweHx7/2wBDAQUF"
        "BQcGBw4ICA4eFBEUHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4e"
        "Hh4eHh4eHh4eHh4eHh7/wAARCAAXAB0DAREAAhEBAxEB/8QAHwAAAQUBAQEBAQEA"
        "AAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIh"
        "MUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6"
        "Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZ"
        "mqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx"
        "8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
        "AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAV"
        "YnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hp"
        "anN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPE"
        "xcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwD5"
        "q0PQMTD5WIY4YZ4HPHI4/wA/WudYi9+bRr+v639Tkp4tNr+u/wDX5bndaNo0Uil2"
        "jLkcOu3nOf5Y/H8a09pZWjp+Xr9/9duuji5Odlpp0+f9fJHf+H9HBcFkbO8c7cY6"
        "8Hnnrx9ac6yt6f1p9yOqOKbdr7q36Pb1/wCAdvp+mxGANLERlRgDB5785HHSkq9N"
        "/E/6/E7KeK52+S7/AK/r/I8T0DSwJFHl7iAdgVee3oeT05rxnXsry28/67+f4n5p"
        "HEy0Sau+v/D2/rTU7fQtGmhRWCKFbnLJgkY9+fwPf61Xt+bf00u/67aPbzWnorFp"
        "bO3l929u3+Z6FoejvN5LhcqD94/NjjtkZ/z9DWcKkk3BO/4f8D/gdzqp4vdT1v8A"
        "1/Xludtp+jKYiZbdZAMBVcDKkcE4z3rWNaU1Za/8E76eLuvcV/W7/S54bo+mRR7C"
        "6KcqUB+hwfx/TivCdV309dPT+n5fgfmUMSpPlWlt/wA/8jvtD0uNgEQKFB4zk4zz"
        "nn+XT61bqShaT2/4B2xxkoyb/wAu9v1S/wCGNXxH4g8PeCbO2n155GlmLCGG3iLS"
        "S4IDYPCjG4E7mHQ4zXsZTlmLzebWG6LXWy1vbzto+l9rn0uTZXjc4m6WGSSjbmb0"
        "SvdrRXetnsn52OEu/ix4y1NlfQTBo1uoB2oiTu/b5mkBHBDEbQPvc5r9Cw3C+W4R"
        "NYle0b7tpJ9bKPe6vdu7P2XLeCctw1H/AGjmqyfX4Vp2Sf5t7aWP/9k="
    ), "3cf5a95c708d0eba266d5947eae60b94fff9f8468bf4c96be3b661a676720060"),
    "422": (29, 23, (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8L"
        "CwkMEQ8SEhEPERETFhwXExQaFRERGCEYGh0dHx8fExciJCIeJBweHx7/2wBDAQUF"
        "BQcGBw4ICA4eFBEUHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4e"
        "Hh4eHh4eHh4eHh4eHh7/wAARCAAXAB0DASEAAhEBAxEB/8QAHwAAAQUBAQEBAQEA"
        "AAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIh"
        "MUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6"
        "Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZ"
        "mqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx"
        "8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
        "AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAV"
        "YnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hp"
        "anN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPE"
        "xcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwD5"
        "v8OaYfMjZBggDIB6nH5dM16T4a0h45FRgArOBnGQR1wPy9vxpc6b13PiM4xibaue"
        "jaDo2+RYzGzLwqZHykdjwP0Pr+FWvFPjvwx4QuINM1S3u9QvDGHkiskVjb5AID7i"
        "ACQcgDJxjIAIz7GV4CtmOJVGiknZ6u9rLe9k35bb2PgFhMTm2L+r4Wzlq3fZJd7X"
        "8lt1PItA0feFjjTDvkEfwrznoRnOBmvSfDGkpmMuuCyAHcmcdee3UeteJ7SXLy9v"
        "6/r/ADPdznFe612LvjTxXZeCdJSDbFc6zdKRaWm7oc8PIQRhR0wMFiCB/ER4o1tN"
        "fXU+oamUe4upDNIxkCBnYlmIA4GSSccfQV+o8FZe6OHliWnepsvJf5/kvM9PhHA+"
        "ww08ZUdnU2/wpv8AN/glbc9R8L6buiXaQG3Y3DjoM9OnTNdPrup2Pg3w+dWvo2nY"
        "v5VvEpy002OFLYwBjJJI6DucCvy7BUXicRCjF6ydv+Dv03PlcVTqYvFrDQdnJpf5"
        "/d97PEZZr7xBrt7rmobDczlS3lqEWMBNqhRnoFwM5J47kk11ul2i2lsMmNQ2MNk5"
        "OAODgds1+3YvG4XJsF7WtLlpU1FN2bstEuje7XRn6LiZQw1KGHop2ikl6RSXl0P/"
        "2Q=="
    ), "a7edade00c54442b7b5ed6d8dfc5cb5aa275011f6b668a843d0bbe0de7c8af3f"),
    "gray": (29, 23, (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8L"
        "CwkMEQ8SEhEPERETFhwXExQaFRERGCEYGh0dHx8fExciJCIeJBweHx7/wAALCAAX"
        "AB0BAREA/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgED"
        "AwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2Jy"
        "ggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1"
        "dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJ"
        "ytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/9oACAEBAAA/APkOJN8m3bhD"
        "8pfAbA7HryRyMjoOnrVzmeOG2YuHlJ6sSR2I+vXI5498YkiVnVpNm5CQpCjrkngZ"
        "HI555zyD7DSnHzCPfcZHzfJGzDnt2wBjH4Hoc1g2atHKBORmPPO7cECjqQMkchfQ"
        "GtOyt2LrGqDfvy4CAKFBOFHfqCMnHXB7VatrVWfyhES6KySMz/KOme2T8w/Mkg5y"
        "RpwxNIg2vPvUbXZJHGTk9cKee+DjGRxXOwmKRlnKmSJGKAxkjdgbioB6Y689fbjG"
        "nHEpXzmJYSMEIPO3PUD1yx5z7deSbSeT9rS3ZJg0iEYDjO1scfTjOc5yT1zWjp1g"
        "J0aOa2D+Xg7mYLkkZPAz2xX/2Q=="
    ), "e319fbcfd8b97c955530490fe998e14665fce9e150e32cea4131b7aa862738e4"),
    "restart-2": (29, 23, (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8L"
        "CwkMEQ8SEhEPERETFhwXExQaFRERGCEYGh0dHx8fExciJCIeJBweHx7/2wBDAQUF"
        "BQcGBw4ICA4eFBEUHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4e"
        "Hh4eHh4eHh4eHh4eHh7/wAARCAAXAB0DASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEA"
        "AAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIh"
        "MUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6"
        "Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZ"
        "mqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx"
        "8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
        "AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAV"
        "YnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hp"
        "anN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPE"
        "xcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/90ABAAC/9oADAMBAAIR"
        "AxEAPwD5o8MWiyzIvMhI2kDJXHccjA6gV6R4csGeNUfkMzZLEnGOMZPTH49+tcv4"
        "XsPKucSqq/JhicgnIHT34zj39a9S0CwddhTYSTjcGJxzgsT/AI9h3xRQxHKlYWPw"
        "Ft0dH4bsldfMC/JtUnLYTHHGO/A/XpXoOi6eVtfM8gSGT5ssQMj16H/IrE8P6bGr"
        "AYKgqMle64x/ke/vXo2jWyi03BpIVZjtww5H1zXvYbFNK61PjcbgFba/of/Q8x8M"
        "aezQD7PuVlG5snnOOx9uK9O8I2sTiM7cL/EAe5APTp0P60UV40JyjC6PqszpxjKy"
        "PUfCdlCpRAI5DgI2V/E4z26//rrvdHjiihbzUAYnGQOuMj86KK9qjNq/oj4zGUIS"
        "nyv+tD//2Q=="
    ), "70764ba57c1472161b2b348bb76d93f30988d17ead6fca14c9e38ca5712d37d8"),
}


# SHA-256 of the pixels the JAX binding (libjpeg-turbo 2.1.5 with
# arithmetic decoding) gives each non-CMYK SOF9 / SOF10 fixture of
# tests/image_forms/, which LMDB records may hold (tests/
# test_torch_port_jpeg_arith.py recomputes them); and a SOF3 fixture,
# which that binding, and so the LMDB path, refuses.
LMDB_ARITH_SHA256 = {
    "sof10_420_17x13.jpg":
        "2e6cabfb2c4ac9ba1e0526cde0d70474058f9ab8bd7d8709eb78f0599f430480",
    "sof10_420_1x1.jpg":
        "df65f549a7bf7fa6ec07d9b5b3989d03ad9f59fb5d18eae77abfac9bc7c3d79e",
    "sof10_420_33x65.jpg":
        "2feecc12765337e7713c3311707aca522801a35e47a61af230ed9c88e852003e",
    "sof10_420_restart_33x65.jpg":
        "2feecc12765337e7713c3311707aca522801a35e47a61af230ed9c88e852003e",
    "sof10_444_33x65.jpg":
        "cda286e082cb808e3835efa7f4679fe0d0e353579550404b2bb800017e7213ec",
    "sof10_444_dac_33x65.jpg":
        "cda286e082cb808e3835efa7f4679fe0d0e353579550404b2bb800017e7213ec",
    "sof10_gray_17x13.jpg":
        "40d4c29b38e022b23c17526e4561cd438adca318b843483e2fe8f407ab9872f3",
    "sof10_gray_1x1.jpg":
        "cb3f91d54eee30e53e35b2b99905f70f169ed549fd78909d3dac2defc9ed8d3b",
    "sof10_gray_33x65.jpg":
        "bdcc3ab85f7a016ed0e7d232cfeb5b908ada6e7031423ce7ba61a9bab753d124",
    "sof9_420_17x13.jpg":
        "90c0ac1453d693542f37c81b2a2e315abf2a4fb4771803e635a3c5dd1a36b3ec",
    "sof9_420_1x1.jpg":
        "226b2b70ce3bd4d9374c539a099e8770142d31b5c3c0914eb15dc9d50680dbf7",
    "sof9_420_33x65.jpg":
        "a5fcfcd0b28a88e49651da58ce637664ecf8e5f46ef571e56d1727d4c5af46fc",
    "sof9_420_restart_33x65.jpg":
        "a5fcfcd0b28a88e49651da58ce637664ecf8e5f46ef571e56d1727d4c5af46fc",
    "sof9_444_33x65.jpg":
        "7fc266d95d3f202b6851ba964a2b1e4a390df79e61cb2e65a925dd9575746eaa",
    "sof9_444_dac_33x65.jpg":
        "7fc266d95d3f202b6851ba964a2b1e4a390df79e61cb2e65a925dd9575746eaa",
    "sof9_gray_17x13.jpg":
        "333c780e7288ed044e4b3ed6196c9c575d43daa017cd10a681b22d94d7b65666",
    "sof9_gray_1x1.jpg":
        "fb337d3432f9465ea0a23c33debf6525c68f21f95061a35ff08c271f6c8e176b",
    "sof9_gray_33x65.jpg":
        "49bb49772318e7f669c05d5e33e42b908dc38d39240c12daedc6f1496ce3f46f",
}
LMDB_REFUSED = "sof3_rgb_p1_33x65.jpg"


def codec_phase(card: str, data: dict, train: dict) -> dict:
    """6e: the port's JPEG codec held to libjpeg-turbo's bytes and pixels
    through committed digests (this machine has no libjpeg), then its
    single-thread speed beside the data path's figures from 6a and
    6b."""
    import base64
    import hashlib
    from transeditor_tpu_torch.data import native

    def sha(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    for key, want in CODEC_ENCODE_SHA256.items():
        size, q = key.split("-q")
        h, w = map(int, size.split("x"))
        got = sha(native.encode_jpeg(seeded_rgb(h, w, seed=h * w), int(q)))
        check(got == want, f"6e encode {key}: sha256 {got}, libjpeg {want}")
    for name, (w, h, b64, want) in CODEC_DECODE.items():
        px = native.decode_jpeg(base64.b64decode(b64))
        check(px.shape == (h, w, 3), f"6e decode {name}: {px.shape}")
        got = sha(px.tobytes())
        check(got == want, f"6e decode {name}: sha256 {got}, libjpeg {want}")
    print(f"6e codec vs libjpeg-turbo 2.1.5: {len(CODEC_ENCODE_SHA256)} "
          f"encoder outputs (qualities 1, 50, 95, 100 at two odd sizes) "
          f"and the pixels of {len(CODEC_DECODE)} decodes "
          f"({', '.join(CODEC_DECODE)}) equal libjpeg's digests",
          flush=True)
    for name, want in LMDB_ARITH_SHA256.items():
        px = native.decode_jpeg((IMAGE_FORMS / name).read_bytes())
        got = sha(px.tobytes())
        check(got == want, f"6e LMDB path {name}: sha256 {got}, the JAX "
              f"binding's {want}")
    try:
        native.decode_jpeg((IMAGE_FORMS / LMDB_REFUSED).read_bytes())
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("lossless" in refused, f"6e LMDB path decoded {LMDB_REFUSED}: "
          f"the JAX binding refuses SOF3 ({refused!r})")
    print(f"6e LMDB path (decode_jpeg as the native loader calls it): "
          f"{len(LMDB_ARITH_SHA256)} arithmetic-coded (SOF9 / SOF10) "
          f"fixtures equal the JAX binding's digests; {LMDB_REFUSED} "
          f"refused as it refuses it ({refused})", flush=True)

    def us(fn, reps: int) -> float:
        fn()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e6

    imgs = {n: smooth_images(1, n, seed=n)[0] for n in (256, 1024)}
    blobs = {n: native.encode_jpeg(img, 95) for n, img in imgs.items()}
    out = {"encode_digests": len(CODEC_ENCODE_SHA256),
           "decode_digests": len(CODEC_DECODE),
           "lmdb_arith_digests": len(LMDB_ARITH_SHA256),
           "decode_us_256": us(lambda: native.decode_jpeg(blobs[256]), 100),
           "decode_us_1024": us(lambda: native.decode_jpeg(blobs[1024]),
                                10),
           "encode_us_256": us(lambda: native.encode_jpeg(imgs[256], 95),
                               100)}
    waits = train["data_wait_share"]
    out["data_wait_share_mean"] = float(np.mean(waits))
    print(f"6e data path ({card}): single thread, one q95 JPEG decoded at "
          f"256px in {out['decode_us_256']:.1f} us, at 1024px in "
          f"{out['decode_us_1024']:.1f} us, encoded at 256px in "
          f"{out['encode_us_256']:.1f} us; NativeLMDBLoader "
          f"{data['lmdb_1_img_per_s']:.1f} img/s with 1 worker, "
          f"{data['lmdb_img_per_s']:.1f} with {data['workers']} (batch "
          f"{data['batch']}); prepare_data {data['prepare_s']:.2f} s for "
          f"{data['images']} images; 6b waited for data "
          f"{out['data_wait_share_mean']:.2%} of each logged interval on "
          f"average (steps: {', '.join(f'{w:.2%}' for w in waits)})",
          flush=True)
    return out


# ---------------------------------------------------------------- 6f

IMAGE_FORMS = pathlib.Path(__file__).resolve().parent / "tests" / \
    "image_forms"
FORMS_TIMED = ("webp_lossy_q75_256x256.webp", "webp_lossless_256x256.webp",
               "jpeg_cmyk_baseline_420_256x256.jpg", "sof9_420_256x256.jpg",
               "sof10_420_256x256.jpg", "sof3_rgb_p6_256x256.jpg",
               "bmp_rle8_256x256.bmp")


def image_forms_phase(fb, card: str, root: pathlib.Path, data: dict,
                      train: dict, codec: dict, model_argv: list) -> dict:
    """6f: the image forms of ``tests/image_forms`` (PIL's digests of
    each, 6f-1), as a dataset through ``cli.prepare_data`` and two
    full-width ``cli.train_gan`` steps (6f-2, counted by role and path),
    and the decode's single-thread µs (6f-3)."""
    import hashlib
    from transeditor_tpu_torch.cli import prepare_data, train_gan
    from transeditor_tpu_torch.data import native
    from transeditor_tpu_torch.data.dataset import ImageFolderSource
    from transeditor_tpu_torch.utils.image import (decode_bmp, decode_webp,
                                                   load_image)

    digests = json.loads((IMAGE_FORMS / "digests.json").read_text())
    check(len(digests) >= 161, f"6f: {len(digests)} fixtures")
    kinds: dict = {}
    for name, want in digests.items():
        px = load_image(str(IMAGE_FORMS / name))
        got = hashlib.sha256(px.tobytes()).hexdigest()
        check(list(px.shape) == want["shape"] and got == want["sha256"],
              f"6f-1 {name}: {px.shape} sha256 {got}, PIL {want['sha256']}")
        kind = name.split("_")[0]
        kinds[kind] = kinds.get(kind, 0) + 1
    print(f"6f-1 image forms without an image library: the pixels of all "
          f"{len(digests)} fixtures ({kinds}) equal PIL's digests",
          flush=True)

    lmdb = root / "forms_lmdb"
    size = data["size"]
    t0 = time.time()
    n = prepare_data.main(["--in_dir", str(IMAGE_FORMS), "--out", str(lmdb),
                           "--size", str(size)])
    prepare_s = time.time() - t0
    check(n == len(digests), f"6f-2 prepare_data wrote {n} images")
    folder = ImageFolderSource(str(IMAGE_FORMS))
    src = native.NativeLMDBSource(str(lmdb))
    worst = min(psnr(src.get(i, size), folder.get(i, size))
                for i in range(n))
    src.db.close()
    check(worst >= 40.0, f"6f-2 LMDB record vs source: {worst:.2f} dB")
    out_dir = root / "runs"
    argv = cli_train_argv({"path": str(lmdb), "data": "lmdb"}, out_dir,
                          "forms", model_argv)
    with timed_steps() as timed:
        torch.cuda.synchronize()
        fb.launches.reset()                  # the main path starts here
        state = train_gan.main([*argv, "--iter", "2"])
        torch.cuda.synchronize()
        counts = fb.launches.by_role_path     # ... and ends here
    check(state.step == 2, f"6f-2 run ended at step {state.step}")
    log = out_dir / "forms" / "log" / "metrics.jsonl"
    lines = [json.loads(s) for s in log.read_text().splitlines()]
    check([r["step"] for r in lines] == [0, 1],
          f"6f-2 logged steps {[r['step'] for r in lines]}")
    for r in lines:
        check(all(np.isfinite(v) for v in r.values()), f"6f-2 step {r}")
    paths = {p for by in counts.values() for p in by}
    check(paths == {"tma"}, f"6f-2 launches by role and path {counts}")
    check(all(counts.get(r) for r in ("forward", "adjoint", "recompute")),
          f"6f-2 launches by role {counts}")
    print(f"6f-2 {n} fixtures resized to {size} on read -> prepare_data "
          f"in {prepare_s:.2f} s, records vs source worst {worst:.2f} dB "
          f"(limit 40); cli.train_gan.main, 2 steps, all finite; "
          f"fused_blur4 launches {counts}", flush=True)
    for i, (name, ms) in enumerate(timed):
        same = train["ms_by_variant"].get(name, [])
        print(f"  step {i} ({name}): {ms:.1f} ms; 6b's {name} steps "
              f"{', '.join(f'{m:.1f}' for m in same)} ms", flush=True)

    def us(fn, reps: int = 100) -> float:
        fn()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e6

    blobs = {name: (IMAGE_FORMS / name).read_bytes() for name in FORMS_TIMED}
    decode_us = {}
    decoders = {".webp": decode_webp, ".bmp": decode_bmp,
                ".jpg": lambda b: native.decode_jpeg(b, as_pil=True)}
    for name, blob in blobs.items():
        fn = decoders[pathlib.Path(name).suffix]
        decode_us[name] = us(lambda b=blob, fn=fn: fn(b))
    print(f"6f-3 decode ({card}): single thread, 100 reps each: "
          + ", ".join(f"{name} {t:.1f} us" for name, t in decode_us.items())
          + f"; 6e's q95 4:2:0 JPEG at 256px {codec['decode_us_256']:.1f} "
          f"us", flush=True)
    return {"fixtures": len(digests), "by_kind": kinds,
            "prepare_s": prepare_s, "worst_psnr_db": worst,
            "launches": counts, "step_ms": timed, "losses": lines,
            "decode_us": decode_us}


# ---------------------------------------------------------------- phase 7

PROJECT_BATCH = 8                  # cli.project's default batch
PROJECT_STEPS = 60                 # the lr ramps up over 3 steps, down over 15
N_PROJECT_IMAGES = 9               # 7c: a batch of 8 and a tail of 1
NUDGES = (2.0 ** -22, -(2.0 ** -22), 2.0 ** -21)   # 7b's rounding floor


def projector_setup(dev, **cfg_kw):
    """((g, lpips, target, stats), seconds of the stats): the full-width
    f32 generator (seeded random weights), a seeded random VGG LPIPS,
    both frozen, a target the generator drew from seeded latents (so a
    perfect inversion exists), and ``estimate_latent_stats`` on its 10k
    draws.  The same every call."""
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.invert.projector import estimate_latent_stats
    from transeditor_tpu_torch.models.generator import Generator
    from transeditor_tpu_torch.zoo.lpips import LPIPS

    cfg = ModelConfig(**cfg_kw)
    g = Generator(cfg, device=dev, seed=0).eval().requires_grad_(False)
    lpips = LPIPS("vgg", device=dev, seed=0).requires_grad_(False)
    z, p = codes(PROJECT_BATCH, cfg.style_dim, seed=5)
    with torch.no_grad():
        target = g(z.to(dev), p.to(dev)).image.float()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = estimate_latent_stats(g, seed=0)
    torch.cuda.synchronize()
    return (g, lpips, target, stats), time.perf_counter() - t0


def projector_phase(fb, dev, card: str, **cfg_kw) -> dict:
    """7a (a main path, counted): ``estimate_latent_stats`` on its full
    10k draws, then ``project`` for PROJECT_STEPS steps at batch 8.  Each
    step is timed by the host clock between two synchronisations (a
    wrapper around ``projector_loss``, which each step calls once); the
    kernel's launches by role and path; peak memory.  Runs before the
    first torch.profiler window, as every host-clock timing does.
    ``cfg_kw`` narrows the model for a CPU rehearsal."""
    from transeditor_tpu_torch.invert import projector as proj

    (g, lpips, target, stats), stats_s = projector_setup(dev, **cfg_kw)
    ups = g.cfg.log_size - 2
    check(all(bool(torch.isfinite(t).all()) for t in stats)
          and bool((stats[1] > 0).all()), "latent statistics")
    pcfg = proj.ProjectorConfig(steps=PROJECT_STEPS, trace_every=1)
    proj.project(g, lpips, target, dataclasses.replace(pcfg, steps=2),
                 stats=stats, device=dev)       # warm: cuDNN, allocator

    stamps = []
    loss_fn = proj.projector_loss

    def timed_loss(*args, **kw):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return loss_fn(*args, **kw)

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    proj.projector_loss = timed_loss
    try:
        torch.cuda.synchronize()
        fb.launches.reset()                  # the main path starts here
        t0 = time.perf_counter()
        res = proj.project(g, lpips, target, pcfg, stats=stats, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fb.launches.by_role_path     # ... and ends here
    finally:
        proj.projector_loss = loss_fn
    peak = torch.cuda.max_memory_allocated()
    step_ms = (np.diff(stamps) * 1e3).tolist()
    flops = projector_step_flops(g, lpips, target, stats)
    trace = res["perceptual_trace"]
    want = {"forward": {"tma": ups * (PROJECT_STEPS + 1)},
            "adjoint": {"tma": ups * PROJECT_STEPS},
            "recompute": {"tma": ups * PROJECT_STEPS}}
    check(counts == want, f"projector launches {counts}, want {want}")
    check(np.isfinite(trace).all() and np.isfinite(res["z_plus"]).all()
          and np.isfinite(res["image"]).all(), "projector: non-finite")
    check(res["z_plus"].shape == (PROJECT_BATCH, 16, g.cfg.style_dim),
          f"z_plus {res['z_plus'].shape}")
    check(float(trace[-1]) < float(trace[0]),
          f"perceptual loss did not fall: {trace[0]} -> {trace[-1]}")
    out = {"steps": PROJECT_STEPS, "batch": PROJECT_BATCH,
           "stats_s": stats_s, "wall_s": wall, "step_ms": step_ms,
           "ms_per_step_median": float(np.median(step_ms)),
           "ms_per_step_mean": float(np.mean(step_ms)),
           "perceptual_first": float(trace[0]),
           "perceptual_last": float(trace[-1]),
           "launches": counts,
           "launches_per_step": {
               r: (n["tma"] - (ups if r == "forward" else 0)) / PROJECT_STEPS
               for r, n in counts.items()},
           "peak_bytes": peak, "peak_bytes_over_base": peak - base,
           "flops_per_step": flops,
           "bound_ms": flops / F32_FLOPS_PER_S * 1e3}
    print(f"projector: {g.cfg.size}px f32 batch {PROJECT_BATCH}, latent "
          f"statistics (10k draws) in {stats_s:.2f} s; {PROJECT_STEPS} "
          f"steps in {wall:.2f} s, {out['ms_per_step_median']:.2f} ms per "
          f"step (median; mean {out['ms_per_step_mean']:.2f}, host clock "
          f"between synchronised steps) on {card}; perceptual loss "
          f"{trace[0]:.4f} -> {trace[-1]:.4f}; fused_blur4 launches "
          f"{counts} (per step {out['launches_per_step']}, the final "
          f"decode adds {ups} forward); peak memory allocated "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB over "
          f"what was allocated before); {flops / 1e12:.3f} TFLOP a step "
          f"(torch.utils.flop_counter), bound {out['bound_ms']:.2f} ms at "
          f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s float32", flush=True)
    return out


def projector_step_flops(g, lpips, target, stats) -> int:
    """The floating-point operations of one projector step's objective
    and its gradients in z+ and p+ (convolutions and matmuls, as
    torch.utils.flop_counter counts them; the kernel's blur and the
    elementwise work are not in it)."""
    from torch.utils.flop_counter import FlopCounterMode
    from transeditor_tpu_torch.invert import projector as proj

    z_mean, _, p_mean = stats
    z = z_mean.expand(target.shape[0], *z_mean.shape).clone()
    p = p_mean.expand(target.shape[0], *p_mean.shape).clone()
    z.requires_grad_(True)
    p.requires_grad_(True)
    with FlopCounterMode(display=False) as counter:
        proj.projector_loss(g, lpips, target, z, p, None,
                            proj.ProjectorConfig())[0].backward()
    return counter.get_total_flops()


def kernel_table(prof, top: int = 6):
    """(busy us, fused_blur4 us, top kernels) of a torch.profiler run:
    device kernels only (CPU-side ops also carry the device time they
    launched, and a user annotation the span of its kernels)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(_dev_us(e) for e in events)
    blur_us = sum(_dev_us(e) for e in events if "fused_blur4" in e.key)
    events.sort(key=_dev_us, reverse=True)
    rows = [{"name": e.key[:60], "calls": e.count, "ms": _dev_us(e) / 1e3}
            for e in events[:top]]
    return busy_us, blur_us, rows


def profile_projector(dev, setup, steps: int = 3) -> dict:
    """7a's profile: one ``project`` call of ``steps`` steps (plus its
    final decode) under torch.profiler; the busy share is summed kernel
    time over the call's wall time, a lower bound (the profiler's own
    host cost is in the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    from transeditor_tpu_torch.invert import projector as proj

    g, lpips, target, stats = setup
    pcfg = proj.ProjectorConfig(steps=steps)
    proj.project(g, lpips, target, pcfg, stats=stats, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proj.project(g, lpips, target, pcfg, stats=stats, device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, blur_us, rows = kernel_table(prof)
    check(busy_us > 0, "the projector profile shows no device time")
    print(f"profile projector, {steps} steps + final decode, f32 batch "
          f"{PROJECT_BATCH}: device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({busy_us / wall_us:.1%}); "
          f"fused_blur4 {blur_us / 1e3:.3f} ms", flush=True)
    for r in rows:
        print(f"  {r['ms']:9.3f} ms  x{r['calls']:<4d} {r['name']}",
              flush=True)
    return {"steps": steps, "busy_ms": busy_us / 1e3,
            "wall_ms": wall_us / 1e3, "busy_share": busy_us / wall_us,
            "fused_blur4_ms": blur_us / 1e3, "top": rows}


def projector_split(dev, setup, reps: int = 5) -> dict:
    """7a's layers: device time (CUDA events around ``reps`` calls after
    a warm one) of the step's objective and gradients, of the generator
    half (decode + gradients in z+ and p+ under a fixed cotangent) and of
    the LPIPS half (distance + gradient in the image), with cuDNN's
    heuristic algorithm choice (the port's setting) and with
    ``cudnn.benchmark`` (autotuned, not used by the port)."""
    from transeditor_tpu_torch.invert import projector as proj

    g, lpips, target, stats = setup
    z_mean, _, p_mean = stats
    pcfg = proj.ProjectorConfig()

    def latents():
        z = z_mean.expand(PROJECT_BATCH, *z_mean.shape).clone()
        p = p_mean.expand(PROJECT_BATCH, *p_mean.shape).clone()
        return z.requires_grad_(True), p.requires_grad_(True)

    z, p = latents()
    cot = torch.randn(target.shape, device=dev,
                      generator=torch.Generator(dev).manual_seed(3))
    img = proj._decode(g, z, p, None, None).detach().requires_grad_(True)

    def step():
        total = proj.projector_loss(g, lpips, target, z, p, None, pcfg)[0]
        torch.autograd.grad(total, (z, p))

    def generator_half():
        out = proj._decode(g, z, p, None, None)
        torch.autograd.grad(out, (z, p), cot)

    def lpips_half():
        torch.autograd.grad(lpips(img, target).sum(), img)

    saved = torch.backends.cudnn.benchmark
    out = {}
    try:
        for mode in (False, True):
            torch.backends.cudnn.benchmark = mode
            key = "autotuned" if mode else "heuristic"
            out[key] = {name: time_ms(fn, reps=reps, warm=2)
                        for name, fn in (("step", step),
                                         ("generator", generator_half),
                                         ("lpips", lpips_half))}
    finally:
        torch.backends.cudnn.benchmark = saved
    print(f"projector step by layer, f32 batch {PROJECT_BATCH} (events, "
          f"ms): cuDNN heuristic (the port) {out['heuristic']}; "
          f"cudnn.benchmark (not used) {out['autotuned']}", flush=True)
    return out


def projector_vs_plain(fb, dev, setup) -> dict:
    """7b, on one full-width projector step (the objective at the latent
    statistics' means, as step 0 sees it, and its gradients in z+ and
    p+), two holds of the kernel against ``fused_blur4_plain``:

    * each of the step's launches (6 forward, 6 adjoint, 6 recompute) is
      replayed through the plain version on the very inputs it was given,
      within 1e-5 of the plain output's largest magnitude;
    * the step's gradients against the same step with ``fused_blur._blur``
      replaced by the plain version (here only), the image the LPIPS sees
      pinned to the plain run's in both (its value exactly; the gradient
      flows through each run's own generator), within 3x a rounding floor
      or 1e-4 (relative L2).  The floor is the largest change the kernel
      run shows when z+ and p+ are scaled by 1 + d, d in NUDGES.  This
      hold is coarse: the generator's leaky ReLUs are kinks, and at this
      width some of their inputs lie within rounding of 0, so the
      gradient itself moves by 1e-4 to 1e-3 under a one-ulp change of its
      inputs, and the two runs differ by rounding."""
    from transeditor_tpu_torch.invert import projector as proj

    g, lpips, target, stats = setup
    z_mean, _, p_mean = stats
    pcfg = proj.ProjectorConfig()
    decode = proj._decode
    blur = fb._blur

    def latents(scale: float = 1.0):
        z = (z_mean.expand(PROJECT_BATCH, *z_mean.shape) * scale).clone()
        p = (p_mean.expand(PROJECT_BATCH, *p_mean.shape) * scale).clone()
        return z.requires_grad_(True), p.requires_grad_(True)

    def grads(scale: float = 1.0):
        def pinned(*args):
            img = decode(*args)
            return pin + (img - img.detach())

        z, p = latents(scale)
        proj._decode = pinned
        try:
            total = proj.projector_loss(g, lpips, target, z, p, None,
                                        pcfg)[0]
            return [t.detach() for t in torch.autograd.grad(total, (z, p))]
        finally:
            proj._decode = decode

    def errors(got, want):
        return {n: {"l2": ((a - b).norm() / b.norm()).item(),
                    "max": ((a - b).abs().max() / b.abs().max()).item()}
                for n, a, b in zip(("z+", "p+"), got, want)}

    calls = []

    def recording(x, taps, pad, scale, bias, act, role):
        y = blur(x, taps, pad, scale, bias, act, role)
        calls.append((role, x, taps, pad, scale, bias, act, y))
        return y

    fb._blur = (lambda x, taps, pad, scale, bias, act, role:
                fb.fused_blur4_plain(x, taps, pad, scale, bias, act))
    try:
        before = fb.launches.value
        with torch.no_grad():
            pin = decode(g, *latents(), None, None)
        plain = grads()
        torch.cuda.synchronize()
        check(fb.launches.value == before, "the plain run launched")
        torch.cuda.synchronize()
        fb.launches.reset()
        fb._blur = recording
        kernel = grads()
        torch.cuda.synchronize()
        roles = fb.launches.by_role_path
    finally:
        fb._blur = blur
    ups = g.cfg.log_size - 2
    check(len(calls) == 3 * ups, f"7b recorded {len(calls)} launches")
    replay = {}
    for role, x, taps, pad, scale, bias, act, y in calls:
        want = fb.fused_blur4_plain(x, taps, pad, scale, bias, act)
        rel = ((y - want).abs().max() / want.abs().max()).item()
        check(rel <= 1e-5, f"7b {role} launch {tuple(x.shape)}: {rel} of "
                           f"the plain output's largest")
        replay[role] = max(replay.get(role, 0.0), rel)
    del calls
    nudged = [grads(1.0 + d) for d in NUDGES]
    errs = errors(kernel, plain)
    floors = [errors(n, kernel) for n in nudged]
    floor = {n: {k: max(f[n][k] for f in floors) for k in ("l2", "max")}
             for n in errs}
    want = {r: {"tma": ups} for r in ("forward", "adjoint", "recompute")}
    check(roles == want, f"7b kernel launches {roles}, want {want}")
    limits = {n: max(3 * floor[n]["l2"], 1e-4) for n in errs}
    print(f"projector step card kernel vs plain ({g.cfg.size}px f32 batch "
          f"{PROJECT_BATCH}): each launch replayed through the plain "
          f"version, largest error by role (share of the plain output's "
          f"largest, limit 1e-5) {replay}; gradients in z+ and p+, the "
          f"LPIPS image pinned to the plain run's: {errs}; rounding floor "
          f"(the largest over z+, p+ x (1 + d), d in {NUDGES}) {floor}; "
          f"limits on L2 {limits}; launches {roles}", flush=True)
    for n, e in errs.items():
        check(e["l2"] <= limits[n], f"7b {n}: L2 {e['l2']} > {limits[n]}")
    return {"launch_errors": replay, "errors": errs,
            "rounding_floor": floor, "limits": limits, "launches": roles,
            "max_abs_err": max((a - b).abs().max().item()
                               for a, b in zip(kernel, plain))}


def project_cli_phase(fb, dev, root: pathlib.Path, g,
                      model_argv: list) -> dict:
    """7c (a main path, counted): ``cli.project.main`` in this process on
    N_PROJECT_IMAGES PNGs (a reference ``.pt`` holding ``g``'s weights,
    a random LPIPS) with ``--step 10 --batch 8``, so the tail batch of 1
    is padded to 8: every output file, latents of shape (9, 16, 512),
    finite, and the tail's own row (not a padded one) kept."""
    from transeditor_tpu_torch.cli import project as cli_project
    from transeditor_tpu_torch.utils.image import load_png, save_png

    data, out = root / "project_pngs", root / "project_out"
    data.mkdir(parents=True)
    for i, img in enumerate(smooth_images(N_PROJECT_IMAGES, g.cfg.size,
                                          seed=2)):
        save_png(str(data / f"{i:05d}.png"), img)
    ckpt = root / "g.pt"
    torch.save({"g_ema": {k: v.cpu() for k, v in g.state_dict().items()}},
               ckpt)
    steps = 10
    argv = ["--ckpt", str(ckpt), "--dataset_dir", str(data), "--step",
            str(steps), "--batch", str(PROJECT_BATCH), "--output_dir",
            str(out), *model_argv]
    torch.cuda.synchronize()
    fb.launches.reset()                       # the main path starts here
    t0 = time.perf_counter()
    cli_project.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fb.launches.by_role_path         # ... and ends here

    n = N_PROJECT_IMAGES
    names = {f"{k}_{i}.png" for k in ("origin", "project") for i in range(n)}
    names |= {"latents.npy", "param.npy"}
    check(set(os.listdir(out)) == names,
          f"cli.project wrote {sorted(os.listdir(out))}")
    z, p = np.load(out / "latents.npy"), np.load(out / "param.npy")
    check(z.shape == p.shape == (n, 16, 512), f"latents {z.shape} {p.shape}")
    check(np.isfinite(z).all() and np.isfinite(p).all(), "latents finite")
    check(not np.allclose(z[n - 1], z[n - 2]),
          "the tail image's latents equal the image before it")
    proj_img = load_png(str(out / f"project_{n - 1}.png"))
    check(proj_img.shape == (g.cfg.size, g.cfg.size, 3), str(proj_img.shape))
    ups = g.cfg.log_size - 2
    batches = -(-n // PROJECT_BATCH)
    want = {"forward": {"tma": batches * ups * (steps + 1)},
            "adjoint": {"tma": batches * ups * steps},
            "recompute": {"tma": batches * ups * steps}}
    check(counts == want, f"cli.project launches {counts}, want {want}")
    print(f"cli project: {n} images at batch {PROJECT_BATCH} (tail of "
          f"{n % PROJECT_BATCH} padded), {steps} steps a batch, in "
          f"{wall:.2f} s; all {len(names)} files; latents {z.shape}; "
          f"fused_blur4 launches {counts}", flush=True)
    return {"wall_s": wall, "launches": counts, "latents_shape": z.shape}


# ---------------------------------------------------------------- phase 8

COACH_BATCH = 8                    # CoachConfig().batch_size
COACH_STEPS = 10                   # timed train steps after a warm one
ENCODE_REPS = 5
N_ENCODE_IMAGES = 9                # 8c: a batch of 8 and a tail of 1
CLI_COACH_STEPS = 4                # 8c: val and checkpoint at step 2


def coach_setup(dev, coach_kw=None, encoder_kw=None, **cfg_kw) -> dict:
    """The coach at full width: the f32 ``ModelConfig()`` decoder (seeded
    random weights, frozen), a seeded random AlexNet LPIPS, a seeded
    random IR-SE-50 ArcFace for the ID loss, the latent average of 10k
    mapped draws, ``CoachConfig(use_fake_lambda=0.5)`` at batch 8, its
    steps (``make_coach``) and a fresh state (the default
    ``GradualStyleEncoder``, torch's initialisers drawn from seed 2), and
    8 real images: the decoder's own for seeded latents.  ``coach_kw``,
    ``encoder_kw`` and ``cfg_kw`` narrow it for a CPU rehearsal."""
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.models.generator import Generator
    from transeditor_tpu_torch.models.irse import ArcFaceBackbone, init_weights
    from transeditor_tpu_torch.models.psp import GradualStyleEncoder, PSPModel
    from transeditor_tpu_torch.train import coach
    from transeditor_tpu_torch.zoo.lpips import LPIPS

    cfg = ModelConfig(**cfg_kw)
    ccfg = coach.CoachConfig(batch_size=COACH_BATCH, use_fake_lambda=0.5,
                             **(coach_kw or {}))
    g = Generator(cfg, device=dev, seed=0).eval()
    lpips = LPIPS("alex", device=dev, seed=0)
    arc = init_weights(ArcFaceBackbone(), torch.Generator().manual_seed(1))
    id_loss = (coach.make_arcface_id_loss(arc.to(dev))
               if ccfg.id_lambda > 0 else None)
    avg = PSPModel(None, g).estimate_latent_avg(
        torch.Generator(dev).manual_seed(1))
    init_fn, train, evals, fake = coach.make_coach(cfg, ccfg, g, lpips,
                                                   id_loss, avg)
    enc = init_weights(GradualStyleEncoder(**(encoder_kw or {})),
                       torch.Generator().manual_seed(2))
    z, p = codes(COACH_BATCH, cfg.style_dim, seed=6)
    with torch.no_grad():
        real = g(z.to(dev), p.to(dev)).image.float()
    return {"cfg": cfg, "ccfg": ccfg, "g": g, "avg": avg, "train": train,
            "eval": evals, "fake": fake, "state": init_fn(enc),
            "real": real}


def coach_step_flops(setup) -> int:
    """The floating-point operations of one coach train step (its
    convolutions and matmuls as torch.utils.flop_counter counts them:
    forward and backward through the encoder, the decoder, the LPIPS and
    ArcFace; the kernel's blur, the elementwise work and the optimizer
    are not in it).  It runs one step."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        setup["train"](setup["state"], setup["real"])
    return counter.get_total_flops()


def coach_phase(fb, dev, card: str, setup) -> dict:
    """8a (a main path, counted): one warm train, fake and eval step, then
    COACH_STEPS train steps (steps 2-11: RAdam's unrectified branch and
    its rectified one from step 6), each timed by the host clock between
    two synchronisations, one fake step and one eval step, each counted
    by role and path; peak memory over the steps; ``DualSpaceEncoder.
    encode`` img/s at batch 8; the step's flop count and its float32
    bound.  Runs before the first torch.profiler window, as every
    host-clock timing does."""
    from transeditor_tpu_torch.invert.dual_space import DualSpaceEncoder

    train, evals, fake = setup["train"], setup["eval"], setup["fake"]
    state, real = setup["state"], setup["real"]
    ups = setup["cfg"].log_size - 2
    rng = torch.Generator(dev).manual_seed(4)
    _, first, _ = train(state, real)              # warm: cuDNN, allocator
    fake(state, rng=rng)
    evals(state, real)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fb.launches.reset()                           # the main path starts here
    stamps = [time.perf_counter()]
    for _ in range(COACH_STEPS):
        state, logs, inv = train(state, real)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    train_counts = fb.launches.by_role_path
    fb.launches.reset()
    t0 = time.perf_counter()
    _, fake_loss = fake(state, rng=rng)
    torch.cuda.synchronize()
    fake_ms = (time.perf_counter() - t0) * 1e3
    fake_counts = fb.launches.by_role_path
    fb.launches.reset()
    t0 = time.perf_counter()
    vlogs, vinv = evals(state, real)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    eval_counts = fb.launches.by_role_path        # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    step_ms = (np.diff(stamps) * 1e3).tolist()

    want = {r: {"tma": ups * COACH_STEPS}
            for r in ("forward", "adjoint", "recompute")}
    check(train_counts == want, f"coach train launches {train_counts}, "
                                f"want {want}")
    check(fake_counts == {"forward": {"tma": ups}},
          f"coach fake launches {fake_counts}")
    check(eval_counts == {"forward": {"tma": ups}},
          f"coach eval launches {eval_counts}")
    values = [float(v) for v in (*logs.values(), *vlogs.values(),
                                 fake_loss, first["loss"])]
    check(all(np.isfinite(values)), f"coach losses {logs} {vlogs}")
    check(state.step == COACH_STEPS + 1, f"coach step {state.step}")
    check(tuple(inv.shape) == tuple(real.shape)
          and bool(torch.isfinite(inv).all()), "coach inversions")

    dse = DualSpaceEncoder(setup["g"], state.encoder, setup["avg"])
    z, p = dse.encode(real)                       # warm
    check(z.shape == p.shape == (COACH_BATCH, 16, setup["cfg"].style_dim)
          and np.isfinite(z).all(), f"encode {z.shape}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENCODE_REPS):
        dse.encode(real)
    encode_s = (time.perf_counter() - t0) / ENCODE_REPS
    flops = coach_step_flops(setup)
    out = {"batch": COACH_BATCH, "steps": COACH_STEPS, "step_ms": step_ms,
           "ms_per_step_median": float(np.median(step_ms)),
           "ms_per_step_mean": float(np.mean(step_ms)),
           "fake_step_ms": fake_ms, "eval_step_ms": eval_ms,
           "encode_img_per_s": COACH_BATCH / encode_s,
           "loss_first": float(first["loss"]), "loss_last": float(logs["loss"]),
           "logs": {k: float(v) for k, v in logs.items()},
           "launches": {"train": train_counts, "fake": fake_counts,
                        "eval": eval_counts},
           "launches_per_step": {
               "train": {r: n["tma"] / COACH_STEPS
                         for r, n in train_counts.items()},
               "fake": fake_counts, "eval": eval_counts},
           "peak_bytes": peak, "peak_bytes_over_base": peak - base,
           "flops_per_step": flops,
           "bound_ms": flops / F32_FLOPS_PER_S * 1e3}
    print(f"coach: {setup['cfg'].size}px f32 batch {COACH_BATCH}, default "
          f"encoder (IR-SE-50, 14 + 16 heads), ID + L2 + LPIPS-alex; "
          f"{COACH_STEPS} train steps {out['ms_per_step_median']:.2f} ms "
          f"per step (median; mean {out['ms_per_step_mean']:.2f}, host "
          f"clock between synchronised steps) on {card}; fake step "
          f"{fake_ms:.2f} ms, eval step {eval_ms:.2f} ms; "
          f"DualSpaceEncoder.encode {out['encode_img_per_s']:.1f} img/s at "
          f"batch {COACH_BATCH}; loss {out['loss_first']:.4f} -> "
          f"{out['loss_last']:.4f}; fused_blur4 launches per step "
          f"{out['launches_per_step']}; peak memory allocated "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB over "
          f"what was allocated before); {flops / 1e12:.3f} TFLOP a train "
          f"step (torch.utils.flop_counter), bound {out['bound_ms']:.2f} ms "
          f"at {F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s float32", flush=True)
    return out


def profile_coach(dev, setup) -> dict:
    """8a's profile: one train step (after a warm one) under
    torch.profiler; the busy share is summed kernel time over the step's
    wall time, a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    train, state, real = setup["train"], setup["state"], setup["real"]
    train(state, real)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(state, real)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, blur_us, rows = kernel_table(prof, top=8)
    check(busy_us > 0, "the coach profile shows no device time")
    # the optimizer's annotation: the device span of the Ranger update
    opt_us = sum(_dev_us(e) for e in prof.key_averages()
                 if getattr(e, "is_user_annotation", False)
                 and "Ranger" in e.key)
    print(f"profile coach train step, f32 batch {COACH_BATCH}: device busy "
          f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
          f"({busy_us / wall_us:.1%}); fused_blur4 {blur_us / 1e3:.3f} ms; "
          f"the Ranger update spans {opt_us / 1e3:.3f} ms of the device's "
          f"timeline", flush=True)
    for r in rows:
        print(f"  {r['ms']:9.3f} ms  x{r['calls']:<4d} {r['name']}",
              flush=True)
    return {"busy_ms": busy_us / 1e3, "wall_ms": wall_us / 1e3,
            "busy_share": busy_us / wall_us, "ranger_span_ms": opt_us / 1e3,
            "fused_blur4_ms": blur_us / 1e3, "top": rows}


def coach_vs_plain(fb, dev, setup) -> dict:
    """8b, first hold: each ``fused_blur4`` launch of one full-width train
    step (6 forward, 6 adjoint, 6 recompute) replayed through
    ``fused_blur4_plain`` on the very inputs it was given, within 1e-5 of
    the plain output's largest magnitude."""
    blur = fb._blur
    calls = []

    def recording(x, taps, pad, scale, bias, act, role):
        y = blur(x, taps, pad, scale, bias, act, role)
        calls.append((role, x, taps, pad, scale, bias, act, y))
        return y

    torch.cuda.synchronize()
    fb.launches.reset()
    fb._blur = recording
    try:
        setup["train"](setup["state"], setup["real"])
        torch.cuda.synchronize()
    finally:
        fb._blur = blur
    roles = fb.launches.by_role_path
    ups = setup["cfg"].log_size - 2
    want = {r: {"tma": ups} for r in ("forward", "adjoint", "recompute")}
    check(roles == want, f"8b launches {roles}, want {want}")
    replay, worst_abs = {}, 0.0
    for role, x, taps, pad, scale, bias, act, y in calls:
        ref = fb.fused_blur4_plain(x, taps, pad, scale, bias, act)
        err = (y - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        check(rel <= 1e-5, f"8b {role} launch {tuple(x.shape)}: {rel} of "
                           f"the plain output's largest")
        replay[role] = max(replay.get(role, 0.0), rel)
        worst_abs = max(worst_abs, err)
    del calls
    print(f"coach train step, each of its {3 * ups} fused_blur4 launches "
          f"replayed through the plain version: largest error by role "
          f"(share of the plain output's largest, limit 1e-5) {replay}; "
          f"launches {roles}", flush=True)
    return {"launch_errors": replay, "max_abs_err": worst_abs,
            "launches": roles}


def coach_card_vs_cpu(fb, dev, batch: int = 4, encoder_kw=None,
                      **cfg_kw) -> dict:
    """8b, second hold: one coach train step of a 64px decoder (max
    channels 128, two interaction blocks) and the default encoder on the
    card (the kernel) and on the CPU (the plain version), same weights
    and images, L2 + LPIPS-alex (the ID loss needs 224px).  The checked
    card run computes its convolutions without cuDNN, as 5b's does.
    Held: every encoder gradient (worst per-tensor L2 error) within 3x
    a rounding floor (the CPU step with the images scaled by 1 + 2**-22),
    or 1e-4 where the floor is smaller; the losses likewise; every
    parameter after the Ranger update within 0.1 lr.  ``encoder_kw`` and
    ``cfg_kw`` narrow it for a CPU rehearsal."""
    import copy

    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.models.generator import Generator
    from transeditor_tpu_torch.models.irse import init_weights
    from transeditor_tpu_torch.models.psp import GradualStyleEncoder, PSPModel
    from transeditor_tpu_torch.train import coach
    from transeditor_tpu_torch.zoo.lpips import LPIPS

    cfg = ModelConfig(**(cfg_kw or dict(size=64, max_channels=128,
                                         n_trans=2)))
    size = cfg.size
    ccfg = coach.CoachConfig(batch_size=batch, id_lambda=0.0)
    cpu = torch.device("cpu")
    g = Generator(cfg, device=cpu, seed=0).eval()
    lpips = LPIPS("alex", device=cpu, seed=0)
    avg = PSPModel(None, g).estimate_latent_avg(0, n_samples=2000)
    enc = init_weights(GradualStyleEncoder(**(encoder_kw or {})),
                       torch.Generator().manual_seed(2))
    real = torch.from_numpy(smooth_images(batch, size, seed=9)).float()
    real = real / 127.5 - 1.0

    def run(d, scale=1.0, keep_params=False):
        init_fn, train, _, _ = coach.make_coach(
            cfg, ccfg, copy.deepcopy(g).to(d), copy.deepcopy(lpips).to(d),
            None, [a.to(d) for a in avg])
        state = init_fn(copy.deepcopy(enc))
        _, logs, _ = train(state, (real * scale).to(d))
        named = list(state.encoder.named_parameters())
        return ({k: float(v) for k, v in logs.items()},
                {n: p.grad.detach().cpu() for n, p in named},
                {n: p.detach().cpu() for n, p in named} if keep_params
                else None)

    def errors(got, want):
        top = max(w.norm().item() for w in want.values())
        return max(((got[n] - w).norm().item() / max(w.norm().item(),
                                                     1e-6 * top), n)
                   for n, w in want.items())

    m_cpu, g_cpu, p_cpu = run(cpu, keep_params=True)
    m_nudged, g_nudged, _ = run(cpu, 1.0 + 2.0 ** -22)
    m_cudnn, g_cudnn, _ = run(dev)
    torch.backends.cudnn.enabled = False
    try:
        torch.cuda.synchronize()
        fb.launches.reset()
        m_card, g_card, p_card = run(dev, keep_params=True)
        torch.cuda.synchronize()
        roles = fb.launches.by_role_path
    finally:
        torch.backends.cudnn.enabled = True
    ups = cfg.log_size - 2
    want = {r: {"tma": ups} for r in ("forward", "adjoint", "recompute")}
    check(roles == want, f"8b card-vs-CPU launches {roles}, want {want}")
    err, at = errors(g_card, g_cpu)
    floor, floor_at = errors(g_nudged, g_cpu)
    err_cudnn, _ = errors(g_cudnn, g_cpu)
    limit = max(3 * floor, 1e-4)
    param_err = max((p_card[n] - p).abs().max().item()
                    for n, p in p_cpu.items())
    metrics = {k: {"card": m_card[k], "cpu": m_cpu[k],
                   "nudged_cpu": m_nudged[k], "card_cudnn": m_cudnn[k]}
               for k in m_cpu}
    print(f"coach step card vs CPU ({size}px decoder, "
          f"{'default encoder' if not encoder_kw else encoder_kw}, "
          f"batch {batch}, L2 + LPIPS-alex): losses {metrics}; encoder "
          f"gradients, worst per-tensor L2: kernel, no cuDNN {err:.3e} "
          f"({at}); with cuDNN (not checked) {err_cudnn:.3e}; rounding "
          f"floor (CPU, images x (1 + 2**-22)) {floor:.3e} ({floor_at}); "
          f"limit {limit:.3e}; parameters after the step, largest "
          f"difference {param_err:.3e} (limit 0.1 lr = "
          f"{0.1 * ccfg.learning_rate:.1e}); launches {roles}", flush=True)
    check(err <= limit, f"8b coach gradients: L2 {err} ({at}) > {limit}")
    check(param_err <= 0.1 * ccfg.learning_rate,
          f"8b coach parameters: {param_err}")
    for k, m in metrics.items():
        e, f = abs(m["card"] - m["cpu"]), abs(m["nudged_cpu"] - m["cpu"])
        check(e <= max(3 * f, 1e-4 * abs(m["cpu"]) + 1e-6), f"8b {k}: {m}")
    return {"grad_l2": err, "grad_l2_at": at, "grad_l2_cudnn": err_cudnn,
            "rounding_floor": floor, "limit": limit, "param_err": param_err,
            "metrics": metrics, "launches": roles}


def encoder_cli_phase(fb, dev, root: pathlib.Path, g,
                      model_argv: list) -> dict:
    """8c (a main path, counted): ``cli.train_encoder.main`` in this
    process on N_ENCODE_IMAGES PNGs (train and validation folder alike;
    a reference ``.pt`` holding ``g``'s weights; random LPIPS, no
    ArcFace) for CLI_COACH_STEPS steps at batch 8 with ``--val_interval
    2 --save_interval 2``: ``best_model.pt``, ``ckpt_000002.pt`` and the
    validation grids; then ``cli.encode.main --save_inversions`` from that
    ``best_model.pt`` at batch 8 (a tail of 1): encoded_z / encoded_p of
    shape (9, 16, 512), finite, and every inversion PNG.  Launches by
    role are counted around each CLI."""
    import warnings

    from transeditor_tpu_torch.cli import encode as cli_encode
    from transeditor_tpu_torch.cli import train_encoder as cli_train
    from transeditor_tpu_torch.utils.image import load_png, save_png

    data, exp, out = root / "coach_pngs", root / "coach_exp", root / "enc"
    data.mkdir(parents=True)
    size, n = g.cfg.size, N_ENCODE_IMAGES
    for i, img in enumerate(smooth_images(n, size, seed=3)):
        save_png(str(data / f"{i:05d}.png"), img)
    ckpt = root / "g_coach.pt"
    torch.save({"g_ema": {k: v.cpu() for k, v in g.state_dict().items()}},
               ckpt)
    argv = ["--ckpt", str(ckpt), "--dataset_dir", str(data),
            "--test_dataset_dir", str(data), "--exp_dir", str(exp),
            "--max_steps", str(CLI_COACH_STEPS), "--batch_size",
            str(COACH_BATCH), "--val_interval", "2", "--save_interval", "2",
            *model_argv]
    torch.cuda.synchronize()
    fb.launches.reset()                       # the main path starts here
    t0 = time.perf_counter()
    with warnings.catch_warnings():           # random LPIPS, no ArcFace
        warnings.simplefilter("ignore", UserWarning)
        cli_train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = fb.launches.by_role_path   # ... and ends here
    names = sorted(os.listdir(exp))
    check(names == ["best_model.pt", "ckpt_000002.pt", "logs",
                    "val_000000.png", "val_000002.png"],
          f"cli.train_encoder wrote {names}")
    ups = g.cfg.log_size - 2
    evals = 2 * -(-n // COACH_BATCH)          # 2 validations of 2 batches
    want = {"forward": {"tma": ups * (CLI_COACH_STEPS + evals)},
            "adjoint": {"tma": ups * CLI_COACH_STEPS},
            "recompute": {"tma": ups * CLI_COACH_STEPS}}
    check(train_counts == want,
          f"cli.train_encoder launches {train_counts}, want {want}")

    torch.cuda.synchronize()
    fb.launches.reset()                       # the main path starts here
    t0 = time.perf_counter()
    cli_encode.main(["--decoder_ckpt", str(ckpt), "--encoder_ckpt",
                     str(exp / "best_model.pt"), "--data_dir", str(data),
                     "--out_dir", str(out), "--batch", str(COACH_BATCH),
                     "--save_inversions", *model_argv])
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    encode_counts = fb.launches.by_role_path  # ... and ends here
    batches = -(-n // COACH_BATCH)
    check(encode_counts == {"forward": {"tma": ups * batches}},
          f"cli.encode launches {encode_counts}")
    files = {f"inversion_{i}.png" for i in range(n)}
    files |= {"encoded_z.npy", "encoded_p.npy"}
    check(set(os.listdir(out)) == files,
          f"cli.encode wrote {sorted(os.listdir(out))}")
    z, p = np.load(out / "encoded_z.npy"), np.load(out / "encoded_p.npy")
    dim = g.cfg.style_dim
    check(z.shape == p.shape == (n, 16, dim) and z.dtype == np.float32,
          f"encoded {z.shape} {p.shape} {z.dtype}")
    check(np.isfinite(z).all() and np.isfinite(p).all(), "encoded finite")
    check(load_png(str(out / f"inversion_{n - 1}.png")).shape
          == (size, size, 3), "inversion png")
    print(f"cli train_encoder: {CLI_COACH_STEPS} steps at batch "
          f"{COACH_BATCH} with validation at steps 0 and 2 in "
          f"{train_s:.2f} s, wrote {names}, fused_blur4 launches "
          f"{train_counts}; cli encode --save_inversions: {n} images at "
          f"batch {COACH_BATCH} (a tail of {n % COACH_BATCH}) in "
          f"{encode_s:.2f} s, encoded {z.shape}, launches {encode_counts}",
          flush=True)
    return {"train_s": train_s, "encode_s": encode_s,
            "launches": {"train_encoder": train_counts,
                         "encode": encode_counts}}


# ---------------------------------------------------------------- phase 9

EDIT_BATCH = 64                    # cli.edit's default --batch
EDIT_SAMPLES = 3200                # 9a: 50 scored batches
PROTOCOL_SAMPLES = 150_000         # the reference's --num_sample
EDIT_STEPS = 61                    # cli.edit's default --steps
STRIP_SAMPLES = 2                  # 9c: timed edited samples
SVM_ROWS, SVM_CHOSEN = 6000, 3000  # 9b: 2,100 + 2,100 train, 900 + 900 val
SVM_DIM = 16 * 512                 # the flattened plus space
SVM_COS_GAP = 1e-6                 # 9b: card vs CPU normals, 1 - cosine
N_CLI_SAMPLES = 640                # 9e: cli.edit --num_sample (10 batches)
CLI_EDIT_BATCH = 64                # ... at cli.edit's default --batch
N_CLI_EDITS = 2                    # 9e: --n_edit_samples
SCORE_REL = 1e-4                   # 9d: card vs CPU scores


def edit_setup(dev, root: pathlib.Path, **cfg_kw) -> dict:
    """Phase 9's model and classifier checkpoints: the bf16 generator of
    ``ModelConfig()`` (seeded random weights; ``cfg_kw`` narrows it for a
    CPU rehearsal) and, in ``root``, random reference-layout state dicts
    drawn from seeded ``torch.Generator``s: the DEX age VGG16, the pose
    resnet18, the CelebA-HQ Smiling net and an IR-SE-50 ArcFace."""
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.edit.classifiers import random_classifier
    from transeditor_tpu_torch.models.generator import Generator
    from transeditor_tpu_torch.models.irse import (ArcFaceBackbone,
                                                   init_weights)

    root.mkdir(parents=True, exist_ok=True)
    ckpt = {}
    for seed, attr in enumerate(("age", "pose", "Smiling")):
        net = random_classifier(attr, torch.Generator().manual_seed(seed))
        ckpt[attr] = str(root / f"{attr}.pth")
        torch.save(net.state_dict(), ckpt[attr])
    arc = init_weights(ArcFaceBackbone(), torch.Generator().manual_seed(3))
    ckpt["arcface"] = str(root / "ir_se50.pth")
    torch.save(arc.state_dict(), ckpt["arcface"])
    g = Generator(ModelConfig(dtype="bfloat16", **cfg_kw), device=dev,
                  seed=0).eval()
    return {"g": g, "cfg_kw": cfg_kw, "ckpt": ckpt, "root": root}


def edit_sweep_phase(fb, dev, card: str, setup) -> dict:
    """9a (a main path, counted): ``collect_scored_latents`` of
    EDIT_SAMPLES samples at batch 64 with the bf16 generator and the DEX
    age scorer (its checkpoint through ``load_scorer_from_checkpoint``),
    after one warm batch.  Host clock over the run (img/s scored, the
    150k protocol's card time extrapolated); CUDA events split each
    batch's decode (sample, map, decode) from its score; peak memory; the
    DEX forward's flops on one batch (float32 bound at 67 TFLOP/s)."""
    from torch.utils.flop_counter import FlopCounterMode

    from transeditor_tpu_torch.edit import sweep
    from transeditor_tpu_torch.edit.classifiers import (
        load_scorer_from_checkpoint)

    g = setup["g"]
    ups = g.cfg.log_size - 2
    t0 = time.perf_counter()
    scorer = load_scorer_from_checkpoint("age", setup["ckpt"]["age"], dev)
    load_s = time.perf_counter() - t0
    sweep.collect_scored_latents(g, scorer, n_samples=EDIT_BATCH,
                                 batch=EDIT_BATCH, seed=1)     # warm
    spans, marks = [], []

    def timed(img):
        s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s0.record()
        out = scorer(img)
        s1.record()
        spans.append((s0, s1))
        return out

    def progress(_):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)

    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fb.launches.reset()                       # the main path starts here
    t0 = time.perf_counter()
    start.record()
    z, p, s = sweep.collect_scored_latents(g, timed, n_samples=EDIT_SAMPLES,
                                           batch=EDIT_BATCH, seed=0,
                                           progress=progress)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fb.launches.by_role_path         # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    batches = -(-EDIT_SAMPLES // EDIT_BATCH)
    check(counts == {"forward": {"tma": ups * batches}},
          f"9a launches {counts}")
    dim = g.cfg.n_tokens * g.cfg.style_dim
    check(z.shape == p.shape == (EDIT_SAMPLES, dim), f"9a codes {z.shape}")
    check(bool(np.isfinite(z).all() and np.isfinite(p).all()
               and np.isfinite(s).all()), "9a non-finite codes or scores")
    decode_ms = [a.elapsed_time(b[0]) for a, b in
                 zip([start] + marks[:-1], spans)]
    score_ms = [a.elapsed_time(b) for a, b in spans]
    img_s = EDIT_SAMPLES / wall

    img = torch.rand((EDIT_BATCH, g.cfg.size, g.cfg.size, 3), device=dev,
                     generator=torch.Generator(dev).manual_seed(2)) * 2 - 1
    with FlopCounterMode(display=False) as counter:
        scorer(img)
    flops = counter.get_total_flops()
    others = {}
    for attr in ("pose", "Smiling"):
        sc = load_scorer_from_checkpoint(attr, setup["ckpt"][attr], dev)
        others[attr] = time_ms(lambda: sc(img), reps=5, warm=2)
    out = {"samples": EDIT_SAMPLES, "batch": EDIT_BATCH, "wall_s": wall,
           "img_per_s": img_s, "load_scorer_s": load_s,
           "decode_ms_median": float(np.median(decode_ms)),
           "score_ms_median": float(np.median(score_ms)),
           "dex_batch_gflop": flops / 1e9,
           "dex_batch_bound_ms": flops / F32_FLOPS_PER_S * 1e3,
           "peak_gib": peak / 2 ** 30,
           "over_resident_gib": (peak - resident) / 2 ** 30,
           "protocol_card_s": PROTOCOL_SAMPLES / img_s,
           "scorer_batch_ms": others, "launches": counts,
           "score_mean": float(s.mean()), "score_std": float(s.std())}
    print(f"9a scoring sweep: {EDIT_SAMPLES} samples, bf16 {g.cfg.size}px "
          f"generator + f32 DEX age at batch {EDIT_BATCH}: {wall:.2f} s, "
          f"{img_s:.1f} img/s scored on {card}; a batch's decode "
          f"{out['decode_ms_median']:.3f} ms, score "
          f"{out['score_ms_median']:.3f} ms (medians, events; DEX "
          f"{flops / 1e9:.1f} GFLOP a batch, bound "
          f"{out['dex_batch_bound_ms']:.3f} ms); peak "
          f"{out['peak_gib']:.2f} GiB ({out['over_resident_gib']:.2f} over "
          f"resident); the {PROTOCOL_SAMPLES}-sample protocol: "
          f"{out['protocol_card_s']:.0f} s of card time; pose / CelebA-HQ "
          f"scorer a batch of {EDIT_BATCH}: {others['pose']:.3f} / "
          f"{others['Smiling']:.3f} ms; scores mean {out['score_mean']:.3f} "
          f"std {out['score_std']:.3f}; launches {counts}; scorer loaded "
          f"in {load_s:.2f} s", flush=True)
    setup["scorer"] = scorer
    return out


def svm_phase(dev, root: pathlib.Path) -> dict:
    """9b: ``train_boundary`` at the protocol's size on the card: [6000,
    8192] seeded latents whose scores follow a direction plus noise,
    ``chosen_ratio=3000`` (2,100 + 2,100 training rows, 900 + 900
    validation rows); seconds on the card (host clock, synchronised),
    the solver's iterations and KKT gap; the same training rows solved
    on the CPU, and the cosine between the two normals (1 - cosine within
    SVM_COS_GAP).  The card's normal is saved to ``root`` for 9c."""
    import contextlib
    import io

    from transeditor_tpu_torch.edit import boundary

    rng = np.random.RandomState(0)
    latents = rng.randn(SVM_ROWS, SVM_DIM).astype(np.float32)
    scores = (latents @ rng.randn(SVM_DIM).astype(np.float32)
              / np.sqrt(SVM_DIM) + 0.5 * rng.randn(SVM_ROWS)).astype(
                  np.float32)
    fit = boundary.fit_linear_svc
    fits = []

    def recording(x, y, **kw):
        fits.append((x, y, fit(x, y, **kw)))
        return fits[-1][2]

    said = io.StringIO()
    boundary.fit_linear_svc = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            normal = boundary.train_boundary(latents, scores,
                                             chosen_ratio=SVM_CHOSEN,
                                             device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    finally:
        boundary.fit_linear_svc = fit
    x, y, card = fits[0]
    check(x.shape == (2 * int(SVM_CHOSEN * 0.7), SVM_DIM),
          f"9b training rows {x.shape}")
    t0 = time.perf_counter()
    cpu = fit(x, y, device="cpu")
    cpu_s = time.perf_counter() - t0
    a, b = card.coef.cpu(), cpu.coef
    cos = float(a @ b / (a.norm() * b.norm()))
    line = said.getvalue().strip()
    out = {"rows": list(x.shape), "card_s": card_s, "cpu_s": cpu_s,
           "iterations": card.iterations, "kkt_gap": card.kkt_gap,
           "cpu_iterations": cpu.iterations, "cpu_kkt_gap": cpu.kkt_gap,
           "cosine_card_cpu": cos, "intercepts": [card.intercept,
                                                  cpu.intercept],
           "accuracy_line": line}
    print(f"9b SVM at the protocol's size: train_boundary on [{SVM_ROWS}, "
          f"{SVM_DIM}], chosen {SVM_CHOSEN}: {card_s:.2f} s on the card "
          f"({card.iterations} iterations, KKT gap {card.kkt_gap:.3e}); "
          f"the same {x.shape[0]} training rows on the CPU {cpu_s:.2f} s "
          f"({cpu.iterations} iterations, gap {cpu.kkt_gap:.3e}); normals' "
          f"cosine card vs CPU 1 - {1 - cos:.3e} (limit {SVM_COS_GAP}); "
          f"'{line}'", flush=True)
    check(card.kkt_gap < 1e-6 and cpu.kkt_gap < 1e-6, "9b KKT gap")
    check(1 - cos <= SVM_COS_GAP, f"9b card vs CPU normals: 1 - {1 - cos}")
    check(normal.shape == (1, SVM_DIM) and bool(np.isfinite(normal).all()),
          "9b normal")
    np.save(root / "svm_normal.npy", normal)
    return out


def profile_scoring(dev, setup) -> dict:
    """9a's profile: one scored batch (sample, map, decode, score) under
    torch.profiler after a warm one; top kernels and busy share."""
    from torch.profiler import ProfilerActivity, profile

    from transeditor_tpu_torch.edit import sweep

    g, scorer = setup["g"], setup["scorer"]

    def batch():
        sweep.collect_scored_latents(g, scorer, n_samples=EDIT_BATCH,
                                     batch=EDIT_BATCH, seed=3)

    batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, blur_us, rows = kernel_table(prof, top=8)
    check(busy_us > 0, "the scoring profile shows no device time")
    print(f"profile of one scored batch (bf16 decode + f32 DEX age, batch "
          f"{EDIT_BATCH}): device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({busy_us / wall_us:.1%}); "
          f"fused_blur4 {blur_us / 1e3:.3f} ms", flush=True)
    for r in rows:
        print(f"  {r['ms']:9.3f} ms  x{r['calls']:<4d} {r['name']}",
              flush=True)
    return {"busy_ms": busy_us / 1e3, "wall_ms": wall_us / 1e3,
            "busy_share": busy_us / wall_us, "fused_blur4_ms": blur_us / 1e3,
            "top": rows}


def _plus_codes(g, n: int, seed: int):
    z, p = codes(n, g.cfg.style_dim, seed=seed)
    dev = next(g.parameters()).device
    with torch.no_grad():
        zp, pp = g.map_codes(z.to(dev), p.to(dev))
    return zp.float().cpu().numpy(), pp.float().cpu().numpy()


def _replayed(fb, decode, z_strip, p_strip):
    """The launches of one strip decode, each with its output and the
    plain version's on the same inputs."""
    blur, calls = fb._blur, []

    def recording(x, taps, pad, scale, bias, act, role):
        y = blur(x, taps, pad, scale, bias, act, role)
        calls.append((x, taps, pad, scale, bias, act, y))
        return y

    fb._blur = recording
    try:
        decode(z_strip, p_strip)
        torch.cuda.synchronize()
    finally:
        fb._blur = blur
    return [(x.shape, y, fb.fused_blur4_plain(x, taps, pad, scale, bias,
                                              act))
            for x, taps, pad, scale, bias, act, y in calls]


def strips_phase(fb, dev, card: str, setup, boundaries) -> dict:
    """9c (a main path, counted): ``edit_sample`` at 61 steps over the
    three spaces (pz+, p+, z+: 183 bf16 decodes, each strip one batch,
    scored by the DEX age net) for STRIP_SAMPLES samples after a warm
    one, ms per edited sample by the host clock; then each launch of one
    strip decode replayed through ``fused_blur4_plain`` on its own inputs:
    the bf16 strip within 2 bf16 ulps beyond 1e-5 (phase 2a's limit), the
    same strip decoded by a float32 generator of the same weights within
    1e-5 of the plain output's largest magnitude (as 7b and 8b)."""
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.edit import sweep
    from transeditor_tpu_torch.edit.boundary import linear_interpolate
    from transeditor_tpu_torch.models.generator import Generator

    g, scorer = setup["g"], setup["scorer"]
    ups = g.cfg.log_size - 2
    decode = sweep.make_strip_decoder(g, scorer)
    zp, pp = _plus_codes(g, STRIP_SAMPLES + 1, seed=5)
    sweep.edit_sample(decode, zp[0], pp[0], boundaries, 3.0, 7.0,
                      EDIT_STEPS)                              # warm
    torch.cuda.synchronize()
    fb.launches.reset()                       # the main path starts here
    t0 = time.perf_counter()
    for i in range(1, STRIP_SAMPLES + 1):
        strips = sweep.edit_sample(decode, zp[i], pp[i], boundaries, 3.0,
                                   7.0, EDIT_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / STRIP_SAMPLES * 1e3
    counts = fb.launches.by_role_path         # ... and ends here
    check(counts == {"forward": {"tma": 3 * ups * STRIP_SAMPLES}},
          f"9c launches {counts}")
    size = g.cfg.size
    for space, strip in strips.items():
        check(strip.images.shape == (EDIT_STEPS, size, size, 3),
              f"9c {space} {strip.images.shape}")
        check(bool(np.isfinite(strip.images).all()
                   and np.isfinite(strip.scores).all()), f"9c {space}")

    t, d = zp[0].shape
    z_strip = linear_interpolate(zp[0].reshape(1, -1), boundaries["z"],
                                 -3.0, 3.0, EDIT_STEPS).reshape(-1, t, d)
    p_strip = linear_interpolate(pp[0].reshape(1, -1), boundaries["p"],
                                 -7.0, 7.0, EDIT_STEPS).reshape(-1, t, d)
    errs = {}
    bf16 = _replayed(fb, sweep.make_strip_decoder(g), z_strip, p_strip)
    check(len(bf16) == ups, f"9c recorded {len(bf16)} bf16 launches")
    worst = 0.0
    for shape, y, want in bf16:
        w = want.float()
        err = (y.float() - w).abs()
        check(bool((err <= 2 * bf16_ulp(w) + 1e-5).all()),
              f"9c bf16 launch {tuple(shape)} beyond 2 ulps")
        worst = max(worst, err.max().item())
    errs["bf16_max_abs"] = worst
    del bf16
    g32 = Generator(ModelConfig(**setup["cfg_kw"]), device=dev).eval()
    g32.load_state_dict(g.state_dict())
    f32 = _replayed(fb, sweep.make_strip_decoder(g32), z_strip, p_strip)
    check(len(f32) == ups, f"9c recorded {len(f32)} f32 launches")
    rel = max(((y - w).abs().max() / w.abs().max()).item()
              for _, y, w in f32)
    errs["f32_rel"] = rel
    errs["f32_max_abs"] = max((y - w).abs().max().item() for _, y, w in f32)
    check(rel <= 1e-5, f"9c f32 launch: {rel} of the plain output's largest")
    del f32, g32
    torch.cuda.empty_cache()
    print(f"9c edit strips: {EDIT_STEPS} steps x 3 spaces, bf16 "
          f"{size}px + DEX age: {ms:.1f} ms per edited sample on {card}; "
          f"launches {counts}; one strip's {ups} launches replayed through "
          f"the plain version: bf16 largest error {errs['bf16_max_abs']:.3e} "
          f"(within 2 bf16 ulps), f32 {rel:.3e} of the plain output's "
          f"largest (limit 1e-5)", flush=True)
    return {"ms_per_sample": ms, "launches": counts, "replay": errs}


def scorers_card_vs_cpu(dev, setup) -> dict:
    """9d: the three classifiers (DEX age, pose, CelebA-HQ Smiling) from
    their checkpoints on the card and on the CPU, on the same four f32
    images decoded by the generator: scores within SCORE_REL of the
    largest magnitude."""
    from transeditor_tpu_torch.edit.classifiers import (
        load_scorer_from_checkpoint)

    g = setup["g"]
    z, p = codes(4, g.cfg.style_dim, seed=6)
    with torch.no_grad():
        img = g(z.to(dev), p.to(dev)).image.float().cpu()
    errs = {}
    for attr in ("age", "pose", "Smiling"):
        path = setup["ckpt"][attr]
        want = load_scorer_from_checkpoint(attr, path, "cpu")(img)
        got = load_scorer_from_checkpoint(attr, path, dev)(img).cpu()
        errs[attr] = ((got - want).abs().max()
                      / want.abs().max()).item()
        check(errs[attr] <= SCORE_REL, f"9d {attr}: {errs[attr]}")
    print(f"9d classifier scores card vs CPU on 4 f32 {g.cfg.size}px "
          f"images: largest error over the largest score {errs} (limit "
          f"{SCORE_REL})", flush=True)
    return errs


def edit_cli_phase(fb, dev, root: pathlib.Path, setup,
                   model_argv: list) -> dict:
    """9e (main paths, counted): ``cli.edit.main`` in this process at its
    defaults (age, random DEX drawn from a generator seeded 0, bf16, 61
    steps) but ``--num_sample 640 --n_edit_samples 2``: boundaries cached
    as .npy, the strips and origin grid; then the inversion variant
    (``--encoded_z/p``, saved random plus-space codes) from the cached
    boundaries; then ``cli.edit_eval.main`` on the sampled strips with
    the age and pose classifiers, ``--arcface`` and ``--boundaries``: the
    file trees and a finite JSON report.  Launches counted around each
    edit CLI."""
    from transeditor_tpu_torch.cli import edit as cli_edit
    from transeditor_tpu_torch.cli import edit_eval as cli_eval

    g = setup["g"]
    ups = g.cfg.log_size - 2
    ckpt = root / "g_edit.pt"
    torch.save({"g_ema": {k: v.cpu() for k, v in g.state_dict().items()}},
               ckpt)
    sampled, encoded = root / "edits", root / "edits_encoded"
    strip_dir = pathlib.Path("age") / "3.0_7.0_0"
    frames = EDIT_STEPS * N_CLI_EDITS

    def tree(out):
        return {str(pth.relative_to(out)) for pth in out.rglob("*")
                if pth.is_file()}

    def space_files(out):
        return {sp: len(list((out / strip_dir / sp).glob("*.png")))
                for sp in ("pz_plus", "p_plus", "z_plus")}

    runs = {}
    torch.cuda.synchronize()
    fb.launches.reset()                       # the main path starts here
    t0 = time.perf_counter()
    cli_edit.main(["--ckpt", str(ckpt), "--num_sample", str(N_CLI_SAMPLES),
                   "--n_edit_samples", str(N_CLI_EDITS), "--out_dir",
                   str(sampled), *model_argv])
    torch.cuda.synchronize()
    runs["sampled"] = {"s": time.perf_counter() - t0,
                       "launches": fb.launches.by_role_path}
    batches = -(-N_CLI_SAMPLES // CLI_EDIT_BATCH)
    want = ups * (batches + 1 + 3 * N_CLI_EDITS)
    check(runs["sampled"]["launches"] == {"forward": {"tma": want}},
          f"9e cli.edit launches {runs['sampled']['launches']}")
    names = tree(sampled)
    check({"boundary_age_z.npy", "boundary_age_p.npy",
           str(strip_dir / "origin_image" / "sample_gen.png")} <= names,
          f"9e cli.edit wrote {sorted(names)[:8]}")
    check(space_files(sampled) == {sp: frames + N_CLI_EDITS for sp in
                                   ("pz_plus", "p_plus", "z_plus")},
          f"9e strips {space_files(sampled)}")

    encoded.mkdir()
    for k in "zp":
        shutil.copy(sampled / f"boundary_age_{k}.npy", encoded)
    rng = np.random.RandomState(7)
    for k in "zp":
        np.save(root / f"encoded_{k}.npy", rng.randn(
            N_CLI_EDITS, 16, g.cfg.style_dim).astype(np.float32))
    torch.cuda.synchronize()
    fb.launches.reset()                       # the main path starts here
    t0 = time.perf_counter()
    cli_edit.main(["--ckpt", str(ckpt), "--encoded_z",
                   str(root / "encoded_z.npy"), "--encoded_p",
                   str(root / "encoded_p.npy"), "--n_edit_samples",
                   str(N_CLI_EDITS), "--out_dir", str(encoded), *model_argv])
    torch.cuda.synchronize()
    runs["encoded"] = {"s": time.perf_counter() - t0,
                       "launches": fb.launches.by_role_path}
    want = ups * 3 * N_CLI_EDITS
    check(runs["encoded"]["launches"] == {"forward": {"tma": want}},
          f"9e cli.edit --encoded launches {runs['encoded']['launches']}")
    check(space_files(encoded) == {sp: frames + N_CLI_EDITS for sp in
                                   ("pz_plus", "p_plus", "z_plus")},
          f"9e encoded strips {space_files(encoded)}")

    report_path = root / "report.json"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # the JSON, read below
        cli_eval.main(["--strips_dir", str(sampled / strip_dir),
                       "--edited_attr",
                       "age", "--classifier",
                       f"age={setup['ckpt']['age']}",
                       f"pose={setup['ckpt']['pose']}", "--arcface",
                       setup["ckpt"]["arcface"], "--boundaries",
                       str(sampled / "boundary_age_z.npy"),
                       str(sampled / "boundary_age_p.npy"), "--out",
                       str(report_path), "--device", dev.type])
    eval_s = time.perf_counter() - t0
    report = json.loads(report_path.read_text())
    check(set(report) == {"trajectories", "disentanglement",
                          "id_preservation", "boundary_cosine"},
          f"9e report keys {sorted(report)}")
    trajs = np.asarray([report["trajectories"][a][sp] for a in ("age", "pose")
                        for sp in ("pz_plus", "p_plus", "z_plus")])
    check(trajs.shape == (6, N_CLI_EDITS, EDIT_STEPS)
          and bool(np.isfinite(trajs).all()), f"9e trajectories {trajs.shape}")
    ids = list(report["id_preservation"].values())
    cos = list(report["boundary_cosine"].values())
    check(len(ids) == 3 and len(cos) == 1
          and bool(np.isfinite(ids + cos).all()), "9e id / cosine")
    print(f"9e cli.edit sampled ({N_CLI_SAMPLES} scored, {N_CLI_EDITS} "
          f"edited, {EDIT_STEPS} steps): {runs['sampled']['s']:.2f} s, "
          f"launches {runs['sampled']['launches']}; --encoded_z/p from the "
          f"cached boundaries: {runs['encoded']['s']:.2f} s, launches "
          f"{runs['encoded']['launches']}; cli.edit_eval (age, pose, "
          f"--arcface, --boundaries): {eval_s:.2f} s, ID similarity "
          f"{report['id_preservation']}, boundary cosine {cos[0]:.4f}, "
          f"disentanglement {report['disentanglement']}", flush=True)
    return {"runs": runs, "edit_eval_s": eval_s,
            "launches": {k: v["launches"] for k, v in runs.items()}}


# ---------------------------------------------------------------- phase 10

METRIC_BATCH = 64                  # cli.evaluate's default --batch
FID_SAMPLES = 3200                 # 10a: 50 batches
FID_PROTOCOL = 69_000              # the reference's FFHQ protocol
PRDC_N, PRDC_D = 50_000, 4096      # 10b: the protocol's k-NN size
PRDC_IMAGES = 512                  # 10b: evaluate_prdc, each side
PPL_SAMPLES = 640                  # 10c: 10 batches of 64 pairs
PPL_PROTOCOL = 10_000              # ... a space; three spaces
DIV_BATCHES = 2                    # 10d: 6 groups of 40
DIV_PROTOCOL = 1000                # ... rounds of three groups
N_METRIC_PNGS = 512                # the real folder of 10b / 10e
TO_RGB_GAIN = 1 / 32               # the metric generator's ToRGB weights
CLI_COUNTS = {"stats": 256, "fid": 256, "ppl": 128, "prdc": 128}   # 10e
FEAT_REL = 1e-4                    # Inception card vs CPU


def _he_(w: torch.Tensor, rng: torch.Generator) -> torch.Tensor:
    fan_in = w[0].numel()
    return torch.randn(w.shape, generator=rng) * (2.0 / fan_in) ** 0.5


def fid_inception_state_dict(seed: int) -> dict:
    """A random pytorch-fid InceptionV3 state dict (He-scaled convs, BN
    statistics near 1 / 0: features O(1)), shapes from the port's module
    on the meta device."""
    from transeditor_tpu_torch.metrics.inception import (InceptionV3Features,
                                                         conv_names)

    rng = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        net = InceptionV3Features(device="meta")
    sd = {}
    for name in conv_names(net):
        w = net.get_submodule(name).weight
        c = w.shape[0]
        sd[f"{name}.conv.weight"] = _he_(w, rng)
        sd[f"{name}.bn.weight"] = 1 + 0.1 * torch.randn(c, generator=rng)
        sd[f"{name}.bn.bias"] = 0.1 * torch.randn(c, generator=rng)
        sd[f"{name}.bn.running_mean"] = 0.1 * torch.randn(c, generator=rng)
        sd[f"{name}.bn.running_var"] = 0.5 + torch.rand(c, generator=rng)
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(3)
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    return sd


def he_state_dict(module: torch.nn.Module, seed: int) -> dict:
    """``module``'s state dict redrawn: He-scaled weights, N(0, 0.1)
    biases, |N(0, 1)| LPIPS heads."""
    rng = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if k.startswith("lin"):
            sd[k] = torch.randn(v.shape, generator=rng).abs()
        elif k.endswith("weight"):
            sd[k] = _he_(v, rng)
        else:
            sd[k] = 0.1 * torch.randn(v.shape, generator=rng)
    return sd


def metric_setup(dev, root: pathlib.Path, **cfg_kw) -> dict:
    """Phase 10's model and weight files: the bf16 generator of
    ``ModelConfig()`` (seeded random weights, the ToRGB weights scaled by
    TO_RGB_GAIN; ``cfg_kw`` narrows it for a CPU rehearsal) saved as a
    reference ``.pt``, and in ``root`` random
    reference-layout checkpoints drawn from seeded generators: a
    pytorch-fid InceptionV3, a torchvision VGG16, richzhang AlexNet and
    VGG LPIPS (heads included) and an IR-SE-50 ArcFace.  The networks are
    loaded back through the port's loaders."""
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.metrics.inception import load_fid_inception
    from transeditor_tpu_torch.models.generator import Generator
    from transeditor_tpu_torch.models.irse import (ArcFaceBackbone,
                                                   init_weights)
    from transeditor_tpu_torch.zoo.backbones import VGG16Fc7, load_vgg16_fc7
    from transeditor_tpu_torch.zoo.lpips import LPIPS, load_lpips

    root.mkdir(parents=True, exist_ok=True)
    files = {}

    def save(name, sd):
        files[name] = str(root / name)
        torch.save(sd, files[name])

    save("pt_inception.pth", fid_inception_state_dict(10))
    with torch.device("meta"):
        vgg_meta = VGG16Fc7()
    vgg_sd = he_state_dict(vgg_meta, 11)
    vgg_sd.update({"classifier.6.weight": torch.zeros(1000, 4096),
                   "classifier.6.bias": torch.zeros(1000)})
    save("vgg16.pth", vgg_sd)
    for seed, net in ((12, "alex"), (13, "vgg")):
        he = he_state_dict(LPIPS(net, device="cpu"), seed)
        sd = {f"features.{k[len('backbone.features.'):]}": v
              for k, v in he.items() if k.startswith("backbone.")}
        sd.update({f"lin{i}.model.1.weight": he[f"lin{i}"].reshape(
            1, -1, 1, 1) for i in range(5)})
        save(f"lpips_{net}.pth", sd)
    save("ir_se50.pth", init_weights(
        ArcFaceBackbone(), torch.Generator().manual_seed(14)).state_dict())
    g = Generator(ModelConfig(dtype="bfloat16", **cfg_kw), device=dev,
                  seed=0).eval()
    # the image is linear in the ToRGB weights (no demodulation): at 1/32
    # a decode lies within about [-1, 1], as a trained generator's does
    # (seeded, it spans [-31.75, 20]), so a PNG of a decode holds the
    # image the metrics see and 10b's real folder overlaps the fakes
    with torch.no_grad():
        for to_rgb in (g.to_rgb1, *g.to_rgbs):
            to_rgb.conv.weight.mul_(TO_RGB_GAIN)
    files["g"] = str(root / "g_metrics.pt")
    torch.save({"g_ema": {k: v.cpu() for k, v in g.state_dict().items()}},
               files["g"])
    nets = {
        "inception": load_fid_inception(files["pt_inception.pth"]).to(dev),
        "vgg16": load_vgg16_fc7(files["vgg16.pth"]).to(dev),
        "alex": load_lpips(files["lpips_alex.pth"], "alex", dev),
        "vgg": load_lpips(files["lpips_vgg.pth"], "vgg", dev),
    }
    return {"g": g, "cfg_kw": cfg_kw, "files": files, "nets": nets,
            "root": root}


class EventTimer:
    """Wraps a network: CUDA events around each call, kept in order, and
    with ``keep`` each call's output."""

    def __init__(self, net, keep: bool = False):
        self.net, self.spans, self.keep, self.outs = net, [], keep, []

    def __call__(self, x):
        s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s0.record()
        out = self.net(x)
        s1.record()
        self.spans.append((s0, s1))
        if self.keep:
            self.outs.append(out)
        return out


def fid_phase(fb, dev, card: str, setup) -> dict:
    """10a (a main path, counted): ``evaluate_fid`` of FID_SAMPLES samples
    at batch 64, the bf16 generator and the InceptionV3 loaded through
    ``load_fid_inception``, after one warm batch.  Host clock over the run
    (img/s without the host's Fréchet distance, timed apart: a 2,048-wide
    ``sqrtm``), CUDA events around each batch's Inception call (a batch's
    decode is the gap before it), peak memory, InceptionV3's flops on one
    batch (float32 bound at 67 TFLOP/s), the 69k protocol extrapolated."""
    from torch.utils.flop_counter import FlopCounterMode

    from transeditor_tpu_torch.metrics import evaluator

    g, inc = setup["g"], setup["nets"]["inception"]
    ups = g.cfg.log_size - 2
    z, p = (t.to(dev) for t in codes(METRIC_BATCH, g.cfg.style_dim, seed=20))
    with torch.no_grad():
        inc(g(z, p).image.float())                     # warm
    timer = EventTimer(inc)
    frechet, fre_s = evaluator.frechet_distance, []

    def timed_frechet(*a):
        t0 = time.perf_counter()
        out = frechet(*a)
        fre_s.append(time.perf_counter() - t0)
        return out

    rng = np.random.RandomState(21)
    real_mean = rng.randn(2048) * 0.1
    real_cov = np.cov(rng.randn(4096, 2048), rowvar=False)
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    evaluator.frechet_distance = timed_frechet
    fb.launches.reset()                       # the main path starts here
    try:
        t0 = time.perf_counter()
        start.record()
        fid = evaluator.evaluate_fid(g, timer, real_mean, real_cov,
                                     n_samples=FID_SAMPLES,
                                     batch=METRIC_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        evaluator.frechet_distance = frechet
    counts = fb.launches.by_role_path         # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    batches = -(-FID_SAMPLES // METRIC_BATCH)
    check(counts == {"forward": {"tma": ups * batches}},
          f"10a launches {counts}")
    check(bool(np.isfinite(fid)) and fid > 0, f"10a FID {fid}")
    sample_s = wall - fre_s[0]
    ends = [start] + [e for _, e in timer.spans[:-1]]
    decode_ms = [a.elapsed_time(s) for a, (s, _) in zip(ends, timer.spans)]
    inc_ms = [s.elapsed_time(e) for s, e in timer.spans]
    img_s = FID_SAMPLES / sample_s
    img = torch.rand((METRIC_BATCH, g.cfg.size, g.cfg.size, 3), device=dev,
                     generator=torch.Generator(dev).manual_seed(22)) * 2 - 1
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        inc(img)
    flops = counter.get_total_flops()
    out = {"samples": FID_SAMPLES, "batch": METRIC_BATCH, "fid": fid,
           "wall_s": wall, "frechet_s": fre_s[0], "img_per_s": img_s,
           "decode_ms_median": float(np.median(decode_ms)),
           "inception_ms_median": float(np.median(inc_ms)),
           "inception_batch_gflop": flops / 1e9,
           "inception_batch_bound_ms": flops / F32_FLOPS_PER_S * 1e3,
           "peak_gib": peak / 2 ** 30,
           "over_resident_gib": (peak - resident) / 2 ** 30,
           "protocol_card_s": FID_PROTOCOL / img_s, "launches": counts}
    out["inception_share_of_bound"] = (out["inception_batch_bound_ms"]
                                       / out["inception_ms_median"])
    print(f"10a FID: {FID_SAMPLES} samples, bf16 {g.cfg.size}px generator + "
          f"f32 InceptionV3 at batch {METRIC_BATCH}: {sample_s:.2f} s, "
          f"{img_s:.1f} img/s on {card}; a batch's decode "
          f"{out['decode_ms_median']:.3f} ms, Inception "
          f"{out['inception_ms_median']:.3f} ms (medians, events; "
          f"{flops / 1e9:.1f} GFLOP a batch, bound "
          f"{out['inception_batch_bound_ms']:.3f} ms, "
          f"{out['inception_share_of_bound']:.1%} of it); Fréchet distance "
          f"(2,048 wide, host) {fre_s[0]:.2f} s; peak "
          f"{out['peak_gib']:.2f} GiB ({out['over_resident_gib']:.2f} over "
          f"resident); the {FID_PROTOCOL}-sample protocol "
          f"{out['protocol_card_s']:.1f} s of card; FID {fid:.2f}; launches "
          f"{counts}", flush=True)
    return out


def prdc_knn_phase(dev) -> dict:
    """10b: ``compute_prdc`` at the protocol's size (50,000 x 4,096 seeded
    Gaussian features a side, made on the card) after a small warm call;
    seconds (host clock, the result is fetched) against the bound of its
    three distance passes (2 N^2 D flops each at 67 TFLOP/s), peak
    memory; and at 4,000 x 512 card vs CPU (the four values equal)."""
    from transeditor_tpu_torch.metrics.prdc import compute_prdc

    gen = torch.Generator(dev).manual_seed(30)
    small = [torch.randn((4000, 512), generator=gen, device=dev)
             for _ in range(2)]
    small[1] = small[1] * 1.1 + 0.05
    card = compute_prdc(*small, 3, device=dev)
    cpu = compute_prdc(*(t.cpu() for t in small), 3, device="cpu")
    check(card == cpu, f"10b PRDC card {card} vs CPU {cpu}")
    real = torch.randn((PRDC_N, PRDC_D), generator=gen, device=dev)
    fake = torch.randn((PRDC_N, PRDC_D), generator=gen, device=dev) * 1.05
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    vals = compute_prdc(real, fake, 3, device=dev)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del real, fake
    torch.cuda.empty_cache()
    flops = 3 * 2 * PRDC_N * PRDC_N * PRDC_D
    bound_s = flops / F32_FLOPS_PER_S
    check(all(0 <= v and np.isfinite(v) for v in vals.values()),
          f"10b PRDC {vals}")
    out = {"n": PRDC_N, "d": PRDC_D, "s": secs, "bound_s": bound_s,
           "share_of_bound": bound_s / secs, "peak_gib": peak / 2 ** 30,
           "over_resident_gib": (peak - resident) / 2 ** 30, "prdc": vals,
           "card_vs_cpu_4000x512": card}
    print(f"10b PRDC k-NN at {PRDC_N} x {PRDC_D} a side: {secs:.3f} s "
          f"(bound {bound_s:.3f} s, {bound_s / secs:.1%}); peak "
          f"{out['peak_gib']:.2f} GiB ({out['over_resident_gib']:.2f} over "
          f"resident); {vals}; card == CPU at 4,000 x 512: {card}",
          flush=True)
    return out


def write_pngs(folder: pathlib.Path, imgs: np.ndarray) -> None:
    from transeditor_tpu_torch.utils.image import save_png

    folder.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        list(ex.map(lambda i: save_png(str(folder / f"{i:05d}.png"),
                                       imgs[i]), range(len(imgs))))


def decoded_images(g, n: int, seed: int) -> np.ndarray:
    """uint8 decodes of ``g`` for ``n`` seeded codes, METRIC_BATCH at a
    time (outside any counted path)."""
    from transeditor_tpu_torch.utils.image import to_uint8

    dev = next(g.parameters()).device
    z, p = codes(n, g.cfg.style_dim, seed=seed)
    out = []
    with torch.no_grad():
        for s in range(0, n, METRIC_BATCH):
            img = g(z[s:s + METRIC_BATCH].to(dev),
                    p[s:s + METRIC_BATCH].to(dev)).image
            out.append(to_uint8(img.float().cpu().numpy()))
    return np.concatenate(out)


def prdc_images_phase(fb, dev, card: str, setup) -> dict:
    """10b (a main path, counted): ``evaluate_prdc`` of PRDC_IMAGES decodes
    against a PNG folder (``ImageFolderSource``) of PRDC_IMAGES decodes of
    the same generator for other seeded codes, so the two feature clouds
    overlap (unrelated images give four zeros whatever the features),
    with VGG16-fc7 at the native size, batch 64: the fake side (decode
    and VGG, events) and the real side (PNG reads on the host, VGG by
    events) as img/s each.  Precision and coverage must be above 0, and
    ``compute_prdc`` on the CPU over the same gathered features must give
    the card's four values."""
    from transeditor_tpu_torch.data.dataset import ImageFolderSource
    from transeditor_tpu_torch.metrics import evaluator
    from transeditor_tpu_torch.metrics.prdc import compute_prdc

    g = setup["g"]
    ups = g.cfg.log_size - 2
    folder = setup["root"] / "real"
    write_pngs(folder, decoded_images(g, N_METRIC_PNGS, seed=31))
    src = ImageFolderSource(str(folder))
    read_s = []
    get = src.get

    def timed_get(i, res):
        t0 = time.perf_counter()
        out = get(i, res)
        read_s.append(time.perf_counter() - t0)
        return out

    src.get = timed_get
    timer = EventTimer(setup["nets"]["vgg16"], keep=True)
    evaluator.evaluate_prdc(g, timer, src, n_samples=METRIC_BATCH,
                            batch=METRIC_BATCH, seed=1)         # warm
    timer.spans.clear()
    timer.outs.clear()
    read_s.clear()
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    fb.launches.reset()                       # the main path starts here
    t0 = time.perf_counter()
    start.record()
    vals = evaluator.evaluate_prdc(g, timer, src, n_samples=PRDC_IMAGES,
                                   batch=METRIC_BATCH)
    wall = time.perf_counter() - t0
    counts = fb.launches.by_role_path         # ... and ends here
    batches = PRDC_IMAGES // METRIC_BATCH
    check(counts == {"forward": {"tma": ups * batches}},
          f"10b evaluate_prdc launches {counts}")
    check(all(np.isfinite(v) for v in vals.values())
          and vals["precision"] > 0 and vals["coverage"] > 0, f"10b {vals}")
    # evaluate_prdc calls the VGG on a batch's decodes, then on its PNGs
    feats = [torch.cat(timer.outs[i::2]).cpu().numpy() for i in (1, 0)]
    cpu_vals = compute_prdc(*feats, 3, device="cpu")
    check(cpu_vals == vals, f"10b evaluate_prdc card {vals} vs CPU "
                            f"compute_prdc of its features {cpu_vals}")
    fake, real = timer.spans[0::2], timer.spans[1::2]
    ends = [start] + [e for _, e in real[:-1]]
    decode_ms = [a.elapsed_time(s) for a, (s, _) in zip(ends, fake)]
    vgg_fake = [s.elapsed_time(e) for s, e in fake]
    vgg_real = [s.elapsed_time(e) for s, e in real]
    out = {"images": PRDC_IMAGES, "wall_s": wall, "prdc": vals,
           "prdc_cpu_of_card_features": cpu_vals,
           "fake_img_per_s": PRDC_IMAGES / ((sum(decode_ms)
                                             + sum(vgg_fake)) / 1e3),
           "real_img_per_s": PRDC_IMAGES / (sum(read_s)
                                            + sum(vgg_real) / 1e3),
           "png_read_ms_per_image": sum(read_s) / len(read_s) * 1e3,
           "decode_ms_median": float(np.median(decode_ms)),
           "vgg_ms_median": float(np.median(vgg_fake + vgg_real)),
           "launches": counts}
    print(f"10b evaluate_prdc: {PRDC_IMAGES} + {PRDC_IMAGES} images at batch "
          f"{METRIC_BATCH}: {wall:.2f} s on {card}; fake side "
          f"{out['fake_img_per_s']:.1f} img/s (decode "
          f"{out['decode_ms_median']:.3f} ms + VGG16-fc7 a batch), real side "
          f"{out['real_img_per_s']:.1f} img/s (PNG reads "
          f"{out['png_read_ms_per_image']:.2f} ms an image on one host "
          f"thread); VGG16-fc7 {out['vgg_ms_median']:.3f} ms a batch "
          f"(median, events); {vals} (CPU on the same features: equal); "
          f"launches {counts}", flush=True)
    return out


def _ppl_draws(n_batches: int, batch: int, dim: int, seed: int):
    rng = torch.Generator().manual_seed(seed)
    return [(torch.randn((2 * batch, 16, dim), generator=rng),
             torch.randn((2 * batch, 16, dim), generator=rng),
             np.zeros((), np.float32)) for _ in range(n_batches)]


def ppl_phase(fb, dev, card: str, setup) -> dict:
    """10c (a main path, counted): ``compute_ppl`` for the space 'all' in
    plus space with the crop (the evaluator's protocol) over PPL_SAMPLES
    pairs at batch 64, the bf16 generator and the VGG LPIPS: ms per batch
    (host clock), the protocol's card time.  Then the same endpoints'
    distances from the bf16 generator and from a float32 generator of
    the same weights (ms per batch of each), their percentile means and
    how far apart they are; and 2 pairs at eps 1e-2 in float32, card vs
    CPU (1e-3 relative)."""
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.metrics import ppl
    from transeditor_tpu_torch.models.generator import Generator
    from transeditor_tpu_torch.zoo.lpips import LPIPS

    g, lpips = setup["g"], setup["nets"]["vgg"]
    ups = g.cfg.log_size - 2
    batches = PPL_SAMPLES // METRIC_BATCH
    draws = _ppl_draws(batches, METRIC_BATCH, g.cfg.style_dim, seed=40)
    ppl.compute_ppl(g, lpips, n_samples=METRIC_BATCH, batch=METRIC_BATCH,
                    crop=True, draws=draws[:1])                 # warm
    torch.cuda.synchronize()
    fb.launches.reset()                       # the main path starts here
    t0 = time.perf_counter()
    mean_bf16 = ppl.compute_ppl(g, lpips, space="all", eval_plus=True,
                                crop=True, n_samples=PPL_SAMPLES,
                                batch=METRIC_BATCH, draws=draws)
    wall = time.perf_counter() - t0
    counts = fb.launches.by_role_path         # ... and ends here
    check(counts == {"forward": {"tma": ups * batches}},
          f"10c launches {counts}")
    ms = wall / batches * 1e3

    g32 = Generator(ModelConfig(**setup["cfg_kw"]), device=dev).eval()
    g32.load_state_dict(g.state_dict())
    dists, ms_of = {}, {}
    for name, gen in (("bf16", g), ("f32", g32)):
        fn = ppl.make_ppl_batch_fn(gen, lpips, "all", True, True,
                                   batch=METRIC_BATCH)
        fn(None, draws[0])                                     # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dists[name] = np.concatenate([fn(None, d).cpu().numpy()
                                      for d in draws])
        ms_of[name] = (time.perf_counter() - t0) / batches * 1e3
    means = {k: ppl.percentile_filter_mean(v) for k, v in dists.items()}
    rel = abs(means["bf16"] - means["f32"]) / abs(means["f32"])
    check(all(np.isfinite(v).all() for v in dists.values()),
          "10c non-finite distances")
    check(abs(mean_bf16 - means["bf16"]) <= 1e-3 * abs(means["bf16"]),
          f"10c compute_ppl {mean_bf16} vs its batches {means['bf16']}")
    zero_share = float((dists["bf16"] == 0).mean())

    z, p, t = (a[:4] if a.ndim else a for a in draws[0])
    cpu_g = Generator(ModelConfig(**setup["cfg_kw"]), device="cpu").eval()
    cpu_g.load_state_dict({k: v.cpu() for k, v in g32.state_dict().items()})
    cpu_l = LPIPS("vgg", device="cpu")
    cpu_l.load_state_dict({k: v.cpu() for k, v in lpips.state_dict().items()})
    want = ppl.make_ppl_distance_fn(cpu_g, cpu_l.eval(), "all", True, True,
                                    eps=1e-2)(z, p, t)
    got = ppl.make_ppl_distance_fn(g32, lpips, "all", True, True,
                                   eps=1e-2)(z.to(dev), p.to(dev), t).cpu()
    cvc = ((got - want).abs() / want.abs()).max().item()
    check(cvc <= 1e-3, f"10c f32 card vs CPU distances: {cvc}")
    del g32, cpu_g
    torch.cuda.empty_cache()
    out = {"space": "all", "samples": PPL_SAMPLES, "batch": METRIC_BATCH,
           "ms_per_batch_bf16": ms, "ppl_bf16": mean_bf16,
           "protocol_card_s": 3 * PPL_PROTOCOL / METRIC_BATCH * ms / 1e3,
           "distance_ms_per_batch": ms_of, "percentile_means": means,
           "bf16_vs_f32_rel": rel, "bf16_zero_share": zero_share,
           "f32_card_vs_cpu_eps1e-2_rel": cvc, "launches": counts}
    print(f"10c PPL (all, plus space, crop, eps 1e-4): {PPL_SAMPLES} pairs at "
          f"batch {METRIC_BATCH}, bf16 generator + f32 VGG LPIPS: "
          f"{ms:.2f} ms a batch on {card}; the protocol (3 spaces x "
          f"{PPL_PROTOCOL}) {out['protocol_card_s']:.1f} s of card; the same "
          f"endpoints: bf16 {ms_of['bf16']:.2f} / f32 {ms_of['f32']:.2f} ms a "
          f"batch, percentile means bf16 {means['bf16']:.4g} / f32 "
          f"{means['f32']:.4g} ({rel:.1%} apart; bf16 distances exactly 0: "
          f"{zero_share:.1%}); f32 card vs CPU at eps 1e-2: {cvc:.3e} "
          f"(limit 1e-3); launches {counts}", flush=True)
    return out


def diversity_phase(fb, dev, card: str, setup) -> dict:
    """10d (a main path, counted): ``evaluate_lpips_diversity`` with
    n_batches=DIV_BATCHES (3 groups of 40 a round) and the AlexNet LPIPS,
    after a warm round: ms per group (host clock), the protocol's card
    time."""
    from transeditor_tpu_torch.metrics.evaluator import (
        evaluate_lpips_diversity)

    g, lpips = setup["g"], setup["nets"]["alex"]
    ups = g.cfg.log_size - 2
    evaluate_lpips_diversity(g, lpips, n_batches=1, seed=1)     # warm
    torch.cuda.synchronize()
    fb.launches.reset()                       # the main path starts here
    t0 = time.perf_counter()
    vals = evaluate_lpips_diversity(g, lpips, n_batches=DIV_BATCHES)
    wall = time.perf_counter() - t0
    counts = fb.launches.by_role_path         # ... and ends here
    groups = 3 * DIV_BATCHES
    check(counts == {"forward": {"tma": ups * groups}},
          f"10d launches {counts}")
    check(all(np.isfinite(v) and v > 0 for v in vals.values()),
          f"10d {vals}")
    ms = wall / groups * 1e3
    out = {"groups": groups, "ms_per_group": ms, "lpips": vals,
           "protocol_card_s": 3 * DIV_PROTOCOL * ms / 1e3,
           "launches": counts}
    print(f"10d LPIPS diversity: {groups} groups of 40 (780 pairs each), "
          f"bf16 generator + f32 AlexNet LPIPS: {ms:.1f} ms a group on "
          f"{card}; the protocol ({DIV_PROTOCOL} rounds of 3) "
          f"{out['protocol_card_s']:.1f} s of card; {vals}; launches "
          f"{counts}", flush=True)
    return out


def profile_fid(dev, setup) -> dict:
    """10a's profile: one FID batch (sample, decode, Inception) under
    torch.profiler after a warm one; top kernels and busy share."""
    from torch.profiler import ProfilerActivity, profile

    g, inc = setup["g"], setup["nets"]["inception"]
    z, p = (t.to(dev) for t in codes(METRIC_BATCH, g.cfg.style_dim, seed=23))

    def batch():
        with torch.no_grad():
            return inc(g(z, p).image.float()).cpu()

    batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, blur_us, rows = kernel_table(prof, top=8)
    check(busy_us > 0, "the FID profile shows no device time")
    print(f"profile of one FID batch (bf16 decode + f32 InceptionV3, batch "
          f"{METRIC_BATCH}): device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({busy_us / wall_us:.1%}); "
          f"fused_blur4 {blur_us / 1e3:.3f} ms", flush=True)
    for r in rows:
        print(f"  {r['ms']:9.3f} ms  x{r['calls']:<4d} {r['name']}",
              flush=True)
    return {"busy_ms": busy_us / 1e3, "wall_ms": wall_us / 1e3,
            "busy_share": busy_us / wall_us, "fused_blur4_ms": blur_us / 1e3,
            "top": rows}


def metrics_vs_plain(fb, dev, setup) -> dict:
    """10a's replays: one FID batch decode's launches each replayed
    through ``fused_blur4_plain`` on its own inputs (bf16 within 2 ulps
    beyond 1e-5; a float32 generator of the same weights within 1e-5 of
    the plain output's largest); and InceptionV3 features of 4 f32 images
    card vs CPU (FEAT_REL of the largest)."""
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.metrics.inception import load_fid_inception
    from transeditor_tpu_torch.models.generator import Generator

    g = setup["g"]
    ups = g.cfg.log_size - 2
    z, p = (t.to(dev) for t in codes(METRIC_BATCH, g.cfg.style_dim, seed=24))

    def decode_with(gen):
        def decode(zz, pp):
            with torch.no_grad():
                return gen(zz, pp).image
        return decode

    errs = {}
    bf16 = _replayed(fb, decode_with(g), z, p)
    check(len(bf16) == ups, f"10 recorded {len(bf16)} bf16 launches")
    worst = 0.0
    for shape, y, want in bf16:
        w = want.float()
        err = (y.float() - w).abs()
        check(bool((err <= 2 * bf16_ulp(w) + 1e-5).all()),
              f"10 bf16 launch {tuple(shape)} beyond 2 ulps")
        worst = max(worst, err.max().item())
    errs["bf16_max_abs"] = worst
    del bf16
    g32 = Generator(ModelConfig(**setup["cfg_kw"]), device=dev).eval()
    g32.load_state_dict(g.state_dict())
    f32 = _replayed(fb, decode_with(g32), z[:16], p[:16])
    check(len(f32) == ups, f"10 recorded {len(f32)} f32 launches")
    errs["f32_rel"] = max(((y - w).abs().max() / w.abs().max()).item()
                          for _, y, w in f32)
    errs["f32_max_abs"] = max((y - w).abs().max().item() for _, y, w in f32)
    check(errs["f32_rel"] <= 1e-5,
          f"10 f32 launch: {errs['f32_rel']} of the plain output's largest")
    with torch.no_grad():
        img = g32(z[:4], p[:4]).image.float()
    del f32, g32
    torch.cuda.empty_cache()
    cpu_inc = load_fid_inception(setup["files"]["pt_inception.pth"])
    with torch.no_grad():
        want = cpu_inc(img.cpu())
        got = setup["nets"]["inception"](img).cpu()
    errs["inception_card_vs_cpu_rel"] = ((got - want).abs().max()
                                         / want.abs().max()).item()
    check(errs["inception_card_vs_cpu_rel"] <= FEAT_REL,
          f"10 Inception card vs CPU {errs['inception_card_vs_cpu_rel']}")
    print(f"10 replays: one FID batch decode's {ups} launches through the "
          f"plain version: bf16 largest error {errs['bf16_max_abs']:.3e} "
          f"(within 2 bf16 ulps), f32 {errs['f32_rel']:.3e} of the plain "
          f"output's largest (limit 1e-5); InceptionV3 card vs CPU on 4 "
          f"f32 images {errs['inception_card_vs_cpu_rel']:.3e} of the "
          f"largest feature (limit {FEAT_REL})", flush=True)
    return errs


def _quiet(main, argv):
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        out = main(argv)
    return out, said.getvalue()


def metric_cli_phase(fb, dev, setup, model_argv: list) -> dict:
    """10e (main paths, counted): ``cli.calc_stats`` on the real folder
    (CLI_COUNTS images), ``cli.evaluate --fid --lpips --ppl --prdc`` at small
    counts from the saved generator and weight files (bf16, batch 64),
    ``cli.img_metrics`` in its three modes on 16 decoded results against
    16 PNGs, and ``cli.edit_eval --id_inception`` on two 5-frame strips:
    file trees, report text and finite values (PRDC's precision and
    coverage above 0: the real folder is 10b's decodes); launches counted
    around each CLI that decodes."""
    import pickle

    from transeditor_tpu_torch.cli import calc_stats, edit_eval, evaluate
    from transeditor_tpu_torch.cli import img_metrics
    from transeditor_tpu_torch.utils.image import to_uint8

    g, files, root = setup["g"], setup["files"], setup["root"]
    ups = g.cfg.log_size - 2
    dev_argv = ["--device", dev.type]
    runs = {}
    stats = root / "stats.pkl"
    t0 = time.perf_counter()
    n = CLI_COUNTS
    _quiet(calc_stats.main, ["--data_dir", str(root / "real"), "--out",
                             str(stats), "--size", str(g.cfg.size),
                             "--n_samples", str(n["stats"]), "--batch",
                             str(METRIC_BATCH), "--inception_weights",
                             files["pt_inception.pth"], *dev_argv])
    runs["calc_stats"] = {"s": time.perf_counter() - t0}
    with open(stats, "rb") as f:
        saved = pickle.load(f)
    check(set(saved) == {"mean", "cov", "n"} and saved["n"] == n["stats"]
          and saved["cov"].shape == (2048, 2048)
          and bool(np.isfinite(saved["cov"]).all()), "10e calc_stats pickle")

    argv = ["--ckpt", files["g"], "--batch", str(METRIC_BATCH),
            "--fid", "--fid_samples", str(n["fid"]),
            "--inception_stats", str(stats), "--inception_weights",
            files["pt_inception.pth"], "--lpips", "--lpips_batches", "1",
            "--lpips_weights", files["lpips_alex.pth"], "--ppl",
            "--ppl_samples", str(n["ppl"]), "--ppl_lpips_weights",
            files["lpips_vgg.pth"], "--prdc", "--prdc_samples",
            str(n["prdc"]), "--real_data", str(root / "real"),
            "--vgg16_weights", files["vgg16.pth"], *model_argv, *dev_argv]
    torch.cuda.synchronize()
    fb.launches.reset()                       # the main path starts here
    t0 = time.perf_counter()
    results, said = _quiet(evaluate.main, argv)
    torch.cuda.synchronize()
    runs["evaluate"] = {"s": time.perf_counter() - t0,
                        "launches": fb.launches.by_role_path}
    want = ups * (n["fid"] // METRIC_BATCH + 3 + 3 * n["ppl"] // METRIC_BATCH
                  + n["prdc"] // METRIC_BATCH)
    check(runs["evaluate"]["launches"] == {"forward": {"tma": want}},
          f"10e cli.evaluate launches {runs['evaluate']['launches']}")
    lines = [json.loads(x) for x in said.splitlines() if x.startswith("{")]
    check([list(d) for d in lines] == [["prdc"], ["ckpt", "fid", "lpips",
                                                  "ppl", "prdc"]],
          f"10e cli.evaluate lines {said[-400:]}")
    rep = lines[1]
    values = [rep["fid"], *rep["lpips"].values(), *rep["ppl"].values(),
              *rep["prdc"].values()]
    check(bool(np.isfinite(values).all()) and "WARNING" not in said
          and rep["prdc"]["precision"] > 0 and rep["prdc"]["coverage"] > 0,
          f"10e cli.evaluate report {rep}")
    runs["evaluate"]["report"] = rep

    res, gt = root / "pairs" / "results", root / "pairs" / "gt"
    zc, pc = (t.to(dev) for t in codes(16, g.cfg.style_dim, seed=50))
    with torch.no_grad():
        decoded = to_uint8(g(zc, pc).image.float().cpu().numpy())
    write_pngs(res, decoded)
    write_pngs(gt, smooth_images(16, g.cfg.size, seed=51))
    for mode, extra in (("l2", []),
                        ("lpips", ["--lpips_weights",
                                   files["lpips_alex.pth"]]),
                        ("id", ["--arcface", files["ir_se50.pth"],
                                "--arcface_depth", "50", "--arcface_mode",
                                "ir_se"])):
        t0 = time.perf_counter()
        _quiet(img_metrics.main, ["--mode", mode, "--data_path", str(res),
                                  "--gt_path", str(gt), *extra, *dev_argv])
        report = root / "pairs" / "inference_metrics"
        scores = json.loads((report / f"scores_{mode}.json").read_text())
        text = (report / f"stat_{mode}.txt").read_text()
        check(len(scores) == 16 and bool(np.isfinite(
            list(scores.values())).all()), f"10e img_metrics {mode}")
        check(text.startswith("New Average score is " if mode == "id"
                              else "Average loss is "), f"10e {text}")
        runs[f"img_metrics_{mode}"] = {"s": time.perf_counter() - t0,
                                       "stat": text}

    strips = root / "strips" / "z_plus"
    strips.mkdir(parents=True)
    with torch.no_grad():
        frames = to_uint8(g(zc[:10], pc[:10]).image.float().cpu().numpy())
    from transeditor_tpu_torch.utils.image import save_png
    for k, im in enumerate(frames):
        save_png(str(strips / f"origin_{k // 5}_edit_{k % 5}_age_0.png"), im)
    t0 = time.perf_counter()
    _quiet(edit_eval.main, ["--strips_dir", str(root / "strips"),
                            "--edited_attr", "age", "--id_inception",
                            files["pt_inception.pth"], "--out",
                            str(root / "id.json"), *dev_argv])
    report = json.loads((root / "id.json").read_text())
    ids = report.get("id_preservation_inception", {})
    check(list(ids) == ["z_plus"] and 0 < ids["z_plus"] <= 1 + 1e-6,
          f"10e edit_eval --id_inception {report}")
    runs["edit_eval_id_inception"] = {"s": time.perf_counter() - t0,
                                      "report": ids}
    print(f"10e CLIs: calc_stats ({n['stats']} images) "
          f"{runs['calc_stats']['s']:.2f} "
          f"s; evaluate --fid {n['fid']} --lpips 1 round --ppl {n['ppl']} "
          f"--prdc {n['prdc']} {runs['evaluate']['s']:.2f} s, launches "
          f"{runs['evaluate']['launches']}, {rep}; img_metrics "
          + ", ".join(f"{m} {runs[f'img_metrics_{m}']['s']:.2f} s "
                      f"'{runs[f'img_metrics_{m}']['stat']}'"
                      for m in ("l2", "lpips", "id"))
          + f"; edit_eval --id_inception "
          f"{runs['edit_eval_id_inception']['s']:.2f} s {ids}", flush=True)
    return {"runs": runs,
            "launches": {"evaluate": runs["evaluate"]["launches"]}}


# ---------------------------------------------------------------- phase 11

INT8_OPS_PER_S = 1.979e15          # H100 SXM int8 dense tensor cores
# the 13 quantised convs of a 256px forward, in order: (H, I, O, transposed)
INT8_SHAPES = [(4, 512, 512, False), (4, 512, 512, True),
               (8, 512, 512, False), (8, 512, 512, True),
               (16, 512, 512, False), (16, 512, 512, True),
               (32, 512, 512, False), (32, 512, 512, True),
               (64, 512, 512, False), (64, 512, 256, True),
               (128, 256, 256, False), (128, 256, 128, True),
               (256, 128, 128, False)]
# odd cases: (x shape, O, k, mode, the path the plan must choose): on the
# general path C = 20 and 6 (O not a multiple of 8), the stride-2 pad-0
# downsample, a 1x1 kernel; on the wgmma path batch 1 with H odd, Ip 32
# from 20 channels (a K step mostly TMA's zero fill), a ragged M and N
# (O = 40), a transposed conv on 20 channels, split-K shapes
INT8_ODD = [((2, 5, 7, 20), 6, 3, dict(stride=1, padding=1), "general"),
            ((1, 9, 9, 6), 20, 3, dict(stride=2, padding=0), "general"),
            ((2, 5, 6, 6), 20, 3, dict(stride=2, transpose=True), "general"),
            ((1, 7, 7, 512), 512, 3, dict(stride=2, transpose=True),
             "wgmma"),
            ((1, 11, 9, 64), 32, 1, dict(stride=1, padding=0), "general"),
            ((2, 17, 15, 20), 6, 3, dict(stride=2, padding=0), "general"),
            ((1, 5, 7, 20), 16, 3, dict(stride=1, padding=1), "wgmma"),
            ((3, 11, 13, 64), 40, 3, dict(stride=1, padding=1), "wgmma"),
            ((1, 7, 9, 20), 24, 3, dict(stride=2, transpose=True), "wgmma"),
            ((64, 4, 4, 512), 512, 3, dict(stride=1, padding=1), "wgmma")]
INT8_CARD_CPU_DB = 35.0            # 11c: f32 int8 image, card vs CPU


def _int8_mode(transpose: bool) -> dict:
    return (dict(stride=2, padding=0, transpose=True) if transpose
            else dict(stride=1, padding=1, transpose=False))


def int8_macs(b, h, w, i, o, k, stride=1, padding=0, transpose=False):
    """Multiply-adds whose input lies inside the image: per axis the
    (output, tap) pairs that read a real pixel (a transposed conv: every
    input pixel against every tap)."""
    from transeditor_tpu_torch.ops.quant import out_size

    def valid(n):
        if transpose:
            return n * k
        return sum(1 for y in range(out_size(n, k, stride, padding, False))
                   for j in range(k) if 0 <= y * stride - padding + j < n)
    return b * i * o * valid(h) * valid(w)


def _rand_int8(g, shape, dev):
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)


def _plan_of(quant, xq, wq, mode, dtype=torch.bfloat16):
    """The plan ``conv2d_int8`` takes for these operands."""
    return quant.prepare(xq, wq, out_dtype=dtype,
                         **{"padding": 0, "transpose": False, **mode})[0]


def int8_vs_plain(quant, dev) -> dict:
    """11a: ``conv2d_int8`` against ``conv2d_int8_plain`` on the card at
    the 13 main-path shapes at batch 2 and the odd cases, int32, float32
    and bfloat16 out, bit-equal, each on the path its plan names."""
    g = torch.Generator(dev).manual_seed(0)
    cases = [((2, h, h, i), o, 3, _int8_mode(t), "wgmma")
             for h, i, o, t in INT8_SHAPES]
    cases += INT8_ODD
    quant.launches.reset()
    n = 0
    for shape, o, k, mode, path in cases:
        xq = _rand_int8(g, shape, dev)
        wq = _rand_int8(g, (o, shape[3], k, k), dev)
        sx = torch.rand(shape[0], generator=g, device=dev) * 1e-2
        sw = torch.rand(o, generator=g, device=dev) * 1e-2
        plan = _plan_of(quant, xq, wq, mode)
        check(plan.path == path, f"conv2d_int8 {shape} -> {o} k{k} {mode}: "
                                 f"planned {plan.path}, not {path}")
        acc = quant.conv2d_int8_plain(xq, wq, **mode)
        for dtype in (torch.int32, torch.float32, torch.bfloat16):
            before = quant.launches.by_path.get(path, 0)
            got = quant.conv2d_int8(xq, wq, sx=sx, sw=sw, out_dtype=dtype,
                                    **mode)
            n += 1
            check(quant.launches.by_path.get(path, 0) == before + 1,
                  f"conv2d_int8 {shape} {mode}: not launched on {path}")
            want = acc if dtype == torch.int32 else \
                quant.dequantize_plain(acc, sx, sw, dtype)
            check(got.dtype == want.dtype and torch.equal(got, want),
                  f"conv2d_int8 {shape} -> {o} k{k} {mode} {dtype} on the "
                  f"{path} path: not bit-equal to plain")
        if (shape, o, k, mode, path) in INT8_ODD:
            split = f", split {plan.split}" if path == "wgmma" else ""
            print(f"  conv2d_int8 {list(shape)} -> {o} k{k} {mode}: {path} "
                  f"path{split}, bit-equal at int32 / f32 / bf16 out",
                  flush=True)
    torch.cuda.synchronize()
    check(quant.launches.value == n, f"int8 launches {quant.launches.by_path}"
                                     f", not {n}")
    print(f"conv2d_int8 vs plain: {len(cases)} cases (13 main-path shapes "
          f"at batch 2, {len(INT8_ODD)} odd) x int32 / f32 / bf16 out: "
          f"bit-equal (torch.equal); launches by path "
          f"{quant.launches.by_path}, by mode {quant.launches.by_role}",
          flush=True)
    return {"cases": len(cases), "launches": n, "bit_equal": True,
            "launches_by_path": quant.launches.by_path}


def _int_mm_ms(b, h, i, o, mode, dev) -> float:
    """``torch._int_mm`` of the conv's int8 GEMM sizes, M = output pixels
    of a phase, K = its taps x I, N = O (per phase, summed): a yardstick
    of another function, with no gather and no epilogue, that the port
    never calls."""
    from transeditor_tpu_torch.ops.quant import out_size, phases
    ho = out_size(h, 3, mode["stride"], mode.get("padding", 0),
                  mode["transpose"])
    total = 0.0
    for f in phases(ho, ho, 3, 3, mode["transpose"]):
        m, k = b * f.Hq * f.Wq, f.taps * i
        a = torch.ones((m, k), dtype=torch.int8, device=dev)
        bt = torch.ones((o, k), dtype=torch.int8, device=dev).t()
        total += device_ms(lambda: torch._int_mm(a, bt))
        del a, bt
    return total


def int8_host_us(quant, xq, wq, sx, sw, mode, reps: int = 50) -> float:
    """Host time per ``conv2d_int8`` call (packing, plan lookup, tensor
    maps, launch): a host clock over ``reps`` enqueues, then a
    synchronize."""
    def call():
        quant.conv2d_int8(xq, wq, sx=sx, sw=sw, out_dtype=torch.bfloat16,
                          **mode)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def int8_kernel_times(quant, dev) -> list:
    """11b: per main-path shape at TIME_BATCH, bf16 out: the wgmma
    kernel's and the earlier kernel's (the general path's) device time
    (CUDA graph replay of launches on packed operands), both bit-equal to
    plain at this batch too; the plain float64 version; as yardsticks of
    other functions, cuDNN's bf16 conv of the same shape and
    ``torch._int_mm`` of the same-sized GEMM; the wrapper's host time per
    call; beside the bound."""
    g = torch.Generator(dev).manual_seed(1)
    rows = []
    for h, i, o, t in INT8_SHAPES:
        b, mode = TIME_BATCH, _int8_mode(t)
        xq = _rand_int8(g, (b, h, h, i), dev)
        wq = _rand_int8(g, (o, i, 3, 3), dev)
        sx = torch.rand(b, generator=g, device=dev) * 1e-2
        sw = torch.rand(o, generator=g, device=dev) * 1e-2
        want = quant.dequantize_plain(quant.conv2d_int8_plain(xq, wq, **mode),
                                      sx, sw, torch.bfloat16)
        dev_ms, plans = {}, {}
        for path, general in (("wgmma", False), ("general", True)):
            plan, x, w = quant.prepare(xq, wq, out_dtype=torch.bfloat16,
                                       general=general, **mode)
            check(plan.path == path, f"conv2d_int8 b{b} {h}x{h} {i}->{o} "
                                     f"{mode}: planned {plan.path}")
            got = quant.launch(plan, x, w, sx, sw)
            check(torch.equal(got, want), f"conv2d_int8 b{b} {h}x{h} "
                                          f"{i}->{o} {mode} on the {path} "
                                          f"path: not bit-equal to plain")
            del got
            dev_ms[path] = device_ms(
                lambda: quant.launch(plan, x, w, sx, sw))
            plans[path] = plan
        del want
        ms = dev_ms["wgmma"]
        host = int8_host_us(quant, xq, wq, sx, sw, mode)
        plain = time_ms(lambda: quant.conv2d_int8_plain(xq, wq, **mode),
                        reps=2, warm=1)
        int_mm = _int_mm_ms(b, h, i, o, mode, dev)
        xb = torch.randn((b, i, h, h), generator=g, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        if t:
            wb = torch.randn((i, o, 3, 3), generator=g, device=dev).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            conv = device_ms(lambda: F.conv_transpose2d(xb, wb, stride=2))
        else:
            wb = torch.randn((o, i, 3, 3), generator=g, device=dev).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            conv = device_ms(lambda: F.conv2d(xb, wb, padding=1))
        macs = int8_macs(b, h, h, i, o, 3, **mode)
        ho = quant.out_size(h, 3, **mode)
        nbytes = b * h * h * i + o * 9 * i + b * ho * ho * o * 2 + 4 * (b + o)
        t_ops, t_bytes = 2 * macs / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        rows_t = {"ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3}
        p = plans["wgmma"]
        rows.append({"in": [b, h, h, i], "out_ch": o, "transposed": t,
                     "ms": ms, "earlier_kernel_ms": dev_ms["general"],
                     "plain_ms": plain, "cudnn_bf16_ms": conv,
                     "int_mm_ms": int_mm, "host_us": host,
                     "bound_ms": bound, "share_of_bound": bound / ms,
                     "earlier_share_of_bound": bound / dev_ms["general"],
                     "gmac": macs / 1e9, "tops": 2 * macs / ms / 1e9,
                     "earlier_tops": 2 * macs / dev_ms["general"] / 1e9,
                     "bytes": nbytes, **rows_t,
                     "plan": {"tile": [p.tile_m, p.tile_n],
                              "boxes": p.boxes, "split": p.split,
                              "items": p.n_items, "grid": p.grid,
                              "stages": p.stages},
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes"})
        print(f"  conv2d_int8 bf16-out {'transposed' if t else 'stride 1'} "
              f"{[b, h, h, i]} -> {o}: wgmma {ms:.4f} ms "
              f"({2 * macs / ms / 1e9:.1f} TOP/s, {bound / ms:.1%} of the "
              f"bound; tile {p.tile_m}x{p.tile_n}, boxes {p.boxes}, split "
              f"{p.split}, {p.n_items} items on {p.grid} blocks, "
              f"{p.stages} stages), earlier kernel {dev_ms['general']:.4f} "
              f"ms ({2 * macs / dev_ms['general'] / 1e9:.1f} TOP/s), both "
              f"bit-equal (device, graph replay); host {host:.1f} us a "
              f"call; plain f64 {plain:.2f} ms; yardsticks of other "
              f"functions: cuDNN bf16 {conv:.4f} ms, torch._int_mm "
              f"{int_mm:.4f} ms; bound {bound:.4f} ms ({macs / 1e9:.2f} "
              f"GMAC at 1,979 TOP/s, {nbytes / 1e6:.1f} MB)", flush=True)
        del xq, wq, xb, wb
        torch.cuda.empty_cache()
    s = {k: sum(r[k] for r in rows) for k in (
        "ms", "earlier_kernel_ms", "plain_ms", "cudnn_bf16_ms", "int_mm_ms",
        "bound_ms")}
    print(f"conv2d_int8 at batch {TIME_BATCH}, 13 shapes summed: wgmma "
          f"kernel {s['ms']:.3f} ms ({s['bound_ms'] / s['ms']:.1%} of the "
          f"{s['bound_ms']:.3f} ms bound), earlier kernel "
          f"{s['earlier_kernel_ms']:.3f} ms "
          f"({s['bound_ms'] / s['earlier_kernel_ms']:.1%}), "
          f"{s['ms'] / s['earlier_kernel_ms']:.1%} of its time; plain f64 "
          f"{s['plain_ms']:.1f} ms; yardsticks cuDNN bf16 "
          f"{s['cudnn_bf16_ms']:.3f} ms, torch._int_mm "
          f"{s['int_mm_ms']:.3f} ms", flush=True)
    check(all(r["ms"] < r["earlier_kernel_ms"] for r in rows),
          "the wgmma kernel is slower than the earlier kernel at "
          + str([r["in"] for r in rows
                 if r["ms"] >= r["earlier_kernel_ms"]]))
    return rows


def _psnr_pm1(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = (a.double() - b.double()).pow(2).mean().item()
    return float("inf") if mse == 0 else 10 * np.log10(4.0 / mse)


def int8_generator_phase(fb, quant, dev, card: str, **cfg_kw) -> dict:
    """11c (the int8 main path, counted): the full-width 256px
    ``ModelConfig(dtype="bfloat16", quantize="int8")`` with seeded random
    weights, ToRGB weights at TO_RGB_GAIN; ``cfg_kw`` narrows it for a
    CPU rehearsal."""
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.models.generator import Generator
    from transeditor_tpu_torch.serve import InferenceEngine

    cfg8 = ModelConfig(dtype="bfloat16", quantize="int8", **cfg_kw)
    ups, dim = cfg8.log_size - 2, cfg8.style_dim
    n_conv = 1 + 2 * ups
    g8 = Generator(cfg8, device=dev, seed=0).eval()
    with torch.no_grad():
        for to_rgb in (g8.to_rgb1, *g8.to_rgbs):
            to_rgb.conv.weight.mul_(TO_RGB_GAIN)
    sd = g8.state_dict()

    def twin(**kw):
        m = Generator(ModelConfig(**cfg_kw, **kw), device=dev, seed=1)
        m.load_state_dict(sd, strict=True)
        return m.eval()
    g16, g32 = twin(dtype="bfloat16"), twin()

    z, p = (t.to(dev) for t in codes(8, dim))
    with torch.inference_mode():
        g8(z, p)
        torch.cuda.synchronize()
        quant.launches.reset()
        fb.launches.reset()               # the main path starts here
        img8 = g8(z, p).image
        torch.cuda.synchronize()
        fwd = {"conv2d_int8": quant.launches.by_role,
               "conv2d_int8_paths": quant.launches.by_path,
               "fused_blur4": fb.launches.by_path}   # ... and ends here
        img16, img32 = g16(z, p).image, g32(z, p).image
    check(fwd["conv2d_int8"] == {"stride1": 1 + ups, "transposed": ups},
          f"int8 forward launched conv2d_int8 {fwd['conv2d_int8']}, not "
          f"{n_conv}")
    check(fwd["conv2d_int8_paths"] == {"wgmma": n_conv},
          f"int8 forward's conv2d_int8 paths {fwd['conv2d_int8_paths']}, "
          f"not {n_conv} on the wgmma path")
    check(fwd["fused_blur4"] == {"tma": ups},
          f"int8 forward launched fused_blur4 {fwd['fused_blur4']}")
    check(img8.dtype == torch.bfloat16 and bool(
        torch.isfinite(img8.float()).all()), "int8 image not finite bf16")
    psnr16 = _psnr_pm1(img8.float(), img16.float())
    psnr32 = _psnr_pm1(img8.float(), img32)
    print(f"int8 generator bf16 batch 8: image {tuple(img8.shape)} finite; "
          f"launches per forward conv2d_int8 {fwd['conv2d_int8']} (by "
          f"path {fwd['conv2d_int8_paths']}), "
          f"fused_blur4 {fwd['fused_blur4']}; PSNR vs unquantised bf16 "
          f"{psnr16:.2f} dB, vs f32 {psnr32:.2f} dB", flush=True)

    # f32 int8, card vs CPU on the same weights and codes
    z2, p2 = codes(2, dim, seed=1)
    cfg8_32 = ModelConfig(quantize="int8", **cfg_kw)
    out = {}
    for d in (dev, torch.device("cpu")):
        m = Generator(cfg8_32, device=d, seed=1)
        m.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            out[d.type] = m(z2.to(d), p2.to(d)).image.float().cpu()
        del m
    diff = (out[dev.type] - out["cpu"]).abs()
    card_cpu = _psnr_pm1(out[dev.type], out["cpu"])
    check(card_cpu >= INT8_CARD_CPU_DB, f"f32 int8 card vs CPU "
                                        f"{card_cpu:.2f} dB")
    print(f"int8 generator f32 batch 2, card vs CPU: PSNR {card_cpu:.2f} dB "
          f"(limit {INT8_CARD_CPU_DB} dB: the mapping and attention "
          f"matmuls differ in their last bits, and an activation within that "
          f"of a rounding boundary quantises to the next int8 step), max "
          f"abs {diff.max().item():.3e}, mean {diff.mean().item():.3e}, "
          f"{(diff > 1e-3).float().mean().item():.2%} of values beyond "
          f"1e-3", flush=True)

    rates = {"int8": {}, "bf16": {}}
    with torch.inference_mode():
        for b in (1, 8, 64):
            zb, pb = (t.to(dev) for t in codes(b, dim, seed=2))
            for name, m in (("bf16", g16), ("int8", g8)):
                ms = time_ms(lambda: m(zb, pb), reps=10 if b < 64 else 5,
                             warm=2)
                rates[name][b] = b / (ms / 1e3)
            print(f"int8 vs bf16 {cfg8.size}px batch {b}: int8 "
                  f"{rates['int8'][b]:.1f} img/s, bf16 "
                  f"{rates['bf16'][b]:.1f} img/s on {card}", flush=True)
    del g16, g32
    torch.cuda.empty_cache()

    eng = InferenceEngine(cfg8, sd, seed=0, device=dev)
    eng.warmup(4)
    rng = np.random.RandomState(3)
    zs = rng.randn(2, 16, dim).astype(np.float32)
    ps = rng.randn(2, 16, dim).astype(np.float32)
    torch.cuda.synchronize()
    quant.launches.reset()
    fb.launches.reset()                   # the main path starts here
    s1, _, _ = eng.sample(1)
    s3, _, _ = eng.sample(3)
    dec = eng.decode(zs, ps)
    torch.cuda.synchronize()
    served = {"conv2d_int8": quant.launches.by_role,
              "conv2d_int8_paths": quant.launches.by_path,
              "fused_blur4": fb.launches.by_path}    # ... and ends here
    for name, a, n in (("sample(1)", s1, 1), ("sample(3)", s3, 3),
                       ("decode", dec, 2)):
        check(a.dtype == np.uint8 and a.shape == (n, cfg8.size, cfg8.size, 3),
              f"int8 engine {name}: {a.dtype} {a.shape}")
    n8 = sum(served["conv2d_int8"].values())
    check(n8 > 0 and n8 % n_conv == 0, f"int8 engine conv2d_int8 {served}")
    check(served["conv2d_int8_paths"] == {"wgmma": n8},
          f"int8 engine conv2d_int8 paths {served}")
    check(list(served["fused_blur4"]) == ["tma"]
          and served["fused_blur4"]["tma"] == n8 // n_conv * ups,
          f"int8 engine fused_blur4 {served}")
    print(f"int8 engine: sample(1) {s1.shape}, sample(3) {s3.shape}, decode "
          f"{dec.shape}; launches conv2d_int8 {served['conv2d_int8']} (by "
          f"path {served['conv2d_int8_paths']}), "
          f"fused_blur4 {served['fused_blur4']}", flush=True)
    return {"launches_per_forward": fwd, "served_launches": served,
            "psnr_vs_bf16": psnr16, "psnr_vs_f32": psnr32,
            "card_vs_cpu_psnr": card_cpu,
            "card_vs_cpu_max_abs": diff.max().item(), "img_per_s": rates}


def profile_int8_forward(dev, batch: int = TIME_BATCH, top: int = 8,
                         **cfg_kw) -> dict:
    """11d: device time by kernel for one int8 bf16 forward
    (torch.profiler): busy ms, ``conv2d_int8`` and ``fused_blur4`` ms, and
    what is left, the activation quantisation's elementwise passes among
    it.  It runs after the host-clock phases."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.models.generator import Generator

    g8 = Generator(ModelConfig(dtype="bfloat16", quantize="int8", **cfg_kw),
                   device=dev, seed=0).eval()
    zb, pb = (t.to(dev) for t in codes(batch, g8.cfg.style_dim, seed=4))
    with torch.inference_mode():
        g8(zb, pb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            g8(zb, pb)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, blur_us, rows = kernel_table(prof, top)
    conv_us = sum(_dev_us(e) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and "conv2d_int8" in e.key)
    print(f"profile int8 bf16 batch {batch}: device busy "
          f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
          f"({busy_us / wall_us:.1%}); conv2d_int8 {conv_us / 1e3:.3f} ms, "
          f"fused_blur4 {blur_us / 1e3:.3f} ms, the rest "
          f"{(busy_us - conv_us - blur_us) / 1e3:.3f} ms", flush=True)
    for r in rows:
        print(f"  {r['ms']:9.3f} ms  x{r['calls']:<4d} {r['name']}",
              flush=True)
    del g8
    torch.cuda.empty_cache()
    return {"batch": batch, "busy_ms": busy_us / 1e3,
            "wall_ms": wall_us / 1e3, "conv2d_int8_ms": conv_us / 1e3,
            "fused_blur4_ms": blur_us / 1e3, "top": rows}


# ---------------------------------------------------------------- phase 12

N_ALIGN_IMAGES = 8                  # 12: cli.align, 1024px sources


def synthetic_faces(n: int, size: int, seed: int = 0):
    """``n`` smooth seeded images and 68-point landmarks of a face (eyes,
    mouth corners) jittered about the image's middle."""
    rng = np.random.RandomState(seed)
    imgs = smooth_images(n, size, seed)
    lms = []
    for _ in range(n):
        c = size / 2 + rng.uniform(-0.05, 0.05, 2) * size
        eye, mouth = 0.12 * size, 0.2 * size
        lm = np.zeros((68, 2))
        lm[36:42] = c + [-eye, -0.05 * size] + rng.randn(2)
        lm[42:48] = c + [eye, -0.05 * size] + rng.randn(2)
        lm[48] = c + [-0.6 * eye, mouth] + rng.randn(2)
        lm[54] = c + [0.6 * eye, mouth] + rng.randn(2)
        lms.append(lm)
    return imgs, lms


def _tree(root: pathlib.Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def remaining_cli_phase(fb, dev, root: pathlib.Path, model_argv: list,
                        **cfg_kw) -> dict:
    """12: ``cli.export_pt`` (a reference ``.pt`` round trip; a one-step
    ``train()`` state), ``cli.visualize`` (a main path, counted),
    ``run_similarity``, ``cli.align`` and ``utils.profiling.trace``, in
    ``root``.  ``cfg_kw`` / ``model_argv`` narrow the model for a CPU
    rehearsal."""
    from transeditor_tpu_torch.cli import align as align_cli
    from transeditor_tpu_torch.cli import export_pt, visualize
    from transeditor_tpu_torch.config import ModelConfig, TrainConfig
    from transeditor_tpu_torch.models.discriminator import Discriminator
    from transeditor_tpu_torch.models.generator import Generator
    from transeditor_tpu_torch.train.gan import init_state
    from transeditor_tpu_torch.train.loop import train
    from transeditor_tpu_torch.utils import profiling
    from transeditor_tpu_torch.utils.image import save_png

    root.mkdir(parents=True, exist_ok=True)
    out = {}
    cfg = ModelConfig(**cfg_kw)
    g = Generator(cfg, device=dev, seed=0).eval()
    with torch.no_grad():
        for to_rgb in (g.to_rgb1, *g.to_rgbs):
            to_rgb.conv.weight.mul_(TO_RGB_GAIN)
    d = Discriminator(cfg, device=dev, seed=1)
    ref = {"g": {k: v.cpu() for k, v in g.state_dict().items()},
           "d": {k: v.cpu() for k, v in d.state_dict().items()}}
    ref["g_ema"] = ref["g"]
    torch.save(ref, root / "ref.pt")
    del d

    def equal(bundle, want):
        return list(bundle) == list(want) and all(
            set(bundle[k]) == set(want[k]) and all(
                torch.equal(bundle[k][n], t.cpu())
                for n, t in want[k].items()) for k in want)

    t0 = time.time()
    _quiet(export_pt.main, ["--ckpt", str(root / "ref.pt"), "--out",
                            str(root / "round_trip.pt")] + model_argv)
    rt = torch.load(root / "round_trip.pt", map_location="cpu",
                    weights_only=True)
    check(equal(rt, {k: ref[k] for k in ("g", "d", "g_ema")}),
          "export_pt --ckpt round trip differs from its source")
    out["export_ckpt_s"] = time.time() - t0

    tcfg = TrainConfig(batch_size=4, sample_every=1000, checkpoint_every=1)
    state = init_state(cfg, tcfg, seed=2, device=dev)
    state = train(cfg, tcfg, iter(synthetic_batches(1, 4, cfg.size)),
                  out_dir=str(root), exp_name="train", state=state,
                  device=dev, max_steps=1)
    t0 = time.time()
    _quiet(export_pt.main, ["--state_dir", str(root / "train" / "checkpoint"),
                            "--out", str(root / "state.pt")])
    exported = torch.load(root / "state.pt", map_location="cpu",
                          weights_only=True)
    check(equal(exported, {"g": state.g.state_dict(),
                           "d": state.d.state_dict(),
                           "g_ema": state.g_ema.state_dict()}),
          "export_pt --state_dir differs from the train() state")
    out["export_state_s"] = time.time() - t0
    del state
    torch.cuda.empty_cache()
    print(f"cli.export_pt: --ckpt round trip {out['export_ckpt_s']:.2f} s, "
          f"tensors equal; --state_dir of a one-step train() state "
          f"{out['export_state_s']:.2f} s, equal to the state", flush=True)

    vis_dir = root / "visual"
    argv = ["--ckpt", str(root / "ref.pt"), "--out", str(vis_dir),
            "--sample", "--swap_z", "--swap_p", "--interp", "--dat_interp",
            "--n_sample", "4", "--loop_num", "2", "--interp_num", "1"]
    torch.cuda.synchronize()
    fb.launches.reset()                     # the main path starts here
    t0 = time.time()
    _quiet(visualize.main, argv + model_argv + ["--device", dev.type])
    torch.cuda.synchronize()
    out["visualize_s"] = time.time() - t0
    counts = fb.launches.by_role_path      # ... and ends here
    want = ["0.png", "1.png", "swap_p.png", "swap_z.png"]
    want += [f"interp_many/{s}/interp_{s}_0.png"
             for s in ("z", "z+", "w", "p", "p+")]
    want += [f"interp_dat/{s}/interp_{s}_0.png" for s in ("z", "z+", "p", "p+")]
    check(_tree(vis_dir) == sorted(want), f"visualize tree {_tree(vis_dir)}")
    from transeditor_tpu_torch.utils.image import load_png
    for name in want:
        img = load_png(str(vis_dir / name))
        check(img.std() > 0, f"visualize {name} is one colour")
    n = sum(counts.get("forward", {}).values())
    check(list(counts) == ["forward"] and list(counts["forward"]) == ["tma"]
          and n > 0 and n % (cfg.log_size - 2) == 0,
          f"visualize fused_blur4 launches {counts}")
    out["visualize_launches"] = counts
    print(f"cli.visualize --sample --swap_z --swap_p --interp --dat_interp: "
          f"{len(want)} grids in {out['visualize_s']:.2f} s; fused_blur4 "
          f"launches {counts}", flush=True)

    g16 = Generator(ModelConfig(dtype="bfloat16", **cfg_kw), device=dev,
                    seed=3)
    g16.load_state_dict(g.state_dict(), strict=True)
    visualize.run_similarity(visualize.Sampler(g16), str(root / "sim"))
    sims = _tree(root / "sim")
    check(len(sims) > 0 and all(load_png(str(root / "sim" / s)).shape
                                == (256, 256, 3) for s in sims),
          f"similarity heatmaps {sims}")
    print(f"run_similarity: {len(sims)} heatmaps (blocks x heads) of 256 x "
          f"256", flush=True)

    raw, aligned = root / "raw", root / "aligned"
    raw.mkdir()
    imgs, lms = synthetic_faces(N_ALIGN_IMAGES, 1024, seed=5)
    names = [f"{i:02d}.png" for i in range(N_ALIGN_IMAGES)]
    for name, img in zip(names, imgs):
        save_png(str(raw / name), img)
    np.savez(root / "lm.npz", **dict(zip(names, lms)))
    t0 = time.time()
    _quiet(align_cli.main, ["--root_path", str(raw), "--out_path",
                            str(aligned), "--landmarks", str(root / "lm.npz"),
                            "--output_size", str(cfg.size)])
    out["align_s"] = time.time() - t0
    check(_tree(aligned) == names, f"align tree {_tree(aligned)}")
    for name in names:
        a = load_png(str(aligned / name))
        check(a.shape == (cfg.size, cfg.size, 3) and a.std() > 0,
              f"aligned {name}: {a.shape}")
    print(f"cli.align --landmarks: {N_ALIGN_IMAGES} images of 1024px -> "
          f"{cfg.size}px in {out['align_s']:.2f} s "
          f"({out['align_s'] / N_ALIGN_IMAGES * 1e3:.0f} ms an image, host)",
          flush=True)

    z, p = (t.to(dev) for t in codes(2, cfg.style_dim, seed=6))
    with profiling.trace(str(root / "trace")):
        with torch.inference_mode():
            g16(z, p)
            torch.cuda.synchronize()
    trace = root / "trace" / profiling.TRACE_FILE
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(trace.stat().st_size > 0 and (dev.type != "cuda" or any(
        "fused_blur4" in e.get("name", "") for e in kernels)),
        f"trace {trace}: {len(events)} events, {len(kernels)} kernels")
    out["trace_bytes"] = trace.stat().st_size
    out["trace_kernels"] = len(kernels)
    print(f"utils.profiling.trace: one forward, {trace.stat().st_size} bytes, "
          f"{len(events)} events, {len(kernels)} kernel events", flush=True)
    return out


# ---------------------------------------------------------------- phase 13

MESH_STEPS = 2                     # 13a: R1 + path steps, sharded and not
MESH_FID_SAMPLES = 128             # 13c: two batches of 64
N_BMP_IMAGES = 16                  # 13e: the BMP folder
MESH_SLICES = (2, 4)               # 13b: C / n_model at every stage


@contextlib.contextmanager
def world_one_group(dev):
    """A process group of one (NCCL on the card, gloo on the CPU) joined
    through ``multihost.initialize()``, left on exit, the environment
    restored."""
    from transeditor_tpu_torch.parallel import multihost

    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    try:
        os.environ.update(env)
        check(multihost.initialize(dev), "multihost.initialize() joined "
                                         "no process group")
        yield
    finally:
        multihost.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _predicted_bytes(state, n_data: int, n_model: int, fsdp: bool) -> float:
    """Bytes one rank would hold of params, g_ema and Adam moments on an
    (n_data, n_model) mesh, by ``param_partition_spec`` from the full
    shapes (moments follow their parameters; g_ema is g's layout)."""
    from transeditor_tpu_torch.parallel.mesh import Mesh, param_partition_spec

    mesh = Mesh(n_data, n_model)
    total = 0.0
    for module, copies in ((state.g, 4), (state.d, 3)):
        for name, p in module.named_parameters():
            spec = param_partition_spec(name, p, mesh, fsdp=fsdp)
            n = ((n_model if "model" in spec else 1)
                 * (n_data if "data" in spec else 1))
            total += copies * p.numel() * 4 / n
    return total


def mesh_fsdp_phase(fb, dev, **cfg_kw) -> dict:
    """13a (a main path, counted): ``MESH_STEPS`` full-width R1 + path
    steps (f32, batch 16) with ``fsdp`` on a world-1 group whose mesh
    forces its data axis's collectives and sharding rule on
    (``create_mesh(force=True)``: every eligible tensor is cut into a
    block of the whole, and each phase's all-gathers, reduce-scatters
    and all-reduces run), against the same steps without a mesh, from the
    same state and draws.  At lr 0 with cuDNN deterministic (see
    ``data_parallel_phase``): parameters, g_ema and both Adam moments
    within 1e-5 of each tensor's largest (1e-8 / 1e-16 for gradients
    that are 0 in exact arithmetic), metrics within 1e-5.  Reports ms a
    step both ways, the bytes held at rest, and the bytes one rank would
    hold on 4 cards at (4, 1) with fsdp and at (2, 2)."""
    from transeditor_tpu_torch.config import ModelConfig, TrainConfig
    from transeditor_tpu_torch.io.checkpoint import full_state_dicts
    from transeditor_tpu_torch.parallel.mesh import create_mesh, local_bytes
    from transeditor_tpu_torch.train import gan

    cfg = ModelConfig(**cfg_kw)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, lr=0.0)
    g = torch.Generator().manual_seed(21)
    pb = TRAIN_BATCH // tcfg.path_batch_shrink

    def zp(b):
        return [torch.randn((b, cfg.n_tokens, cfg.style_dim), generator=g)
                for _ in "zp"]

    draws = [{"d": zp(TRAIN_BATCH), "g": zp(TRAIN_BATCH),
              "path": [*zp(pb), torch.randn((pb, cfg.size, cfg.size, 3),
                                            generator=g) / cfg.size]}
             for _ in range(MESH_STEPS)]
    reals = [torch.from_numpy(b) for b in
             synthetic_batches(MESH_STEPS, TRAIN_BATCH, cfg.size, seed=22)]

    def steps(mesh=None):
        state = gan.init_state(cfg, tcfg, seed=0, device=dev)
        full = local_bytes([p for m in (state.g, state.d, state.g_ema)
                            for p in m.parameters()])
        if mesh is not None:
            gan.shard_state(state, mesh, fsdp=True)
        step = gan.make_train_step(cfg, tcfg, device=dev, mesh=mesh,
                                   fsdp=mesh is not None)
        ms = []
        for k in range(MESH_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, reals[k], torch.Generator(dev)
                            .manual_seed(k), do_d_reg=True, do_g_reg=True,
                            draws=draws[k])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return state, m, ms, full

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        ref, m_ref, ref_ms, full_params = steps()
        with world_one_group(dev):
            mesh = create_mesh(force=True)
            torch.cuda.synchronize()
            fb.launches.reset()                  # the main path starts here
            run, m_run, run_ms, _ = steps(mesh)
            torch.cuda.synchronize()
            launches = fb.launches.by_role_path  # ... and ends here
            moments = [v for opt in (run.opt_g, run.opt_d)
                       for st in opt.state.values() for k, v in st.items()
                       if k != "step"]
            held = local_bytes([p for m in (run.g, run.d, run.g_ema)
                                for p in m.parameters()] + moments)
            sharded = sum(len(lay.sharded) for lay in
                          (run.sharding.g, run.sharding.d))
            got = full_state_dicts(run)          # gathered: a collective
    finally:
        torch.backends.cudnn.deterministic = False
    worst = (0.0, "every tensor")
    for tag, module, opt in (("g", ref.g, ref.opt_g), ("d", ref.d, ref.opt_d)):
        names = [n for n, _ in module.named_parameters()]
        pairs = []
        for i, (name, p) in enumerate(module.named_parameters()):
            pairs.append((f"{tag} {name}", got[tag][name], p, 0.0))
            for key, floor in (("exp_avg", 1e-8), ("exp_avg_sq", 1e-16)):
                pairs.append((f"{tag} {name} {key}",
                              got[f"{tag}_optim"]["state"][i][key],
                              opt.state[p][key], floor))
        if tag == "g":
            pairs += [(f"g_ema {n}", got["g_ema"][n], p, 0.0) for n, p in
                      zip(names, ref.g_ema.parameters())]
        for what, a, b, floor in pairs:
            err = (a - b).abs().max().item()
            tol = 1e-5 * b.abs().max().item() + floor
            check(err <= tol, f"13a {what}: {err} > {tol}")
            rel = err / max(b.abs().max().item(), 1e-30)
            if err > floor and rel > worst[0]:
                worst = (rel, what)
    for k in m_ref:
        check(abs(float(m_run[k]) - float(m_ref[k]))
              <= 1e-5 * abs(float(m_ref[k])) + 1e-7, f"13a metric {k}")
    n_launch = sum(n for by in launches.values() for n in by.values())
    check(n_launch > 0 and set(launches.get("forward", {})) == {"tma"},
          f"13a launches {launches}")
    out = {"ms_per_step": run_ms, "unsharded_ms_per_step": ref_ms,
           "worst_rel": worst[0], "worst_at": worst[1],
           "launches": launches, "sharded_tensors": sharded,
           "bytes_at_rest_world1": held,
           "param_bytes_unsharded": full_params,
           "state_bytes_unsharded": _predicted_bytes(ref, 1, 1, False),
           "bytes_per_rank_4x1_fsdp": _predicted_bytes(ref, 4, 1, True),
           "bytes_per_rank_2x2_fsdp": _predicted_bytes(ref, 2, 2, True),
           "bytes_per_rank_2x2": _predicted_bytes(ref, 2, 2, False)}
    print(f"13a fsdp (world 1, the data axis's collectives and sharding "
          f"forced on): "
          f"{MESH_STEPS} R1 + path steps equal the unsharded steps: worst "
          f"{worst[0]:.2e} of the tensor's largest ({worst[1]}); "
          f"{sharded} tensors of g and d sharded; ms a step "
          f"{[round(t, 1) for t in run_ms]} vs unsharded "
          f"{[round(t, 1) for t in ref_ms]}; state {out['state_bytes_unsharded'] / 2**30:.3f} GiB unsharded, "
          f"{out['bytes_per_rank_4x1_fsdp'] / 2**30:.3f} GiB a rank at "
          f"(4, 1) fsdp, {out['bytes_per_rank_2x2_fsdp'] / 2**30:.3f} at "
          f"(2, 2) fsdp, {out['bytes_per_rank_2x2'] / 2**30:.3f} at (2, 2) "
          f"(by the rule); launches {launches}", flush=True)
    return out


def slice_blur_phase(fb, dev) -> dict:
    """13b: ``fused_blur4`` forward (scale, bias, activation) and adjoint
    (the backward's ``grad_x`` launch) at f32 batch 16 on the channel
    slices a model axis of 2 and 4 ranks would give each stage (C / 2,
    C / 4), each on the path ``plan_tiles`` plans (TMA for all), held to
    the plain version; device ms by CUDA graph replay, the plain
    version's, and the bytes bound."""
    rows = []
    g = torch.Generator(dev).manual_seed(23)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for h, c in MAIN_SHAPES:
        for n in MESH_SLICES:
            cs = c // n
            x = torch.randn((TRAIN_BATCH, h, h, cs), generator=g, device=dev)
            scale = torch.rand((TRAIN_BATCH, cs), generator=g,
                               device=dev) + 0.5
            bias = torch.randn((cs,), generator=g, device=dev)
            gy = torch.randn((TRAIN_BATCH, h - 1, h - 1, cs), generator=g,
                             device=dev)
            fwd = (x, TAPS, (1, 1), scale, bias, True)
            adj = (gy, TAPS[::-1], (2, 2), scale, None, False)
            row = {"shape": [TRAIN_BATCH, h, h, cs], "n_model": n}
            for role, args in (("forward", fwd), ("adjoint", adj)):
                b_, hh, ww, cc = args[0].shape
                plan = fb.plan_tiles(b_, hh, ww, cc, torch.float32, args[2],
                                     args[0].data_ptr() % 16 == 0, sm)
                check(plan.path == "tma", f"13b {role} {row['shape']}: "
                                          f"planned {plan.path}")
                err, _ = hold_to_plain(fb.fused_blur4(*args),
                                       fb.fused_blur4_plain(*args),
                                       f"13b {role} {row['shape']}")
                ho = hh + sum(args[2]) - 3
                epi = b_ * cc * 4 + (cc * 4 if args[4] is not None else 0)
                nbytes = args[0].numel() * 4 + b_ * ho * ho * cc * 4 + epi
                flops = b_ * ho * ho * cc * 20   # 8 FMAs + the epilogue
                row[role] = {
                    "path": plan.path, "max_abs_err": err,
                    "ms": device_ms(lambda a=args: fb.fused_blur4(*a)),
                    # the plain version builds its taps on the host: no
                    # graph capture, events around the calls
                    "plain_ms": time_ms(
                        lambda a=args: fb.fused_blur4_plain(*a), reps=5),
                    "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                    flops / F32_FLOPS_PER_S) * 1e3,
                    "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                 >= flops / F32_FLOPS_PER_S
                                 else "operations")}
            rows.append(row)
    for role in ("forward", "adjoint"):
        for n in MESH_SLICES:
            sel = [r[role] for r in rows if r["n_model"] == n]
            print(f"13b {role} on C/{n} slices, f32 b{TRAIN_BATCH}, six "
                  f"stages: {sum(r['ms'] for r in sel):.4f} ms (bound "
                  f"{sum(r['bound_ms'] for r in sel):.4f}, plain "
                  f"{sum(r['plain_ms'] for r in sel):.4f}), max abs err "
                  f"{max(r['max_abs_err'] for r in sel):.2e}, all TMA",
                  flush=True)
    return {"rows": rows}


def mesh_fid_phase(dev, **cfg_kw) -> dict:
    """13c: ``evaluate_fid`` with ``mesh=`` (a world-1 group, the data
    axis forced on: each batch's rows decoded and their features
    all-gathered) against no mesh: the statistics handed to the Fréchet
    distance (recorded; the distance itself is the host's ``sqrtm``)
    equal.  The bf16 full-width generator (ToRGB at 1/32, as phase 10)
    and a seeded random pytorch-fid InceptionV3."""
    from transeditor_tpu_torch.config import ModelConfig
    from transeditor_tpu_torch.metrics import evaluator
    from transeditor_tpu_torch.metrics.inception import load_fid_inception
    from transeditor_tpu_torch.models.generator import Generator
    from transeditor_tpu_torch.parallel.mesh import create_mesh

    g = Generator(ModelConfig(dtype="bfloat16", **cfg_kw), device=dev,
                  seed=0).eval()
    with torch.no_grad():
        for to_rgb in (g.to_rgb1, *g.to_rgbs):
            to_rgb.conv.weight.mul_(TO_RGB_GAIN)
    inc = load_fid_inception(fid_inception_state_dict(10)).to(dev)
    seen = []
    frechet = evaluator.frechet_distance

    def record(mean, cov, *_):
        seen.append((mean, cov))
        return 0.0

    evaluator.frechet_distance = record
    times = []
    try:
        for mesh_on in (False, True):
            with (world_one_group(dev) if mesh_on
                  else contextlib.nullcontext()):
                mesh = create_mesh(force=True) if mesh_on else None
                t = time.perf_counter()
                evaluator.evaluate_fid(g, inc, None, None,
                                       n_samples=MESH_FID_SAMPLES,
                                       batch=METRIC_BATCH, mesh=mesh)
                times.append(time.perf_counter() - t)
    finally:
        evaluator.frechet_distance = frechet
    (m0, c0), (m1, c1) = seen
    err = max(float(np.abs(m1 - m0).max() / np.abs(m0).max()),
              float(np.abs(c1 - c0).max() / np.abs(c0).max()))
    check(err <= 1e-5, f"13c evaluate_fid(mesh=) statistics differ: {err}")
    print(f"13c evaluate_fid(mesh=) of {MESH_FID_SAMPLES} samples equals "
          f"no mesh: statistics within {err:.2e} of the largest; "
          f"{times[0]:.2f} s without, {times[1]:.2f} s with", flush=True)
    return {"stats_rel": err, "s": times}


def save_phase(dev, root: pathlib.Path, **cfg_kw) -> dict:
    """13d: the full-width train state (f32 g, d, g_ema and both Adam
    moments after one plain step) saved synchronously, and
    asynchronously with a train step run while the write is in flight:
    seconds of each save, the seconds the caller is blocked by the async
    one (the host copy), the write's seconds after it, and the two files
    equal tensor for tensor."""
    from transeditor_tpu_torch.config import ModelConfig, TrainConfig
    from transeditor_tpu_torch.io.checkpoint import (save_train_state,
                                                     wait_for_saves)
    from transeditor_tpu_torch.train import gan

    cfg = ModelConfig(**cfg_kw)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    state = gan.init_state(cfg, tcfg, seed=0, device=dev)
    step = gan.make_train_step(cfg, tcfg, device=dev)
    real = torch.from_numpy(synthetic_batches(1, TRAIN_BATCH, cfg.size,
                                              seed=24)[0])
    state, _ = step(state, real, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    t = time.perf_counter()
    sync = save_train_state(str(root / "sync"), 1, state)
    sync_s = time.perf_counter() - t
    t = time.perf_counter()
    path = save_train_state(str(root / "async"), 1, state, async_save=True)
    blocked_s = time.perf_counter() - t
    state, _ = step(state, real, torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t - blocked_s
    t = time.perf_counter()
    wait_for_saves()
    waited_s = time.perf_counter() - t
    a = torch.load(sync, weights_only=True)
    b = torch.load(path, weights_only=True)

    def same(x, y):
        if torch.is_tensor(x):
            return torch.equal(x, y)
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y

    check(same(a, b), "13d the async file differs from the sync one")
    size = os.path.getsize(sync)
    print(f"13d full-width train state ({size / 2**30:.3f} GiB): sync save "
          f"{sync_s:.2f} s; async blocks the loop {blocked_s:.2f} s, a "
          f"train step ran meanwhile ({step_s:.2f} s), then {waited_s:.2f} "
          f"s of write remained; files equal", flush=True)
    return {"bytes": size, "sync_s": sync_s, "async_blocked_s": blocked_s,
            "step_during_write_s": step_s, "wait_after_s": waited_s}


def _bmp_bytes(img: np.ndarray) -> bytes:
    """A 24-bit BI_RGB BMP of [H, W, 3] uint8 RGB, rows bottom-up."""
    h, w, _ = img.shape
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    pixels = rows.tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pixels),
                       2835, 2835, 0, 0)
    return (b"BM" + struct.pack("<IHHI", 54 + len(pixels), 0, 0, 54)
            + info + pixels)


def bmp_phase(root: pathlib.Path, size: int = 256) -> dict:
    """13e: a folder of ``N_BMP_IMAGES`` 24-bit BMPs at 300px (resized)
    read through ``ImageFolderSource`` and the training iterator, equal
    to the same images read from PNGs; the iterator's img/s;
    ``cli.prepare_data`` on the BMP folder too."""
    from transeditor_tpu_torch.data.dataset import (ImageFolderSource,
                                                    make_train_iterator)
    from transeditor_tpu_torch.utils.image import save_png

    imgs = smooth_images(N_BMP_IMAGES, 300, seed=25)
    for kind in ("bmp", "png"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(imgs):
        (root / "bmp" / f"{i:03d}.bmp").write_bytes(_bmp_bytes(img))
        save_png(str(root / "png" / f"{i:03d}.png"), img)
    bmp, png = (ImageFolderSource(str(root / k)) for k in ("bmp", "png"))
    for i in range(N_BMP_IMAGES):
        check(np.array_equal(bmp.get(i, size), png.get(i, size)),
              f"13e BMP {i} differs from its PNG")
    batch = 8
    it = make_train_iterator(bmp, batch, size, seed=0, normalize=False)
    try:
        next(it)
        t = time.perf_counter()
        for _ in range(N_BMP_IMAGES // batch):
            got = next(it)
        rate = N_BMP_IMAGES / (time.perf_counter() - t)
    finally:
        it.close()
    check(got.shape == (batch, size, size, 3), f"13e batch {got.shape}")
    from transeditor_tpu_torch.cli import prepare_data
    n, _ = _quiet(prepare_data.main, ["--in_dir", str(root / "bmp"),
                                      "--out", str(root / "lmdb"),
                                      "--size", str(size)])
    check(n == N_BMP_IMAGES, f"13e prepare_data wrote {n}")
    out = {"images": N_BMP_IMAGES, "iterator_img_s": rate,
           "prepare_data": n}
    said = f"cli.prepare_data wrote {n} records"
    print(f"13e {N_BMP_IMAGES} BMPs (300px -> {size}) equal their PNGs "
          f"through ImageFolderSource; the iterator reads {rate:.1f} "
          f"img/s; {said}", flush=True)
    return out


def sliced_conv_phase(dev) -> dict:
    """13f: the 3x3 conv of the 128px stage at the path-length batch (4
    rows, f32, TF32 off), whole ([256, 256, 3, 3]) and as one rank's half
    on a 2-rank model axis ([128, 256, 3, 3]): cuDNN's forward ms by
    events and the peak memory of the call; the half is also timed with
    cuDNN off (PyTorch's own conv)."""
    from transeditor_tpu_torch.ops.precision import conv_precision

    conv_precision(torch.float32)
    g = torch.Generator(dev).manual_seed(26)
    x = torch.randn((4, 128, 128, 256), generator=g,
                    device=dev).permute(0, 3, 1, 2)
    out = {}
    for name, o, cudnn in (("whole", 256, True), ("half", 128, True),
                           ("half_no_cudnn", 128, False)):
        w = torch.randn((o, 256, 3, 3), generator=g, device=dev).contiguous(
            memory_format=torch.channels_last)

        def conv(w=w, cudnn=cudnn):
            with torch.backends.cudnn.flags(enabled=cudnn):
                return F.conv2d(x, w, padding=1)

        conv()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(conv, reps=3, warm=1)
        out[name] = {"ms": ms,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"13f the 128px stage's 3x3 conv at 4 rows, f32: whole (256 "
          f"out) {out['whole']['ms']:.3f} ms, peak "
          f"{out['whole']['peak_gib']:.2f} GiB; one model rank's half (128 "
          f"out) {out['half']['ms']:.3f} ms, peak "
          f"{out['half']['peak_gib']:.2f} GiB; the half without cuDNN "
          f"{out['half_no_cudnn']['ms']:.3f} ms", flush=True)
    return out


def mesh_phase(fb, dev, root: pathlib.Path) -> dict:
    """Phase 13: the (data, model) mesh, async saves and BMP input."""
    out = {"fsdp": mesh_fsdp_phase(fb, dev),
           "slices": slice_blur_phase(fb, dev),
           "sliced_conv": sliced_conv_phase(dev)}
    torch.cuda.empty_cache()
    out["fid"] = mesh_fid_phase(dev)
    torch.cuda.empty_cache()
    out["save"] = save_phase(dev, root / "save")
    torch.cuda.empty_cache()
    out["bmp"] = bmp_phase(root / "bmp")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from transeditor_tpu_torch.ops import cuda_build
    from transeditor_tpu_torch.ops import fused_blur as fb
    from transeditor_tpu_torch.ops import quant

    dev = torch.device("cuda")
    started = time.time()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    def timed_build(name):
        t0 = time.time()
        cuda_build.compile_library(name)
        return time.time() - t0

    t0 = time.time()
    libraries = ["fused_blur4", *quant.LIBRARIES]
    with ThreadPoolExecutor(len(libraries)) as ex:    # one nvcc each
        built = {name: ex.submit(timed_build, name) for name in libraries}
        built = {name: f.result() for name, f in built.items()}
    fb.build()
    quant.build()
    for name, s in built.items():
        print(f"built {cuda_build.library_path(name).name} in {s:.1f} s",
              flush=True)
        log = cuda_build.library_path(name).with_suffix(".so.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}", flush=True)
    print(f"{len(libraries)} kernel libraries built in parallel in "
          f"{time.time() - t0:.1f} s",
          flush=True)

    errs = kernel_vs_plain(fb, dev)
    # host-clock measurements first: once torch.profiler has run, the
    # process keeps paying for its tracing on every launch
    host_us = wrapper_host_us(fb, dev)
    g, gen = generator_phase(fb, dev, card)
    t11 = time.time()
    int8 = {"vs_plain": int8_vs_plain(quant, dev),
            "shapes": int8_kernel_times(quant, dev),
            "generator": int8_generator_phase(fb, quant, dev, card)}
    torch.cuda.empty_cache()
    int8["phase_s"] = time.time() - t11
    print(f"phase 11: {int8['phase_s']:.1f} s", flush=True)
    t7 = time.time()
    projected = projector_phase(fb, dev, card)
    torch.cuda.empty_cache()
    projected["phase_s"] = time.time() - t7
    t8 = time.time()
    setup = coach_setup(dev)
    coached = coach_phase(fb, dev, card, setup)
    del setup
    torch.cuda.empty_cache()
    coached["phase_s"] = time.time() - t8
    t9 = time.time()
    edit_root = pathlib.Path(__file__).resolve().parent / "build" / \
        "smoke_edit"
    shutil.rmtree(edit_root, ignore_errors=True)
    esetup = edit_setup(dev, edit_root)
    edited = {"sweep": edit_sweep_phase(fb, dev, card, esetup),
              "svm": svm_phase(dev, edit_root)}
    edited["phase_s"] = time.time() - t9
    t10 = time.time()
    metric_root = pathlib.Path(__file__).resolve().parent / "build" / \
        "smoke_metrics"
    shutil.rmtree(metric_root, ignore_errors=True)
    msetup = metric_setup(dev, metric_root)
    metrics = {"fid": fid_phase(fb, dev, card, msetup)}
    del msetup                    # rebuilt from its files after phase 9
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.time() - t10
    rows = kernel_times(fb, dev)
    gen["profile"] = [profile_forward(g, dev, b) for b in (1, 64)]
    int8["profile"] = profile_int8_forward(dev)
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

    try:
        cli = {"data": data_phase(out_root / "data", 256, TRAIN_BATCH)}
        cli["train"] = cli_train_phase(fb, dev, out_root, cli["data"], [])
        cli["data_parallel"] = data_parallel_phase(dev)
        cli["serve_state"] = serve_state_phase(
            fb, dev, cli["train"]["state_dir"])
        cli["codec"] = codec_phase(card, cli["data"], cli["train"])
        cli["forms"] = image_forms_phase(fb, card, out_root, cli["data"],
                                         cli["train"], cli["codec"], [])
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    t7 = time.time()
    proj_setup, _ = projector_setup(dev)
    projected["profile"] = profile_projector(dev, proj_setup)
    projected["split_ms"] = projector_split(dev, proj_setup)
    projected["kernel_vs_plain"] = projector_vs_plain(fb, dev, proj_setup)
    try:
        projected["cli"] = project_cli_phase(fb, dev, out_root,
                                             proj_setup[0], [])
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    del proj_setup
    projected["phase_s"] += time.time() - t7
    print(f"phase 7: {projected['phase_s']:.1f} s", flush=True)
    t8 = time.time()
    setup = coach_setup(dev)
    coached["profile"] = profile_coach(dev, setup)
    coached["kernel_vs_plain"] = coach_vs_plain(fb, dev, setup)
    g_coach = setup["g"]
    del setup
    torch.cuda.empty_cache()
    coached["card_vs_cpu"] = coach_card_vs_cpu(fb, dev)
    try:
        coached["cli"] = encoder_cli_phase(fb, dev, out_root, g_coach, [])
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    del g_coach
    coached["phase_s"] += time.time() - t8
    print(f"phase 8: {coached['phase_s']:.1f} s", flush=True)
    t9 = time.time()
    try:
        edited["profile"] = profile_scoring(dev, esetup)
        bounds = {k: np.load(edit_root / "svm_normal.npy") for k in "zp"}
        edited["strips"] = strips_phase(fb, dev, card, esetup, bounds)
        edited["card_vs_cpu"] = scorers_card_vs_cpu(dev, esetup)
        edited["cli"] = edit_cli_phase(fb, dev, edit_root, esetup, [])
    finally:
        shutil.rmtree(edit_root, ignore_errors=True)
    del esetup
    torch.cuda.empty_cache()
    edited["phase_s"] += time.time() - t9
    print(f"phase 9: {edited['phase_s']:.1f} s", flush=True)
    t10 = time.time()
    try:
        msetup = metric_setup(dev, metric_root)
        metrics["profile"] = profile_fid(dev, msetup)
        metrics["kernel_vs_plain"] = metrics_vs_plain(fb, dev, msetup)
        metrics["prdc_knn"] = prdc_knn_phase(dev)
        metrics["prdc"] = prdc_images_phase(fb, dev, card, msetup)
        metrics["ppl"] = ppl_phase(fb, dev, card, msetup)
        metrics["diversity"] = diversity_phase(fb, dev, card, msetup)
        metrics["cli"] = metric_cli_phase(fb, dev, msetup, [])
    finally:
        shutil.rmtree(metric_root, ignore_errors=True)
    del msetup
    torch.cuda.empty_cache()
    metrics["phase_s"] += time.time() - t10
    print(f"phase 10: {metrics['phase_s']:.1f} s", flush=True)
    t12 = time.time()
    cli_root = pathlib.Path(__file__).resolve().parent / "build" / \
        "smoke_cli"
    shutil.rmtree(cli_root, ignore_errors=True)
    try:
        rest = remaining_cli_phase(fb, dev, cli_root, [])
    finally:
        shutil.rmtree(cli_root, ignore_errors=True)
    torch.cuda.empty_cache()
    rest["phase_s"] = time.time() - t12
    print(f"phase 12: {rest['phase_s']:.1f} s", flush=True)
    t13 = time.time()
    mesh_root = pathlib.Path(__file__).resolve().parent / "build" / \
        "smoke_mesh"
    shutil.rmtree(mesh_root, ignore_errors=True)
    try:
        meshed = mesh_phase(fb, dev, mesh_root)
    finally:
        shutil.rmtree(mesh_root, ignore_errors=True)
    torch.cuda.empty_cache()
    meshed["phase_s"] = time.time() - t13
    print(f"phase 13: {meshed['phase_s']:.1f} s", flush=True)
    metric_launches = {
        k: metrics[k]["launches"] for k in ("fid", "prdc", "ppl",
                                            "diversity")}
    metric_launches["cli_evaluate"] = metrics["cli"]["launches"]["evaluate"]
    edit_launches = {"sweep": edited["sweep"]["launches"],
                     "strips": edited["strips"]["launches"],
                     **{f"cli_{k}": v
                        for k, v in edited["cli"]["launches"].items()}}
    serve_paths = dict(paths)
    for k, n in cli["serve_state"]["launches"].items():
        serve_paths[k] = serve_paths.get(k, 0) + n

    def total(by_role_path):
        return sum(n for by in by_role_path.values() for n in by.values())

    def summed(key):
        return sum(r[key] for r in brows)

    kernel = {
        "name": "fused_blur4", "route": "cuda",
        "source": "transeditor_tpu_torch/csrc/fused_blur4.cu",
        "replaces": "transeditor_tpu/ops/pallas_blur.py:131",
        # the main paths, each counted from 0: serving (phase 4),
        # training (5b), the CLI's training (6b, 6f-2), serving its state
        # (6d)
        "launches": sum(serve_paths.values()) + total(trained["main_launches"])
        + total(cli["train"]["launches"]) + total(cli["forms"]["launches"])
        + total(projected["launches"])
        + total(projected["cli"]["launches"])
        + sum(total(c) for c in coached["launches"].values())
        + sum(total(c) for c in coached["cli"]["launches"].values())
        + sum(total(c) for c in edit_launches.values())
        + sum(total(c) for c in metric_launches.values())
        + sum(int8["generator"]["launches_per_forward"]["fused_blur4"]
              .values())
        + sum(int8["generator"]["served_launches"]["fused_blur4"].values())
        + total(rest["visualize_launches"])
        + total(meshed["fsdp"]["launches"]),
        "path_launches": serve_paths,
        "train_launches": trained["main_launches"],
        "cli_train_launches": cli["train"]["launches"],
        # 6f-2, from 0: two steps on the LMDB of the image-form fixtures
        "forms_train_launches": cli["forms"]["launches"],
        "serve_state_launches": cli["serve_state"]["launches"],
        # the projector (7a, 60 steps) and cli.project (7c), each from 0
        "project_launches": {"projector": projected["launches"],
                             "cli": projected["cli"]["launches"]},
        # 7b: a projector step's gradients in z+ and p+, kernel vs plain
        "project_launch_errors":
            projected["kernel_vs_plain"]["launch_errors"],
        "project_step_grad_errors": projected["kernel_vs_plain"]["errors"],
        # the coach (8a: 10 train steps, one fake and one eval step) and
        # its CLIs (8c: cli.train_encoder, cli.encode), each from 0
        "coach_launches": {**coached["launches"],
                           **coached["cli"]["launches"]},
        "coach_launches_per_step": coached["launches_per_step"],
        # 8b: a coach step's launches replayed through the plain version
        "coach_launch_errors": coached["kernel_vs_plain"]["launch_errors"],
        "coach_step_grad_l2_card_vs_cpu": coached["card_vs_cpu"]["grad_l2"],
        # phase 9, each from 0: the scoring sweep (9a), the timed edit
        # strips (9c), cli.edit sampled and --encoded_z/p (9e)
        "edit_launches": edit_launches,
        # 9c: one strip decode's launches replayed through the plain
        # version (bf16 within 2 ulps, f32 within 1e-5 of the largest)
        "edit_launch_errors": edited["strips"]["replay"],
        # phase 10, each from 0: evaluate_fid (10a), evaluate_prdc (10b),
        # compute_ppl (10c), evaluate_lpips_diversity (10d), cli.evaluate
        # (10e)
        "metric_launches": metric_launches,
        # one FID batch decode's launches replayed through the plain
        # version (bf16 within 2 ulps, f32 within 1e-5 of the largest)
        "metric_launch_errors": metrics["kernel_vs_plain"],
        # phase 11c, each from 0: one int8 forward, the int8 engine's
        # requests; phase 12: cli.visualize
        "int8_launches": {
            "forward": int8["generator"]["launches_per_forward"][
                "fused_blur4"],
            "engine": int8["generator"]["served_launches"]["fused_blur4"]},
        "visualize_launches": rest["visualize_launches"],
        # phase 13a, from 0: two full-width --fsdp R1 + path steps
        "mesh_launches": meshed["fsdp"]["launches"],
        # 13b: forward and adjoint on the model axis's channel slices
        # (C / 2, C / 4), f32 batch 16, by CUDA graph replay
        "slice_shapes": meshed["slices"]["rows"],
        "launches_per_train_step": {k: v["launches"]
                                    for k, v in train_counts.items()},
        "max_abs_err": max(errs["max_err_f32"], errs["max_err_bf16"],
                           grad_errs["max_abs_err"],
                           coached["kernel_vs_plain"]["max_abs_err"],
                           edited["strips"]["replay"]["f32_max_abs"],
                           metrics["kernel_vs_plain"]["f32_max_abs"],
                           *(r["max_abs_err"] for r in rows),
                           *(r[k]["max_abs_err"]
                             for r in meshed["slices"]["rows"]
                             for k in ("forward", "adjoint"))),
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
    print(json.dumps({"cli": cli}), flush=True)
    print(json.dumps({"project": projected}), flush=True)
    print(json.dumps({"coach": coached}), flush=True)
    print(json.dumps({"edit": edited}), flush=True)
    print(json.dumps({"metrics": metrics}), flush=True)
    print(json.dumps({"int8": int8}), flush=True)
    print(json.dumps({"remaining_cli": rest}), flush=True)
    print(json.dumps({"mesh": meshed}), flush=True)
    print(f"chip_smoke: all phases in {time.time() - started:.1f} s",
          flush=True)
    print(f"card: {card}", flush=True)
    rows8 = int8["shapes"]
    gen8 = int8["generator"]
    int8_kernel = {
        "name": "conv2d_int8", "route": "cuda",
        "source": "transeditor_tpu_torch/csrc/conv2d_int8_wgmma.cu",
        # the earlier kernel, kept for what the wgmma path cannot describe
        "general_path_source": "transeditor_tpu_torch/csrc/conv2d_int8.cu",
        # an XLA convolution in the JAX package, no Pallas predecessor
        "replaces": "transeditor_tpu/ops/quant.py:70",
        # the int8 main paths, each counted from 0: one forward (11c) and
        # the int8 engine's requests (11c)
        "launches": sum(gen8["launches_per_forward"]["conv2d_int8"].values())
        + sum(gen8["served_launches"]["conv2d_int8"].values()),
        "launches_by_path": {"forward": gen8["launches_per_forward"][
            "conv2d_int8"], "engine": gen8["served_launches"]["conv2d_int8"]},
        "launches_by_kernel_path": {
            "forward": gen8["launches_per_forward"]["conv2d_int8_paths"],
            "engine": gen8["served_launches"]["conv2d_int8_paths"]},
        # bit-equal to the plain version in every case (11a, 11b)
        "max_abs_err": 0.0,
        # device time per launch by CUDA graph replay, bf16 out, batch 64,
        # the 13 main-path shapes summed: the wgmma path, and the earlier
        # kernel (the general path) in the same run
        "ms": sum(r["ms"] for r in rows8),
        "earlier_kernel_ms": sum(r["earlier_kernel_ms"] for r in rows8),
        "plain_ms": sum(r["plain_ms"] for r in rows8),
        "bound_ms": sum(r["bound_ms"] for r in rows8),
        "share_of_bound": sum(r["bound_ms"] for r in rows8)
        / sum(r["ms"] for r in rows8),
        # 11 of the 13 shapes, and the sum, are bound by operations
        "bound_by": "operations" if sum(r["ops_ms"] for r in rows8)
        >= sum(r["bytes_ms"] for r in rows8) else "bytes",
        # no PyTorch call computes an int8 convolution on CUDA; cuDNN's
        # bf16 conv of the same shape is a yardstick of another function
        "library_ms": None,
        "cudnn_bf16_ms": sum(r["cudnn_bf16_ms"] for r in rows8),
        # torch._int_mm of the same-sized GEMMs: no gather, no epilogue
        "int_mm_ms": sum(r["int_mm_ms"] for r in rows8),
        # the wrapper's host time per call, per shape (host clock)
        "host_us": [r["host_us"] for r in rows8],
        "timed": f"bf16 out, batch {TIME_BATCH}, 13 main-path shapes summed",
        "shapes": rows8,
    }
    print(json.dumps({"kernels": [kernel, int8_kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
