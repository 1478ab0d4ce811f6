"""Serving: a batched inference engine over the generator, on the card.

The engine exposes the generator's user-facing operations with request
coalescing, as ``transeditor_tpu/serve.py``:

  * sample(n)                 - random faces
  * decode(z, p, plus_space)  - latent decode (editing frontends)
  * edit_strip(z+, p+, boundary, distances)

Requests pad to the next power-of-two batch, so the card only ever sees
a short ladder of batch shapes, each warmed at start-up (cuDNN picks
its algorithms and the caching allocator sizes its blocks per shape).
Concurrent requests are COALESCED: a micro-batching queue merges
simultaneous sample/decode calls into one forward.  The HTTP front
(stdlib ThreadingHTTPServer, JSON) is a thin adapter; the engine is the
library API.

Run on the card, from a reference ``.pt`` or from the port's training
checkpoints (the latest, or ``--step``):
  python -m transeditor_tpu_torch.serve --ckpt 790000.pt --port 8000
  python -m transeditor_tpu_torch.serve --state_dir out/run1/checkpoint
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.edit.boundary import linear_interpolate
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.utils.image import to_uint8
from transeditor_tpu_torch.utils.sampling import sample_zp

# Largest single forward: bounds the batch-shape ladder and the
# activation memory of one call; bigger merged requests run in chunks.
_MAX_DEVICE_BATCH = 256


def _pad_pow2(n: int, lo: int = 1, hi: int = _MAX_DEVICE_BATCH) -> int:
    p = lo
    while p < n and p < hi:
        p *= 2
    return p


class _Batcher:
    """Coalesce concurrent requests into one device call.

    ``run(items) -> [result_per_item]`` executes a merged batch; the
    worker drains the queue for ``window_ms`` after the first request
    (or until ``max_items``) before running."""

    def __init__(self, run, max_items: int = 64, window_ms: float = 2.0):
        self._run = run
        self._q: queue.Queue = queue.Queue()
        self._max = max_items
        self._window = window_ms / 1e3
        self.calls = 0                    # merged runs (for tests)
        t = threading.Thread(target=self._loop, daemon=True)
        t.start()

    def submit(self, item) -> Future:
        f: Future = Future()
        self._q.put((item, f))
        return f

    def _loop(self):
        while True:
            batch = [self._q.get()]
            deadline = time.monotonic() + self._window
            while len(batch) < self._max:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                self.calls += 1
                results = self._run([b[0] for b in batch])
                for (_, fut), r in zip(batch, results):
                    fut.set_result(r)
            except Exception as e:  # the worker must outlive a bad batch
                for _, fut in batch:
                    fut.set_exception(e)


class InferenceEngine:
    """Serves a generator state dict (reference ``.pt`` layout) on
    ``device`` (default "cuda"; raises if CUDA is absent and the CPU was
    not asked for)."""

    def __init__(self, cfg: ModelConfig,
                 state_dict: Mapping[str, torch.Tensor], seed: int = 0,
                 coalesce_window_ms: float = 5.0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.gen = Generator(cfg, device=self.device)
        self.gen.load_state_dict(state_dict, strict=True)
        self.gen.eval()
        self._rng = torch.Generator(self.device).manual_seed(seed)
        self._lock = threading.Lock()
        self.shapes_run: set = set()      # (endpoint, batch[, plus_space])
        self._sample_batcher = _Batcher(self._run_samples,
                                        window_ms=coalesce_window_ms)
        self._decode_batchers = {
            plus: _Batcher(lambda items, plus=plus:
                           self._run_decodes(items, plus),
                           window_ms=coalesce_window_ms)
            for plus in (True, False)}

    # ----------------------------------------------------- device calls

    @torch.inference_mode()
    def _sample(self, batch: int):
        with self._lock:                  # one draw sequence per engine
            z, p = sample_zp(self._rng, batch, self.cfg.n_tokens,
                             self.cfg.style_dim)
        out = self.gen(z, p)
        self.shapes_run.add(("sample", batch))
        return out.image, out.z_plus, out.p_plus

    @torch.inference_mode()
    def _decode(self, z: np.ndarray, p: np.ndarray, plus_space: bool):
        zt = torch.from_numpy(z).to(self.device)
        pt = torch.from_numpy(p).to(self.device)
        out = self.gen(zt, pt, map_z=not plus_space, map_p=not plus_space)
        self.shapes_run.add(("decode", z.shape[0], plus_space))
        return out.image

    @staticmethod
    def _host(t: torch.Tensor, take: int) -> np.ndarray:
        return t[:take].float().cpu().numpy()

    # ----------------------------------------------------- batched runs

    def _run_samples(self, counts: List[int]):
        total = sum(counts)
        # chunk merged requests > _MAX_DEVICE_BATCH across device calls
        # (a pow2 cap alone would silently truncate large requests)
        imgs, zps, pps, done = [], [], [], 0
        while done < total:
            take = min(total - done, _MAX_DEVICE_BATCH)
            img, zp, pp = self._sample(_pad_pow2(take))
            imgs.append(to_uint8(self._host(img, take)))
            zps.append(self._host(zp, take))
            pps.append(self._host(pp, take))
            done += take
        img = np.concatenate(imgs)
        zp, pp = np.concatenate(zps), np.concatenate(pps)
        out, start = [], 0
        for n in counts:
            out.append((img[start:start + n], zp[start:start + n],
                        pp[start:start + n]))
            start += n
        return out

    def _run_decodes(self, items: List[Tuple[np.ndarray, np.ndarray]],
                     plus_space: bool):
        counts = [z.shape[0] for z, _ in items]
        n = sum(counts)
        t, d = items[0][0].shape[-2:]
        z_all = np.concatenate([z for z, _ in items]).astype(np.float32)
        p_all = np.concatenate([p for _, p in items]).astype(np.float32)
        imgs, done = [], 0
        while done < n:
            take = min(n - done, _MAX_DEVICE_BATCH)
            b = _pad_pow2(take)
            zp = np.zeros((b, t, d), np.float32)
            pp = np.zeros((b, t, d), np.float32)
            zp[:take] = z_all[done:done + take]
            pp[:take] = p_all[done:done + take]
            img = self._decode(zp, pp, plus_space)
            imgs.append(to_uint8(self._host(img, take)))
            done += take
        img = np.concatenate(imgs)
        out, start = [], 0
        for c in counts:
            out.append(img[start:start + c])
            start += c
        return out

    # ------------------------------------------------------------- API

    def warmup(self, max_batch: int = 64, decode: bool = True):
        """Run every power-of-two batch up to ``max_batch`` once, so the
        first request at each padded size does not pay cuDNN's algorithm
        choice and the allocator's growth inside the coalescing queue."""
        b = 1
        t, d = self.cfg.n_tokens, self.cfg.style_dim
        while b <= max_batch:
            self._sample(b)
            if decode:
                z = np.zeros((b, t, d), np.float32)
                for plus in (True, False):
                    self._decode(z, z, plus)
            b *= 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sample(self, n: int):
        """Returns (uint8 images [n,H,W,3], z_plus, p_plus).
        Concurrent callers are coalesced into one device call."""
        return self._sample_batcher.submit(n).result()

    def decode(self, z: np.ndarray, p: np.ndarray,
               plus_space: bool = True) -> np.ndarray:
        return self._decode_batchers[bool(plus_space)].submit(
            (np.asarray(z, np.float32), np.asarray(p, np.float32))
        ).result()

    def edit_strip(self, z_plus: np.ndarray, p_plus: np.ndarray,
                   boundary: np.ndarray, space: str = "p",
                   start: float = -3.0, end: float = 3.0,
                   steps: int = 8) -> np.ndarray:
        """Move one latent along a boundary; returns [steps,H,W,3] u8."""
        t, d = z_plus.shape[-2:]
        if space == "p":
            moved = linear_interpolate(p_plus.reshape(1, -1),
                                       boundary, start, end, steps)
            p_in = moved.reshape(steps, t, d)
            z_in = np.broadcast_to(z_plus.reshape(1, t, d), (steps, t, d))
        else:
            moved = linear_interpolate(z_plus.reshape(1, -1),
                                       boundary, start, end, steps)
            z_in = moved.reshape(steps, t, d)
            p_in = np.broadcast_to(p_plus.reshape(1, t, d), (steps, t, d))
        return self.decode(z_in, p_in, plus_space=True)


def make_http_server(engine: InferenceEngine, host: str = "127.0.0.1",
                     port: int = 8000):
    """Minimal JSON-over-HTTP front (stdlib only); call
    ``serve_forever()`` on the result, ``shutdown()`` to stop.

    GET  /health
    POST /sample      {"n": 4}            -> {"images": [...u8 nested...]}
    POST /decode      {"z": [...], "p": [...], "plus_space": true}
    POST /edit_strip  {"z_plus", "p_plus", "boundary", "space", ...}

    Any POST may add ``{"format": "jpeg_b64"[, "quality": 90]}`` to get
    base64 JPEG strings instead of nested uint8 lists (encoded by the
    port's own JPEG codec, ``data/native.py``).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def encode_images(img: np.ndarray, req: dict):
        if req.get("format") == "jpeg_b64":
            import base64
            from transeditor_tpu_torch.data.native import encode_jpeg
            q = int(req.get("quality", 90))
            return [base64.b64encode(encode_jpeg(im, q)).decode()
                    for im in img]
        return img.tolist()

    class Handler(BaseHTTPRequestHandler):
        def _send_json(self, obj):
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send_json({"ok": True, "size": engine.cfg.size,
                                 "device": str(engine.device)})
            else:
                self.send_error(404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or "{}")
            except ValueError:
                self.send_error(400, "body must be JSON")
                return
            try:
                if self.path == "/sample":
                    img, zp, pp = engine.sample(int(req.get("n", 1)))
                    resp = {"images": encode_images(img, req),
                            "z_plus": zp.tolist(), "p_plus": pp.tolist()}
                elif self.path == "/decode":
                    img = engine.decode(
                        np.asarray(req["z"], np.float32),
                        np.asarray(req["p"], np.float32),
                        bool(req.get("plus_space", True)))
                    resp = {"images": encode_images(img, req)}
                elif self.path == "/edit_strip":
                    img = engine.edit_strip(
                        np.asarray(req["z_plus"], np.float32),
                        np.asarray(req["p_plus"], np.float32),
                        np.asarray(req["boundary"], np.float32),
                        space=req.get("space", "p"),
                        start=float(req.get("start", -3.0)),
                        end=float(req.get("end", 3.0)),
                        steps=int(req.get("steps", 8)))
                    resp = {"images": encode_images(img, req)}
                else:
                    self.send_error(404)
                    return
                self._send_json(resp)
            except Exception as e:  # answer the client, keep serving
                self.send_error(500, str(e))

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def run_http_server(engine: InferenceEngine, host: str = "127.0.0.1",
                    port: int = 8000):
    """Serve until interrupted."""
    server = make_http_server(engine, host, port)
    print(f"serving on http://{host}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def engine_from_checkpoint(cfg: ModelConfig, ckpt: Optional[str] = None,
                           state_dir: Optional[str] = None,
                           step: Optional[int] = None, seed: int = 0,
                           device: str | torch.device | None = None
                           ) -> InferenceEngine:
    """Build an engine serving ``g_ema``, from exactly one of a reference
    ``.pt`` (``ckpt``) or a directory of the port's training checkpoints
    (``state_dir``; the latest, or ``step``'s)."""
    from transeditor_tpu_torch.io import checkpoint
    if (ckpt is None) == (state_dir is None):
        raise ValueError("pass exactly one of ckpt / state_dir")
    if ckpt is not None:
        weights = checkpoint.load_reference_generator(ckpt, cfg)
    else:
        weights, got = checkpoint.load_train_state_generator(state_dir, step)
        print(f"serving g_ema from step {got}", flush=True)
    return InferenceEngine(cfg, weights, seed=seed, device=device)


def main(argv: Optional[List[str]] = None):
    import argparse
    p = argparse.ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", type=str,
                     help="reference-layout .pt bundle (g_ema is served)")
    src.add_argument("--state_dir", type=str,
                     help="training checkpoint dir (g_ema is served)")
    p.add_argument("--step", type=int, default=None,
                   help="with --state_dir: this step's checkpoint, not the "
                        "latest")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--warmup", type=int, default=64,
                   help="run the pow2 batch ladder up to this size before "
                        "serving (0 disables)")
    from transeditor_tpu_torch.cli.common import (add_model_flags,
                                                  model_config_from_args)
    add_model_flags(p, dtype_default="bfloat16")
    args = p.parse_args(argv)
    cfg = model_config_from_args(args)
    engine = engine_from_checkpoint(cfg, args.ckpt, args.state_dir,
                                    args.step, device=args.device)
    if args.warmup > 0:
        t0 = time.time()
        print(f"warming up to batch {args.warmup}...", flush=True)
        engine.warmup(args.warmup)
        print(f"warmup done in {time.time() - t0:.1f}s", flush=True)
    run_http_server(engine, args.host, args.port)


if __name__ == "__main__":
    main()
