"""Visual smoke-test CLI: sampling, swap and interpolation grids, and the
attention similarity heatmaps (``transeditor_tpu/cli/visualize.py``; the
reference ``test_spatial_query.py`` modes --sample, --swap_z / --swap_p,
--interp and --dat_interp).  Each strip is one batched forward.

Usage, on the card:
  python -m transeditor_tpu_torch.cli.visualize --ckpt 790000.pt \\
      --sample --swap_z --swap_p --interp --dat_interp \\
      --out ./generation [--device cuda]

``--ckpt`` is a reference ``.pt`` bundle or a directory of the port's
training checkpoints (the latest step's ``g_ema``).  The flags, their
defaults (bfloat16) and the file tree are the JAX CLI's, plus
``--device``.  Codes come from a ``torch.Generator`` seeded as the JAX
CLI seeds its keys (other numbers than JAX's); every ``run_*`` takes
``draws=`` to use another source.  The random interpolation boundaries
come from ``np.random.RandomState(seed)``, the same numbers in both.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from transeditor_tpu_torch.cli.common import (add_model_flags,
                                              model_config_from_args)
from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.edit.boundary import linear_interpolate
from transeditor_tpu_torch.io.checkpoint import (checkpoint_steps,
                                                 load_reference_generator,
                                                 load_train_state_generator)
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.utils.image import (colorize_heatmap, make_grid,
                                               save_png)
from transeditor_tpu_torch.utils.sampling import sample_tokens

# draws(seed, batch, n_tokens, dim, truncation, same) -> [B, T, D] codes
Draws = Callable[[int, int, int, int, float, bool], np.ndarray]


def torch_draws(seed: int, batch: int, n_tokens: int, dim: int,
                truncation: float = 1.0, same: bool = False) -> np.ndarray:
    """Codes from a CPU ``torch.Generator`` seeded ``seed``, where the
    JAX CLI draws from ``PRNGKey(seed)``."""
    rng = torch.Generator().manual_seed(seed)
    return sample_tokens(rng, batch, n_tokens, dim, truncation,
                         same).numpy()


class Sampler(torch.nn.Module):
    """No-grad inference wrapper around a loaded g_ema on its device;
    takes and returns numpy arrays."""

    def __init__(self, g: Generator):
        super().__init__()
        self.g = g.eval()
        self.cfg: ModelConfig = g.cfg

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(
            self.g.token.device)

    @torch.inference_mode()
    def forward(self, z, p, **kw):
        return self.g(self._dev(z), self._dev(p), **kw)

    def images(self, z, p, **kw) -> np.ndarray:
        return self(z, p, **kw).image.float().cpu().numpy()

    @torch.inference_mode()
    def map_codes(self, z, p):
        zp, pp = self.g.map_codes(self._dev(z), self._dev(p))
        return zp.float().cpu().numpy(), pp.float().cpu().numpy()

    def style_latents(self, z, p) -> np.ndarray:
        return self(z, p).latent.float().cpu().numpy()


def run_sample(s: Sampler, out_dir, n_sample=8, loops=10, truncation=0.7,
               seed=0, draws: Draws = torch_draws):
    """Grids from a fixed P, fresh Z each loop (reference :20-31)."""
    cfg = s.cfg
    p = draws(seed, n_sample, cfg.n_tokens, cfg.param_dim, truncation, False)
    for i in range(loops):
        z = draws(seed + 1 + i, n_sample, cfg.n_tokens, cfg.style_dim,
                  truncation, False)
        save_png(os.path.join(out_dir, f"{i}.png"),
                 make_grid(s.images(z, p), nrow=int(n_sample ** 0.5)))


def run_swap(s: Sampler, out_dir, which="z", n_sample=8, loops=8,
             truncation=1.0, seed=0, draws: Draws = torch_draws):
    """Fix one space, resample the other: the identity / style swap grid."""
    cfg = s.cfg
    fixed_dim = cfg.param_dim if which == "z" else cfg.style_dim
    fresh_dim = cfg.style_dim if which == "z" else cfg.param_dim
    fixed = draws(seed, n_sample, cfg.n_tokens, fixed_dim, truncation, False)
    rows = []
    for i in range(loops):
        fresh = draws(seed + 1 + i, n_sample, cfg.n_tokens, fresh_dim,
                      truncation, False)
        rows.append(s.images(fresh, fixed) if which == "z"
                    else s.images(fixed, fresh))
    grid = make_grid(np.concatenate(rows), nrow=n_sample, pad=0)
    save_png(os.path.join(out_dir, f"swap_{which}.png"), grid)


def _interp_tokens_along_boundary(base_tokens, boundary, steps=8):
    """Each of B token sets moved along a random boundary: [B*steps, T, D]."""
    outs = []
    for i in range(base_tokens.shape[0]):
        flat = base_tokens[i:i + 1].reshape(1, -1, base_tokens.shape[-1])
        moved = linear_interpolate(flat, boundary, -1.0, 1.0, steps)
        outs.append(moved.reshape(steps, *base_tokens.shape[1:]))
    return np.concatenate(outs)


def run_interp(s: Sampler, out_dir, space="z", n_rows=8, steps=8,
               truncation=1.0, seed=0, num_tests=3,
               draws: Draws = torch_draws):
    """Boundary interpolation in {z, z+, w, p, p+} (reference :75-189)."""
    cfg = s.cfg
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for j in range(num_tests):
        z = draws(seed + j, n_rows, cfg.n_tokens, cfg.style_dim, truncation,
                  False)
        p = draws(seed + 100 + j, n_rows, cfg.n_tokens, cfg.param_dim,
                  truncation, True)
        boundary = rng.randn(1, cfg.style_dim).astype(np.float32)
        boundary /= np.linalg.norm(boundary)

        if space == "z":
            moved = _interp_tokens_along_boundary(z, boundary, steps)
            img = s.images(moved, np.repeat(p[:1], len(moved), 0))
        elif space == "z+":
            zp, _ = s.map_codes(z, p)
            moved = _interp_tokens_along_boundary(zp, boundary, steps)
            img = s.images(moved, np.repeat(p[:1], len(moved), 0),
                           map_z=False)
        elif space == "w":
            w = s.style_latents(z, p)
            moved = _interp_tokens_along_boundary(w, boundary, steps)
            img = s.images(moved, np.repeat(p[:1], len(moved), 0),
                           input_is_latent=True)
        elif space == "p":
            moved = _interp_tokens_along_boundary(
                draws(seed + 200 + j, n_rows, cfg.n_tokens, cfg.param_dim,
                      truncation, False), boundary, steps)
            img = s.images(np.repeat(z[:1], len(moved), 0), moved)
        elif space == "p+":
            _, pp = s.map_codes(z, p)
            moved = _interp_tokens_along_boundary(pp, boundary, steps)
            img = s.images(np.repeat(z[:1], len(moved), 0), moved,
                           map_p=False)
        else:
            raise ValueError(space)
        save_png(os.path.join(out_dir, f"interp_{space}_{j}.png"),
                 make_grid(img, nrow=steps))


def run_dat_interp(s: Sampler, out_dir, space="z", n=6, steps=4,
                   truncation=1.0, seed=0, num_tests=3,
                   draws: Draws = torch_draws):
    """lerp between two batch-repeated draws (reference :116-148,192-225)."""
    cfg = s.cfg
    os.makedirs(out_dir, exist_ok=True)
    for j in range(num_tests):
        k = seed + 10 * j
        rows = []
        if space in ("z", "z+"):
            a = draws(k, n, cfg.n_tokens, cfg.style_dim, truncation, True)
            b = draws(k + 1, n, cfg.n_tokens, cfg.style_dim, truncation, True)
            p = draws(k + 2, n, cfg.n_tokens, cfg.param_dim, truncation,
                      False)
            if space == "z+":
                a, _ = s.map_codes(a, p)
                b, _ = s.map_codes(b, p)
            for i in range(steps):
                t = 0.25 * (i + 1)
                rows.append(s.images(a + (b - a) * t, p,
                                     map_z=(space == "z")))
        else:  # p / p+
            z = draws(k, n, cfg.n_tokens, cfg.style_dim, truncation, False)
            a = draws(k + 1, n, cfg.n_tokens, cfg.param_dim, truncation, True)
            b = draws(k + 2, n, cfg.n_tokens, cfg.param_dim, truncation, True)
            if space == "p+":
                _, a = s.map_codes(z, a)
                _, b = s.map_codes(z, b)
            for i in range(steps):
                t = 0.25 * (i + 1)
                rows.append(s.images(z, a + (b - a) * t,
                                     map_p=(space == "p")))
        save_png(os.path.join(out_dir, f"interp_{space}_{j}.png"),
                 make_grid(np.concatenate(rows), nrow=n))


def run_similarity(s: Sampler, out_dir, n=8, seed=0,
                   draws: Draws = torch_draws):
    """Per-block, per-head cross-attention similarity heatmaps
    (reference save_similarity, train_spatial_query.py:114-122)."""
    cfg = s.cfg
    z = draws(seed, n, cfg.n_tokens, cfg.style_dim, 1.0, False)
    p = draws(seed + 1, n, cfg.n_tokens, cfg.param_dim, 1.0, False)
    out = s(z, p, return_similarity=True)
    os.makedirs(out_dir, exist_ok=True)
    for layer, sim in enumerate(out.similarity):
        sim = sim.float().mean(dim=0).cpu().numpy()     # [heads, 16, 16]
        for head in range(sim.shape[0]):
            save_png(os.path.join(out_dir,
                                  f"sim_{layer:02d}_{head:02d}.png"),
                     colorize_heatmap(sim[head]))


def load_generator_weights(ckpt: str, cfg: ModelConfig) -> dict:
    """g_ema of a reference ``.pt`` or of the latest checkpoint in a
    directory of the port's training checkpoints.  Any other directory
    (an orbax checkpoint of the JAX package) raises ``ValueError``."""
    if os.path.isdir(ckpt):
        if not checkpoint_steps(ckpt):
            raise ValueError(
                f"{ckpt} is a directory without <step>.pt train-state "
                f"files, an orbax checkpoint of the JAX package? The "
                f"PyTorch port reads a reference .pt bundle or its own "
                f"training checkpoint directory")
        weights, step = load_train_state_generator(ckpt)
        print(f"g_ema of step {step} from {ckpt}")
        return weights
    return load_reference_generator(ckpt, cfg)


def main(argv=None, draws: Optional[Draws] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help=".pt reference bundle or a train_gan checkpoint "
                         "directory")
    ap.add_argument("--out", type=str, default="./generation/visual")
    ap.add_argument("--n_sample", type=int, default=8)
    ap.add_argument("--loop_num", type=int, default=10)
    ap.add_argument("--truncation", type=float, default=1.0)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--swap_z", action="store_true")
    ap.add_argument("--swap_p", action="store_true")
    ap.add_argument("--interp", action="store_true")
    ap.add_argument("--dat_interp", action="store_true")
    ap.add_argument("--interp_num", type=int, default=6)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    add_model_flags(ap, dtype_default="bfloat16")
    args = ap.parse_args(argv)
    draws = draws or torch_draws

    dev = resolve_device(args.device)
    cfg = model_config_from_args(args)
    g = Generator(cfg, device=dev)
    g.load_state_dict(load_generator_weights(args.ckpt, cfg), strict=True)
    s = Sampler(g)

    os.makedirs(args.out, exist_ok=True)
    if args.sample:
        run_sample(s, args.out, args.n_sample, args.loop_num,
                   truncation=0.7, draws=draws)
    if args.swap_z:
        run_swap(s, args.out, "z", args.n_sample,
                 truncation=args.truncation, draws=draws)
    if args.swap_p:
        run_swap(s, args.out, "p", args.n_sample,
                 truncation=args.truncation, draws=draws)
    if args.interp:
        for space in ("z", "z+", "w", "p", "p+"):
            run_interp(s, os.path.join(args.out, "interp_many", space),
                       space, truncation=args.truncation,
                       num_tests=args.interp_num, draws=draws)
    if args.dat_interp:
        for space in ("z", "z+", "p", "p+"):
            run_dat_interp(s, os.path.join(args.out, "interp_dat", space),
                           space, truncation=args.truncation,
                           num_tests=args.interp_num, draws=draws)
    print("Test done!")


if __name__ == "__main__":
    main()
