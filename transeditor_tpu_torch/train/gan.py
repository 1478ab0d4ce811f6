"""Adversarial training step (``transeditor_tpu/train/gan.py``; the
StyleGAN2 recipe of reference train_spatial_query.py:125-371).

One step: the D step, lazy R1, the G step, lazy path length, the
optional spatial path regulariser, then the G EMA.  Each phase takes
its gradients with ``torch.autograd.grad`` and applies them with its
own optimizer, in that order, each on the parameters the phase before
left.  Both regularisers are grad-of-grad; on the card every blur of the
generator, forward, adjoint and recompute, runs the ``fused_blur4``
kernel.

The step draws its latents, path noise and layer noise from an explicit
``torch.Generator``.  ``draws=`` replaces the latents and path-noise
images with given values (a parity test feeds the values the JAX step
drew); nothing else uses it.

Under a process group (``parallel/``) the step keeps the JAX package's
global-batch semantics: a step over P processes, each with 1/P of the
batch, equals the one-process step on the whole batch.  Each process
scales its losses to its local share of the global mean, the gradients
are summed over processes (``all_reduce_grads``) before each optimizer
step, and the path-length means and the discriminator's minibatch
stddev are taken over the global batch.  Each process draws its own
latents and noise from its own generator.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import torch

from transeditor_tpu_torch.config import ModelConfig, TrainConfig
from transeditor_tpu_torch.device import resolve_device
from transeditor_tpu_torch.models.discriminator import Discriminator
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.parallel.data_parallel import (all_reduce_grads,
                                                          data_axis,
                                                          global_mean,
                                                          local_rows)
from transeditor_tpu_torch.parallel.mesh import (Mesh, ShardedParams,
                                                 create_mesh)
from transeditor_tpu_torch.train import losses
from transeditor_tpu_torch.utils.sampling import sample_zp


@dataclasses.dataclass
class GANTrainState:
    step: int
    g: Generator
    d: Discriminator
    g_ema: Generator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    mean_path_length: torch.Tensor              # float32 scalar on device
    mean_spatial_path_length: torch.Tensor
    sharding: Optional["StateSharding"] = None  # set by shard_state


@dataclasses.dataclass
class StateSharding:
    """The layout of a sharded train state: g_ema shares g's."""
    mesh: Mesh
    fsdp: bool
    g: ShardedParams
    d: ShardedParams
    g_ema: ShardedParams


def shard_state(state: GANTrainState, mesh: Mesh, fsdp: bool = False,
                min_size: int = 256) -> GANTrainState:
    """Shard ``state`` in place by ``param_partition_spec``: g, d and
    g_ema, and the Adam moments with their parameters (JAX shards the
    moments with ``fsdp=True`` whenever ``fsdp`` is on; with the model
    axis alone they follow the parameters too).  Each rank then holds
    only its block of every eligible tensor.  Returns the state."""
    if state.sharding is not None:
        raise ValueError("the state is sharded already")
    sh = StateSharding(mesh, fsdp,
                       *(ShardedParams(m, mesh, min_size, fsdp)
                         for m in (state.g, state.d, state.g_ema)))
    for layout, opt in ((sh.g, state.opt_g), (sh.d, state.opt_d),
                        (sh.g_ema, None)):
        if opt is not None:
            layout.shard_optimizer_(opt)
        layout.shard_()
    state.sharding = sh
    return state


def needs_sharding(mesh: Optional[Mesh], fsdp: bool) -> bool:
    """Whether a state on ``mesh`` is sharded: with ``fsdp`` on a data
    axis of more than one rank, or on a model axis of more than one."""
    return mesh is not None and ((fsdp and mesh.data_active)
                                 or mesh.model_active)


def make_optimizers(tcfg: TrainConfig, g: Generator, d: Discriminator):
    """Adam with lazy-regularisation lr / beta scaling (reference
    :461-473): lr * r and betas (0**r, 0.99**r), r = k / (k + 1)."""
    def adam(params, every):
        r = every / (every + 1)
        return torch.optim.Adam(params, lr=tcfg.lr * r,
                                betas=(0.0 ** r, 0.99 ** r), eps=1e-8)
    return adam(g.parameters(), tcfg.g_reg_every), \
        adam(d.parameters(), tcfg.d_reg_every)


def init_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0,
               device: str | torch.device | None = None) -> GANTrainState:
    """Fresh modules from ``seed`` (g_ema a copy of g) and optimizers, on
    ``device`` (default "cuda"; raises without a card unless "cpu")."""
    dev = resolve_device(device)
    g = Generator(cfg, device=dev, seed=seed)
    d = Discriminator(cfg, device=dev, seed=seed + 1)
    g_ema = copy.deepcopy(g).eval().requires_grad_(False)
    opt_g, opt_d = make_optimizers(tcfg, g, d)
    zero = torch.zeros((), device=dev)
    return GANTrainState(step=0, g=g, d=d, g_ema=g_ema, opt_g=opt_g,
                         opt_d=opt_d, mean_path_length=zero,
                         mean_spatial_path_length=zero.clone())


def _grads(loss: torch.Tensor, params: list) -> list:
    """d loss / d params; a parameter the loss does not reach gets zeros,
    so Adam steps it as optax does (its moments decay, its count runs)."""
    got = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, got)]


def _apply(opt: torch.optim.Optimizer, params: list, grads: list,
           mesh: Optional[Mesh] = None,
           layout: Optional[ShardedParams] = None) -> None:
    """Sum ``grads`` over the data axis and take one optimizer step; on a
    sharded state, reduce them to this rank's blocks and step the blocks
    (the gathered weights are released first)."""
    if layout is not None:
        grads = layout.reduce(grads)
        layout.release_()
    else:
        grads = all_reduce_grads(grads, mesh)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def _mean_over(fn: Callable, chunks: list):
    """Mean over microbatches of ``fn(chunk) -> (grads, metrics)``; each
    is already a mean over its microbatch, so equal chunks give the
    full-batch value."""
    grads, metrics = fn(chunks[0])
    for chunk in chunks[1:]:
        g2, m2 = fn(chunk)
        grads = [a + b for a, b in zip(grads, g2)]
        metrics = {k: metrics[k] + m2[k] for k in metrics}
    n = len(chunks)
    return [g / n for g in grads], {k: v / n for k, v in metrics.items()}


def local_path_batch(global_batch: int, shrink: int, world: int) -> int:
    """This process's rows of the path-length batch: the batch is
    ``max(1, global_batch // shrink)`` of the GLOBAL batch, as the
    one-process step takes it, split evenly over ``world`` processes.
    Raises ``ValueError`` when it does not split evenly."""
    path_batch = max(1, global_batch // shrink)
    if path_batch % world:
        raise ValueError(
            f"the path-length batch ({global_batch} // path_batch_shrink "
            f"{shrink} = {path_batch}) does not split evenly over {world} "
            f"processes; choose a batch whose path batch is a multiple of "
            f"{world}")
    return path_batch // world


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    device: str | torch.device | None = None,
                    mesh: Optional[Mesh] = None,
                    fsdp: bool = False) -> Callable:
    """Build ``train_step(state, real, rng, do_d_reg=False,
    do_g_reg=False, do_spatial_reg=False, draws=None) -> (state,
    metrics)``.

    ``real``: [B, size, size, 3], uint8 (normalised to [-1, 1] on the
    device) or float.  ``rng``: a ``torch.Generator`` on the step's
    device.  The state's modules and optimizers are updated in place.
    ``metrics`` holds float32 scalar tensors on the device (reading one
    waits for the step).

    ``tcfg.grad_accum = K > 1`` runs the D loss, R1 and the G loss over
    K microbatches in turn and applies the mean gradient once; the path
    regularisers stay one pass over the path batch (their running mean
    is a statistic of the whole batch).

    ``draws``: {"d": (z, p), "g": (z, p), "path": (z, p, noise_img),
    "spatial": (z, p, noise_img)}; z, p of "d" and "g" span the whole
    batch and are cut into the K microbatches in order.  Under a process
    group they span the global batch, and each rank takes its rows as
    ``parallel/data_parallel.py::local_rows`` lays them out (with K
    microbatches, its 1/world of each); ``real`` is the rank's rows in
    the same layout.

    The path regularisers take ``batch_size // path_batch_shrink`` rows
    of the global batch, each process its 1/world of them
    (``local_path_batch``); a ``ValueError`` is raised here, before any
    step, when they do not split evenly over the processes.

    ``mesh``: the (data, model) mesh; the batch, the draws and the
    global means are split over its data axis (without one, over the
    process group).  With ``fsdp`` it defaults to ``create_mesh()``.
    With ``fsdp`` (on a data axis of more than one rank) or a model axis
    of more than one rank, the first call shards an unsharded state
    (``shard_state``); between steps each rank holds its blocks.  At one
    rank ``fsdp`` is the identity, as JAX's ``n_data > 1`` makes it.

    The process group, if any, is read when the step is built.
    """
    dev = resolve_device(device)
    if mesh is None and fsdp:
        mesh = create_mesh()
    sharded = needs_sharding(mesh, fsdp)
    n_accum = max(1, int(tcfg.grad_accum))
    world = data_axis(mesh)[0]                # ranks of the data axis
    share = 1.0 / world                       # local share of a global mean
    local_path_batch(tcfg.batch_size, tcfg.path_batch_shrink, world)

    def latents(draws, phase, rng, batch, accum=n_accum):
        if draws is not None:
            return tuple(local_rows(t, accum, mesh).to(dev)
                         for t in draws[phase][:2])
        return sample_zp(rng, batch, cfg.n_tokens, cfg.style_dim)

    def path_inputs(draws, phase, rng, batch):
        # the path batch is one pass, not cut into microbatches
        z, p = latents(draws, phase, rng, batch, accum=1)
        if draws is not None:
            noise = local_rows(draws[phase][2], mesh=mesh).to(dev)
        else:
            noise = losses.path_noise(rng, (batch, cfg.size, cfg.size, 3))
        return z, p, noise

    def chunk(t):
        return list(t.chunk(n_accum)) if n_accum > 1 else [t]

    def train_step(state: GANTrainState, real: torch.Tensor,
                   rng: torch.Generator, do_d_reg: bool = False,
                   do_g_reg: bool = False, do_spatial_reg: bool = False,
                   draws: Optional[dict] = None):
        g, d = state.g, state.d
        params_g, params_d = list(g.parameters()), list(d.parameters())
        real = real.to(dev, non_blocking=True)
        if real.dtype == torch.uint8:
            real = real.float() / 127.5 - 1.0
        batch = real.shape[0]
        if batch % n_accum:
            raise ValueError(f"grad_accum={n_accum} must divide the "
                             f"per-step batch {batch}")
        micro_b = batch // n_accum
        path_batch = local_path_batch(batch * world, tcfg.path_batch_shrink,
                                      world)
        d.mesh = mesh
        if sharded and state.sharding is None:
            shard_state(state, mesh, fsdp)
        sh = state.sharding
        if sh is not None and (sh.mesh is not mesh or sh.fsdp != fsdp):
            raise ValueError("the state is sharded for another mesh or "
                             "fsdp setting than this step's")
        lay_g, lay_d = (sh.g, sh.d) if sh is not None else (None, None)

        def gather(layout):
            # data axis gathered; the model axis stays cut: column-parallel
            if layout is not None:
                layout.gather_(column=True)

        metrics = {}

        # --- D step: fakes from the current g, no gradient into g
        zd, pd = latents(draws, "d", rng, batch)
        gather(lay_g)
        gather(lay_d)

        def d_phase(args):
            r, z, p = args
            with torch.no_grad():
                fake = g(z, p, rng=rng).image
            fake_pred, real_pred = d(fake), d(r)
            loss = losses.d_logistic_loss(real_pred.float(),
                                          fake_pred.float())
            return _grads(loss * share, params_d), {
                "d": loss.detach(), "real_score": real_pred.detach().mean(),
                "fake_score": fake_pred.detach().mean()}

        grads, m = _mean_over(d_phase, list(zip(chunk(real), chunk(zd),
                                                chunk(pd))))
        _apply(state.opt_d, params_d, grads, mesh, lay_d)
        metrics.update(m)

        # --- lazy R1, weighted r1_gamma/2 * r1 * d_reg_every
        if do_d_reg:
            def r1_phase(r):
                r1 = losses.r1_penalty(d, r)
                weighted = tcfg.r1_gamma / 2 * r1 * tcfg.d_reg_every
                return _grads(weighted * share, params_d), {
                    "r1": r1.detach()}

            gather(lay_d)
            grads, m = _mean_over(r1_phase, chunk(real))
            _apply(state.opt_d, params_d, grads, mesh, lay_d)
            metrics.update(m)
        else:
            metrics["r1"] = torch.zeros((), device=dev)

        # --- G step
        zg, pg = latents(draws, "g", rng, batch)

        def g_phase(args):
            z, p = args
            fake = g(z, p, rng=rng).image
            loss = losses.g_nonsaturating_loss(d(fake).float())
            return _grads(loss * share, params_g), {"g": loss.detach()}

        gather(lay_d)
        grads, m = _mean_over(g_phase, list(zip(chunk(zg), chunk(pg))))
        if lay_d is not None:
            lay_d.release_()
        _apply(state.opt_g, params_g, grads, mesh, lay_g)
        metrics.update(m)

        # --- lazy path length, on the stage API
        if do_g_reg:
            gather(lay_g)
            z, p, noise = path_inputs(draws, "path", rng, path_batch)
            z_plus, p_plus = g.map_codes(z, p)
            latent = g.style_latents_from(g.interact_codes(z_plus, p_plus))
            penalty, state.mean_path_length, lengths = \
                losses.path_length_penalty(
                    lambda lat: g.synthesize(p_plus, lat, rng=rng), latent,
                    noise, state.mean_path_length, mesh=mesh)
            weighted = tcfg.path_regularize * tcfg.g_reg_every * penalty
            _apply(state.opt_g, params_g, _grads(weighted * share, params_g),
                   mesh, lay_g)
            metrics.update(path=penalty.detach(),
                           path_length=lengths.detach().mean())
        else:
            metrics.update(path=torch.zeros((), device=dev),
                           path_length=torch.zeros((), device=dev))

        # --- optional spatial path length in P or P+ (reference :252-285)
        if do_spatial_reg:
            gather(lay_g)
            z, p, noise = path_inputs(draws, "spatial", rng, path_batch)
            if tcfg.regu_space == "p":
                target = p.detach().requires_grad_(True)
                image = g(z, target, rng=rng).image
            else:                                           # "p+"
                target = g.map_p(p)
                image = g(z, target, map_p=False, rng=rng).image
            grad, = torch.autograd.grad((image.float() * noise).sum(),
                                        target, create_graph=True)
            grad = grad.float()
            # sum over TOKENS, mean over features: the reference's
            # .sum(2).mean(1) on its [B, 512, 16] layout
            lengths = torch.sqrt(grad.pow(2).sum(dim=1).mean(dim=-1))
            mean_spl = state.mean_spatial_path_length
            path_mean = mean_spl + 0.01 * (global_mean(lengths, mesh)
                                           - mean_spl)
            # path_mean is not detached inside the penalty
            penalty = (lengths - path_mean).pow(2).mean()
            weighted = (tcfg.spatial_path_regularize * tcfg.g_reg_every
                        * penalty)
            _apply(state.opt_g, params_g, _grads(weighted * share, params_g),
                   mesh, lay_g)
            state.mean_spatial_path_length = path_mean.detach()
            metrics.update(spatial_path=penalty.detach(),
                           spatial_path_length=lengths.detach().mean())
        else:
            metrics.update(spatial_path=torch.zeros((), device=dev),
                           spatial_path_length=torch.zeros((), device=dev))

        # --- EMA of g's parameters (on the blocks of a sharded state)
        decay = tcfg.ema_decay
        with torch.no_grad():
            ema = list(state.g_ema.parameters())
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, params_g, alpha=1 - decay)

        state.step += 1
        return state, metrics

    return train_step
