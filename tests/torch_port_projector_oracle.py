"""Shared pieces of the projector parity tests
(``test_torch_port_projector{,_steps,_restart}.py``): the config, the
LPIPS draws, the JAX and port models from the same weights, the target,
the latent statistics and JAX's draws, each computed once per process,
and the JAX objective rebuilt from the package's pieces.  What the tests
hold, and why, is in ``test_torch_port_projector.py``'s docstring.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.invert import projector as jp
from transeditor_tpu.models import Generator as JaxGenerator
from transeditor_tpu.utils.sampling import sample_zp as jax_sample_zp
from transeditor_tpu.zoo.backbones import VGG16_CFG
from transeditor_tpu.zoo.lpips import LPIPS as JaxLPIPS
from transeditor_tpu.zoo.lpips import load_lpips_params as jax_load_lpips

from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.invert import projector as tp
from transeditor_tpu_torch.io.torch_export import \
    generator_state_dict_from_jax
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.zoo.lpips import LPIPS, load_lpips_params

MODEL = dict(size=16, style_dim=32, param_dim=32, max_channels=32, n_trans=1)
STATS_REL = 1e-5
PROJ_REL = 1e-4
STEPS = 5
STEP_REL = 1e-5
UNPINNED_REL = 1e-4
RESTART_REL = 3e-4
# LPIPS draws: (kind, numpy seed); "init" is the JAX package's LPIPS
# initialisers, "he" He-scaled convs with N(0, 0.1) biases and heads
DRAWS = {"init0": ("init", 0), "init1": ("init", 1), "he0": ("he", 0)}
# the rounding-level starts of the restart test: z+ and p+ times 1 + d
RESTARTS = (0.0, 2.0 ** -22, -(2.0 ** -22), 2.0 ** -21, -(2.0 ** -21),
            2.0 ** -20, -(2.0 ** -20))


def _rel(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * top, f"{name}: {err} > {rel} * {top}"
    return err / top


def _lpips_sd(draw="init0"):
    """A VGG LPIPS state dict in torchvision's layout, from ``DRAWS``."""
    kind, seed = DRAWS[draw]
    rng = np.random.default_rng(seed)
    sd, idx, in_ch = {}, 0, 3
    for v in VGG16_CFG:
        if v == "M":
            idx += 1
            continue
        w = rng.standard_normal((v, in_ch, 3, 3), dtype=np.float32)
        if kind == "init":
            w, b = 0.1 * w, np.zeros(v, np.float32)
        else:
            w = w * np.float32(np.sqrt(2.0 / (in_ch * 9)))
            b = 0.1 * rng.standard_normal(v, dtype=np.float32)
        sd[f"features.{idx}.weight"] = w
        sd[f"features.{idx}.bias"] = b
        idx, in_ch = idx + 2, v
    for i, c in enumerate((64, 128, 256, 512, 512)):
        sd[f"lin{i}.model.1.weight"] = (
            np.ones((1, c, 1, 1), np.float32) if kind == "init" else
            0.1 * rng.standard_normal((1, c, 1, 1), dtype=np.float32))
    return sd


@functools.lru_cache(maxsize=None)
def _models(noise_injection, draw="init0"):
    """(jax cfg, jax params, port generator, jax lpips params, port
    lpips).  With noise injection the noise weights are set non-zero
    (they init to 0), so the noise maps reach the image."""
    kw = dict(MODEL, layer_noise_injection=noise_injection)
    jcfg = JaxConfig(**kw)
    z0 = jnp.zeros((1, 16, MODEL["style_dim"]))
    params = JaxGenerator(jcfg).init({"params": jax.random.PRNGKey(0),
                                      "noise": jax.random.PRNGKey(1)}, z0, z0)
    flat = flatten_dict(jax.tree.map(np.asarray, params))
    for i, k in enumerate(sorted(k for k in flat if k[-1] == "noise_weight")):
        flat[k] = np.float32(0.2 + 0.1 * i)
    params = unflatten_dict(flat)
    cfg = ModelConfig(**kw)
    g = Generator(cfg, device="cpu")
    g.load_state_dict(generator_state_dict_from_jax(params, cfg),
                      strict=True)
    sd = _lpips_sd(draw)
    lp = LPIPS("vgg", device="cpu")
    lp.load_state_dict(load_lpips_params(sd, "vgg"), strict=True)
    return jcfg, params, g, jax_load_lpips(sd, "vgg"), lp



_ONCE = {}


def _once(fn):
    """``fn(jcfg, params, ...)`` computed once per process for each
    params tree (``_models`` keeps its trees for the process)."""
    @functools.wraps(fn)
    def wrapper(jcfg, params, *args):
        key = (fn.__name__, id(params), args)
        if key not in _ONCE:
            _ONCE[key] = fn(jcfg, params, *args)
        return _ONCE[key]
    return wrapper


@_once
def _target(jcfg, params, seed=3, b=2):
    z = jax.random.normal(jax.random.PRNGKey(seed), (b, 16, 32))
    p = jax.random.normal(jax.random.PRNGKey(seed + 1), (b, 16, 32))
    return np.asarray(JaxGenerator(jcfg).apply(
        params, z, p, rngs={"noise": jax.random.PRNGKey(seed + 2)}).image)


def _jax_draws(key, cfg, batch, steps):
    """What JAX ``project(..., key)`` draws: the initial noise maps and
    each step's latent noise."""
    _, k_noise, k_opt = jax.random.split(key, 3)
    noises = [np.asarray(jax.random.normal(jax.random.fold_in(k_noise, i), s))
              for i, s in enumerate(jp.make_noise_shapes(cfg, batch))]
    latent = [np.asarray(jax.random.normal(
        jax.random.fold_in(k_opt, step), (batch, 16, MODEL["style_dim"])))
        for step in range(steps)]
    return noises, latent


@_once
def _stats(jcfg, params, n=200, chunk=100):
    key = jax.random.PRNGKey(2)
    want = jp.estimate_latent_stats(jcfg, params, key, n_samples=n,
                                    chunk=chunk)
    draws = [tuple(np.asarray(t) for t in jax_sample_zp(
        jax.random.fold_in(key, i), chunk, 16, MODEL["style_dim"]))
        for i in range(n // chunk)]
    return want, draws


def _project_pair(models, optimize_noise):
    jcfg, params, g, jlp, lp = models
    target = _target(jcfg, params)
    (zm, zs, pm), _ = _stats(jcfg, params)
    key = jax.random.PRNGKey(5)
    pcfg_kw = dict(steps=STEPS, trace_every=1, optimize_noise=optimize_noise)
    want = jp.project(jcfg, params, jlp, jnp.asarray(target),
                      jp.ProjectorConfig(**pcfg_kw), key=key,
                      stats=(zm, zs, pm))
    noises, latent = _jax_draws(key, jcfg, target.shape[0], STEPS)
    stats = tuple(torch.from_numpy(np.array(s)) for s in (zm, zs, pm))
    got = tp.project(g, lp, target, tp.ProjectorConfig(**pcfg_kw),
                     stats=stats, noises=noises, latent_noise=latent,
                     device="cpu")
    return got, want


def _jax_objective(jcfg, pcfg):
    """(decode, value_and_grad) of the JAX package's projector objective
    (``loss_fn`` in ``transeditor_tpu/invert/projector.py``, local to its
    ``_projector_programs``, so rebuilt here from the same pieces):
    plus-space decode with step ``step``'s latent noise ``draw`` on z,
    LPIPS-vgg summed over the batch, the mse and the noise regulariser.
    ``pin``: the image the LPIPS and the mse see, exactly, while the
    gradient flows through the generator's own decode."""
    gen, lpips = JaxGenerator(jcfg), JaxLPIPS(net="vgg")

    def decode(params, opt_vars, draw, step, z_std):
        z = opt_vars["z"]
        if pcfg.optimize_noise:
            t = step / pcfg.steps
            strength = (z_std * pcfg.noise
                        * jnp.maximum(0.0, 1.0 - t / pcfg.noise_ramp) ** 2)
            z = z + draw * strength[None, None]
        return gen.apply(params, z, opt_vars["p"], map_z=False, map_p=False,
                         noise=opt_vars.get("noises")).image.astype(
                             jnp.float32)

    def loss(opt_vars, params, lpp, tgt, draw, step, z_std, pin):
        img = decode(params, opt_vars, draw, step, z_std)
        img = pin + (img - jax.lax.stop_gradient(img))
        p_loss = jnp.sum(lpips.apply(lpp, img, tgt))
        mse = jnp.mean((img - tgt) ** 2)
        total = p_loss + pcfg.mse_weight * mse
        n_loss = jnp.zeros(())
        if pcfg.optimize_noise:
            n_loss = jp.noise_regularize(opt_vars["noises"])
            total = total + pcfg.noise_regularize * n_loss
        return total, (p_loss, n_loss, mse)

    return jax.jit(decode), jax.jit(jax.value_and_grad(loss, has_aux=True))


def _relu_inputs(lp, img):
    """The inputs of the port VGG's ReLUs, up to its last tap."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
             for m in lp.backbone.features if isinstance(m, torch.nn.ReLU)]
    try:
        with torch.no_grad():
            lp.backbone(lp._scaled(img))
    finally:
        for h in hooks:
            h.remove()
    return seen


def _relu_sign_changes(lp, a, b):
    return sum(int(((x > 0) != (y > 0)).sum())
               for x, y in zip(_relu_inputs(lp, a), _relu_inputs(lp, b)))


def _port_step(models, target, opt_vars, adam, z_std, step, pcfg, draw,
               pin, monkeypatch):
    """The port's ``projector_step`` from a JAX state (``opt_vars`` and
    optax's Adam state ``adam``), with the image pinned to ``pin`` (None:
    the port's own).  Returns (its (perceptual, noise, mse), gradients,
    new vars, Adam's (first, second) moments, the port's own image)."""
    _, _, g, _, lp = models
    names = ["z", "p"] + (["noises"] if pcfg.optimize_noise else [])
    leaves = [ov for n in names for ov in (
        opt_vars[n] if n == "noises" else [opt_vars[n]])]
    mus = [m for n in names for m in (
        adam.mu[n] if n == "noises" else [adam.mu[n]])]
    nus = [v for n in names for v in (
        adam.nu[n] if n == "noises" else [adam.nu[n]])]
    tvars = [torch.tensor(np.array(v)).requires_grad_(True) for v in leaves]
    opt = torch.optim.Adam(tvars, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    for v, m, n in zip(tvars, mus, nus):
        opt.state[v] = {"step": torch.tensor(float(adam.count)),
                        "exp_avg": torch.tensor(np.array(m)),
                        "exp_avg_sq": torch.tensor(np.array(n))}
    own = []
    real = tp._decode

    def decode(*args):
        img = real(*args)
        own.append(img.detach().clone())
        if pin is None:
            return img
        return torch.from_numpy(pin) + (img - img.detach())

    with monkeypatch.context() as m:
        m.setattr(tp, "_decode", decode)
        with tp._frozen(g, lp):
            parts = tp.projector_step(g, lp, torch.from_numpy(target), opt,
                                      torch.tensor(np.array(z_std)), step,
                                      pcfg, draw)
    return ([float(x) for x in parts], [v.grad.numpy() for v in tvars],
            [v.detach().numpy() for v in tvars],
            [(opt.state[v]["exp_avg"].numpy(),
              opt.state[v]["exp_avg_sq"].numpy()) for v in tvars], own[0])


def _flat(tree, noise):
    return [tree["z"], tree["p"]] + (list(tree["noises"]) if noise else [])

