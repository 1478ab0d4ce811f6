"""Shared helpers of the train-step parity tests: one JAX ``train_step``
and the port's ``train_step`` from the same weights and the same draws.

The JAX package is the oracle.  Its ``init_state`` weights (params_g,
params_d, g_ema) go through the port's weight bridge into the port's
``init_state`` modules; the latents and path-noise images the JAX step
draws are derived here with the same ``jax.random.split`` sequence as
``transeditor_tpu/train/gan.py`` (:265, :174-175, :193-194, :322-326,
:341-344) and handed to the port as ``draws=``.

Tolerances (float32 on the CPU; the two frameworks sum in other
orders, and a regulariser's second-order gradient amplifies that):
  - losses and metrics: rtol 1e-4, atol 1e-5;
  - each phase's gradients, compared as Adam's first moments (beta1 is
    0, so the moment after the step is the gradient of the optimizer's
    last phase): 1e-4 of the tensor's largest magnitude, plus 1e-8 for
    the gradients that are 0 in exact arithmetic (an attention key bias:
    softmax ignores a shift) and come out as ~1e-11 noise in both;
  - parameters and g_ema after the step: 0.1 * lr.  Adam divides by
    |g| + 1e-8, so a parameter whose gradient is near 0 can move by a
    fraction of lr either way on tiny differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.config import TrainConfig as JaxTrainConfig
from transeditor_tpu.train.gan import init_state as jax_init_state
from transeditor_tpu.train.gan import make_train_step as jax_make_train_step
from transeditor_tpu.train.losses import path_noise as jax_path_noise
from transeditor_tpu.utils.sampling import sample_zp as jax_sample_zp

from transeditor_tpu_torch.config import ModelConfig, TrainConfig
from transeditor_tpu_torch.io.torch_export import (
    discriminator_state_dict_from_jax, generator_state_dict_from_jax)
from transeditor_tpu_torch.train.gan import init_state, make_train_step

MODEL = dict(size=16, style_dim=32, param_dim=32, max_channels=32, n_trans=1)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-4          # of each tensor's largest magnitude ...
GRAD_ABS = 1e-8          # ... plus this
PARAM_LR = 0.1           # parameters within PARAM_LR * lr


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def setup(seed=0, **train_kw):
    """(jax state, jax step, port state, port step, cfg, tcfg)."""
    train_kw = {"batch_size": 4, **train_kw}
    jstate = jax_init_state(JaxConfig(**MODEL), JaxTrainConfig(**train_kw),
                            jax.random.PRNGKey(seed))
    jstep = jax_make_train_step(JaxConfig(**MODEL),
                                JaxTrainConfig(**train_kw))
    cfg, tcfg = ModelConfig(**MODEL), TrainConfig(**train_kw)
    state = init_state(cfg, tcfg, device="cpu")
    state.g.load_state_dict(generator_state_dict_from_jax(
        np_tree(jstate.params_g), cfg), strict=True)
    state.g_ema.load_state_dict(generator_state_dict_from_jax(
        np_tree(jstate.g_ema), cfg), strict=True)
    state.d.load_state_dict(discriminator_state_dict_from_jax(
        np_tree(jstate.params_d), cfg), strict=True)
    return jstate, jstep, state, make_train_step(cfg, tcfg, device="cpu"), \
        cfg, tcfg


def real_batch(seed=1, b=4, size=16):
    return np.random.RandomState(seed).randint(
        0, 256, (b, size, size, 3)).astype(np.uint8)


def draws_from_jax(rng, cfg, tcfg, batch):
    """The latents and path-noise images ``train_step(..., rng)`` draws,
    as torch tensors, keyed as the port's ``draws=``."""
    n = cfg.n_tokens
    k_d, k_g, k_path, k_pnoise, k_sp, k_spn = jax.random.split(rng, 6)
    k_accum = max(1, tcfg.grad_accum)
    micro = batch // k_accum

    def zp(key, b):
        return jax_sample_zp(jax.random.split(key)[0], b, n, cfg.style_dim)

    def phase_zp(key):
        if k_accum == 1:
            return zp(key, batch)
        parts = [zp(k, micro) for k in jax.random.split(key, k_accum)]
        return tuple(jnp.concatenate(t) for t in zip(*parts))

    path_b = max(1, batch // tcfg.path_batch_shrink)
    shape = (path_b, cfg.size, cfg.size, 3)
    out = {"d": phase_zp(k_d), "g": phase_zp(k_g),
           "path": (*zp(k_path, path_b), jax_path_noise(k_pnoise, shape)),
           "spatial": (*zp(k_sp, path_b), jax_path_noise(k_spn, shape))}
    return {k: tuple(torch.from_numpy(np.array(t)) for t in v)
            for k, v in out.items()}


def run_both(jstate, jstep, state, step, cfg, tcfg, seed=2, **flags):
    """One step of each from the same state and draws: (jax state, jax
    metrics, port state, port metrics)."""
    real = real_batch(b=tcfg.batch_size)
    rng = jax.random.PRNGKey(seed)
    jnew, jm = jstep(jstate, jnp.asarray(real), rng, **flags)
    draws = draws_from_jax(rng, cfg, tcfg, real.shape[0])
    new, m = step(state, torch.from_numpy(real), torch.Generator(),
                  draws=draws, **flags)
    return jnew, jm, new, m


def assert_metrics_close(jm, m):
    assert set(jm) == set(m)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)


def moments(opt, module):
    by_param = {p: opt.state[p]["exp_avg"] for p in module.parameters()}
    return {name: by_param[p] for name, p in module.named_parameters()}


def assert_trees_close(want_sd, got, module, tol_fn, what):
    """Each parameter of ``module``: |got - want| <= tol_fn(want)."""
    for name, _ in module.named_parameters():
        want = want_sd[name].numpy()
        diff = np.abs(got[name].detach().numpy() - want).max()
        tol = tol_fn(want)
        assert diff <= tol, f"{what} {name}: {diff} > {tol}"


def assert_step_matches(jnew, jm, new, m, cfg, tcfg):
    """Metrics, first moments of both optimizers, parameters and g_ema."""
    assert_metrics_close(jm, m)
    assert new.step == int(jnew.step) == 1
    np.testing.assert_allclose(float(new.mean_path_length),
                               float(jnew.mean_path_length), **METRIC_TOL)
    np.testing.assert_allclose(float(new.mean_spatial_path_length),
                               float(jnew.mean_spatial_path_length),
                               **METRIC_TOL)

    def grad_tol(want):
        return GRAD_REL * np.abs(want).max() + GRAD_ABS

    to_g = lambda t: generator_state_dict_from_jax(np_tree(t), cfg)  # noqa
    to_d = lambda t: discriminator_state_dict_from_jax(np_tree(t), cfg)  # noqa
    assert_trees_close(to_g(jnew.opt_g[0].mu), moments(new.opt_g, new.g),
                       new.g, grad_tol, "G first moment")
    assert_trees_close(to_d(jnew.opt_d[0].mu), moments(new.opt_d, new.d),
                       new.d, grad_tol, "D first moment")

    g_ratio = tcfg.g_reg_every / (tcfg.g_reg_every + 1)
    d_ratio = tcfg.d_reg_every / (tcfg.d_reg_every + 1)
    g_tol = lambda want: PARAM_LR * tcfg.lr * g_ratio  # noqa: E731
    d_tol = lambda want: PARAM_LR * tcfg.lr * d_ratio  # noqa: E731
    assert_trees_close(to_g(jnew.params_g), new.g.state_dict(), new.g,
                       g_tol, "G parameter")
    assert_trees_close(to_g(jnew.g_ema), new.g_ema.state_dict(), new.g_ema,
                       g_tol, "g_ema parameter")
    assert_trees_close(to_d(jnew.params_d), new.d.state_dict(), new.d,
                       d_tol, "D parameter")
