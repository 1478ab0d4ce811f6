"""The port's projector step by step against the JAX package's, from
JAX's state along its 5-step trajectory, on the three LPIPS draws and in
both noise modes (``test_torch_port_projector.py``'s docstring says
what agrees and why; the shared pieces are in
``torch_port_projector_oracle.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transeditor_tpu.invert import projector as jp

from transeditor_tpu_torch.invert import projector as tp
from torch_port_projector_oracle import (DRAWS, STEP_REL, STEPS,
                                         UNPINNED_REL, _flat, _jax_draws,
                                         _jax_objective, _models,
                                         _port_step, _rel,
                                         _relu_sign_changes, _stats,
                                         _target)
from torch_port_threads import torch_worker_threads  # noqa: F401


@pytest.mark.parametrize("optimize_noise", [False, True])
@pytest.mark.parametrize("draw", list(DRAWS))
def test_each_step_matches_jax_from_its_state(draw, optimize_noise,
                                              monkeypatch):
    """Along JAX's 5-step trajectory, each step from JAX's state: the
    port's objective and its gradients in z+, p+ and the maps against
    ``jax.value_and_grad`` of the JAX objective, and the port's Adam
    update (vars, both moments) against optax's, all within STEP_REL of
    each tensor's largest magnitude, with the LPIPS image pinned to
    JAX's on both sides.  Unpinned, the gradients agree as closely unless
    a VGG ReLU input changes sign between the two images.  Step 0 of the
    JAX objective is first held to the package's own ``project`` trace
    (a value, so no kink can part them) within 1e-6."""
    models = _models(optimize_noise, draw)
    jcfg, params, _, jlp, lp = models
    target = _target(jcfg, params)
    (zm, zs, pm), _ = _stats(jcfg, params)
    kw = dict(steps=STEPS, trace_every=1, optimize_noise=optimize_noise)
    jpc, pcfg = jp.ProjectorConfig(**kw), tp.ProjectorConfig(**kw)
    decode, value_and_grad = _jax_objective(jcfg, jpc)
    opt = jp._projector_programs(jcfg, jpc)[2]     # the package's Adam
    key = jax.random.PRNGKey(5)
    noises, latent = _jax_draws(key, jcfg, target.shape[0], STEPS)
    ov = {"z": jnp.broadcast_to(zm[None], (2, *zm.shape)),
          "p": jnp.broadcast_to(pm[None], (2, *pm.shape))}
    if optimize_noise:
        ov["noises"] = [jnp.asarray(n) for n in noises]
    ost = opt.init(ov)
    tgt = jnp.asarray(target)
    package = jp.project(jcfg, params, jlp, tgt, jpc, key=key,
                         stats=(zm, zs, pm))
    for step in range(STEPS):
        draw_k = jnp.asarray(latent[step])
        img = decode(params, ov, draw_k, step, zs)
        (_, parts), grads = value_and_grad(ov, params, jlp, tgt, draw_k,
                                           step, zs, img)
        parts = [float(x) for x in parts]
        if step == 0:
            for name, i in (("perceptual", 0), ("noise", 1), ("mse", 2)):
                want = float(package[f"{name}_trace"][0])
                assert abs(parts[i] - want) <= 1e-6 * abs(want), name
        tag = f"{draw} step {step}"
        got = _port_step(models, target, ov, ost[0], zs, step, pcfg,
                         latent[step], np.asarray(img), monkeypatch)
        np.testing.assert_allclose(got[0], parts, rtol=STEP_REL,
                                   atol=1e-12, err_msg=tag)
        jgrads = _flat(grads, optimize_noise)
        for i, (a, b) in enumerate(zip(got[1], jgrads)):
            _rel(a, b, STEP_REL, f"{tag} gradient {i}")
        own = _port_step(models, target, ov, ost[0], zs, step, pcfg,
                         latent[step], None, monkeypatch)
        err = max(float(np.abs(a - np.asarray(b)).max()
                        / np.abs(np.asarray(b)).max())
                  for a, b in zip(own[1], jgrads))
        if err > UNPINNED_REL:
            flips = _relu_sign_changes(lp, own[4], torch.from_numpy(
                np.asarray(img)))
            assert flips > 0, f"{tag}: unpinned gradients {err} apart"
        updates, ost = opt.update(grads, ost, ov)
        ov = optax.apply_updates(ov, updates)
        if optimize_noise:
            ov = dict(ov, noises=jp.noise_normalize(ov["noises"]))
        for i, (a, b) in enumerate(zip(got[2], _flat(ov, optimize_noise))):
            _rel(a, b, STEP_REL, f"{tag} var {i}")
        for i, ((m, v), jm, jv) in enumerate(zip(
                got[3], _flat(ost[0].mu, optimize_noise),
                _flat(ost[0].nu, optimize_noise))):
            _rel(m, jm, STEP_REL, f"{tag} first moment {i}")
            _rel(v, jv, STEP_REL, f"{tag} second moment {i}")

