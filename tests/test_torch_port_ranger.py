"""The port's Ranger (``transeditor_tpu_torch/train/ranger.py``) against the
JAX package's optax composition (``transeditor_tpu/train/ranger.py``),
on the CPU in float32.

Over the reduced encoder's whole parameter tree (``torch_port_encoder_oracle``:
IR-SE-50 trunk, 3 + 16 heads; conv kernels, ``EqualLinear`` and Dense
weights, BN scales and shifts, PReLU slopes, biases) both optimizers take
the same 20 gradients; the parameters agree within 1e-6 of each tensor's
largest magnitude after steps 1, 5, 6, 8 and 20.  Steps 1-5 take RAdam's
unrectified branch and step 6 is the first rectified one, where optax's
float32 rho_t (5.9747 under jit, against 5.9942 in float64) makes the
rectifier 0.57% smaller than a float64 rho would: a port computing rho in
Python floats parts from JAX there by a few 1e-6 of a conv weight's
largest value.  With
Lookahead (``ranger``) the slow weights synchronise at steps 6, 12 and
18 and are held too.  Gradient centralisation is checked on the same
tree: each gradient with more than one dimension loses its mean over all
but the output dimension, which is dim 0 in the port and the last axis
in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transeditor_tpu.train import ranger as jr

import torch_port_encoder_oracle as orc
from torch_port_ranger_oracle import (LR, _grads, _hold, _port_encoder,
                                      _set_grads, _tree, run_seed)
from transeditor_tpu_torch.train import ranger as tr
from torch_port_threads import torch_worker_threads  # noqa: F401


# seeds 1 and 2 run in test_torch_port_ranger_seeds.py, on another worker
@pytest.mark.parametrize("seed", orc.SEEDS[:1])
def test_ranger_matches_optax_on_the_encoder_tree(seed):
    """``ranger_simple`` and ``ranger`` (Lookahead) side by side, each
    against its optax counterpart (jitted, as the JAX coach runs it), on
    the same 20 gradients."""
    run_seed(seed)


def test_gradient_centralisation_axes_on_the_encoder_tree():
    """Trap 3: every tensor of the tree with more than one dimension
    loses its mean over all dims but the output one (dim 0 here, the
    last axis in JAX); biases, BN scales and shifts and PReLU slopes are
    left alone."""
    variables, to_path = _tree(0)
    enc = _port_encoder(variables)
    g = next(_grads(variables, 0))
    gc = jr.centralize_gradients()
    want, _ = gc.update(g, gc.init(g))
    _set_grads(enc, g, to_path)
    centred = {}
    seen = {1: 0, 2: 0, 4: 0}
    for name, p in enc.named_parameters():
        got = p.grad
        if got.dim() > 1:
            got = got - got.mean(dim=tuple(range(1, got.dim())), keepdim=True)
        centred[name] = got
        seen[got.dim()] += 1
    assert all(seen.values()), seen
    _hold(centred, want, to_path, 0, "centralised")
    # the port's optimizer applies exactly that: with betas (0, 0.999)
    # its first step moves each parameter by -lr * GC(g)
    before = {n: p.detach().clone() for n, p in enc.named_parameters()}
    tr.Ranger(enc.parameters(), LR, betas=(0.0, 0.999),
              lookahead=False).step()
    for name, p in enc.named_parameters():
        moved = (p.detach() - before[name]) / -LR
        orc.assert_close(moved, centred[name], 1e-3, f"moved {name}")


def test_radam_schedule_is_optax_float32():
    """Trap 2: optax's rho_t and rectifier in float32, step by step, on a
    small parameter over 300 steps (every update within 1e-6 of jitted
    optax's).  Under jit, rho_6 is 5.9747 in float32 where float64 gives
    5.9942, so the rectifier is 0.57% smaller (0.60% at step 7, 0.42% at
    step 8); optax run eagerly takes 0.999 ** 6 one ulp higher and gets
    5.9548."""
    rng = np.random.default_rng(0)
    gs = rng.standard_normal((300, 5)).astype(np.float32)
    jopt = optax.scale_by_radam(b1=0.95, b2=0.999, eps=1e-5)
    state = jopt.init(jnp.zeros(5))
    update = jax.jit(jopt.update)
    p = torch.zeros(5, requires_grad=True)
    opt = tr.Ranger([p], lr=1.0, use_gc=False, lookahead=False)
    for t, g in enumerate(gs, start=1):
        u, state = update(jnp.asarray(g), state)
        with torch.no_grad():
            p.zero_()                    # so p after the step is -update
        p.grad = torch.from_numpy(g)
        opt.step()
        orc.assert_close(-p.detach(), np.asarray(u), 1e-6, f"update {t}")
    t, ro_inf = 6, 2 / (1 - 0.999) - 1
    ro64 = ro_inf - 2 * t * 0.999 ** t / (1 - 0.999 ** t)
    assert abs(ro64 - 5.9942) < 1e-4

    @jax.jit
    def rho_r(count):
        """optax's expressions, jitted as the JAX coach's step is (eager
        jnp takes another pow for an integer exponent: 1 ulp of b2^t
        apart at some counts, which moves rho_6 by 0.02)."""
        b2t = 0.999 ** count
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        return ro, jnp.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                            / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))

    ro32, r32 = rho_r(jnp.asarray(t, jnp.int32))
    assert abs(float(ro32) - 5.9747) < 1e-4
    eager = 0.999 ** jnp.asarray(t, jnp.int32)
    assert abs(float(ro_inf - 2 * t * eager / (1 - eager)) - 5.9548) < 1e-4
    assert tr.radam_schedule(5)[2] is None
    r6 = tr.radam_schedule(6)[2]
    assert r6 == float(r32)
    r64 = np.sqrt((ro64 - 4) * (ro64 - 2) * ro_inf
                  / ((ro_inf - 4) * (ro_inf - 2) * ro64))
    assert abs(r6 / r64 - (1 - 0.0057)) < 2e-4, r6 / r64
