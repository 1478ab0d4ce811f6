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

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from transeditor_tpu.train import ranger as jr

import torch_port_encoder_oracle as orc
from transeditor_tpu_torch.io import torch_export as te
from transeditor_tpu_torch.models import psp as tp
from transeditor_tpu_torch.train import ranger as tr

LR = 1e-2
STEPS = 20
CHECK = (1, 5, 6, 8, 20)
REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with orc.worker_threads():
        yield


@functools.lru_cache(maxsize=1)
def _tree(seed):
    """(JAX variables, port parameter name -> JAX params path) of the
    reduced encoder; the map comes from bridging a tree whose leaves
    are their own indices."""
    variables = orc.np_tree(orc.jax_encoder_vars(orc.reduced_sd(seed)))
    flat = flatten_dict(variables["params"])
    paths = list(flat)
    index = unflatten_dict({k: np.full(v.shape, i, np.float32)
                            for i, (k, v) in enumerate(flat.items())})
    sd = te.gradual_style_encoder_state_dict_from_jax(
        {"params": index, "batch_stats": variables["batch_stats"]})
    names = [n for n, _ in tp.GradualStyleEncoder(
        head_channels=orc.HEAD, **orc.REDUCED).named_parameters()]
    assert len(names) == len(paths)
    to_path = {n: paths[int(sd[n].flatten()[0])] for n in names}
    assert len(set(to_path.values())) == len(paths)
    return variables, to_path


def _port_encoder(variables):
    enc = tp.GradualStyleEncoder(head_channels=orc.HEAD, **orc.REDUCED)
    enc.load_state_dict(te.gradual_style_encoder_state_dict_from_jax(
        variables), strict=True)
    return enc


def _port_view(leaf) -> torch.Tensor:
    """A JAX CPU array as a torch view in the port's layout (HWIO ->
    OIHW, [in, out] -> [out, in]), sharing its memory."""
    t = torch.from_dlpack(leaf)
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    return t.T if t.dim() == 2 else t


@functools.lru_cache(maxsize=1)
def _grad_fn():
    @jax.jit
    def grads(a, b, c, d):
        return jax.tree.map(lambda x, y: x + c * y + d * x * y, a, b)
    return grads


def _grads(variables, seed):
    """Step t's gradient tree (JAX arrays, JAX layout): a + c_t * b +
    d_t * a * b for two fixed random trees a, b and per-step scalars,
    so the moments see gradients that change from step to step."""
    rng = np.random.default_rng(1000 + seed)
    a, b = (jax.device_put(jax.tree.map(
        lambda x: rng.standard_normal(x.shape, np.float32),
        variables["params"])) for _ in range(2))
    cs = rng.standard_normal((STEPS, 2))
    for c, d in cs.astype(np.float32):
        yield _grad_fn()(a, b, c, d)


def _set_grads(enc, grads, to_path):
    flat = flatten_dict(grads)
    for name, p in enc.named_parameters():
        p.grad = _port_view(flat[to_path[name]])


def _hold(got, params, to_path, step, what):
    """Each port tensor of ``got`` ({name: tensor}) within REL of the
    largest magnitude of JAX's (``params``, a JAX tree)."""
    flat = flatten_dict(params)
    for name, t in got.items():
        want = _port_view(flat[to_path[name]])
        err = ((t.detach() - want).abs().max() / want.abs().max()).item()
        assert err <= REL, f"step {step} {what} {name}: {err:.3e}"


@functools.lru_cache(maxsize=None)
def _jax_step(lookahead):
    jopt = jr.ranger(LR) if lookahead else jr.ranger_simple(LR)

    @jax.jit
    def step(params, state, g):
        upd, state = jopt.update(g, state, params)
        return optax.apply_updates(params, upd), state

    return jopt, step


@pytest.mark.parametrize("seed", orc.SEEDS)
def test_ranger_matches_optax_on_the_encoder_tree(seed):
    """``ranger_simple`` and ``ranger`` (Lookahead) side by side, each
    against its optax counterpart (jitted, as the JAX coach runs it), on
    the same 20 gradients."""
    variables, to_path = _tree(0)
    runs = {}
    for lookahead in (False, True):
        enc = _port_encoder(variables)
        jopt, jstep = _jax_step(lookahead)
        params = jax.device_put(variables["params"])
        if lookahead:
            params = optax.LookaheadParams.init_synced(params)
        opt = (tr.ranger if lookahead else tr.ranger_simple)(
            enc.parameters(), LR)
        runs[lookahead] = [enc, opt, jstep, params, jopt.init(params)]
    for t, g in enumerate(_grads(variables, seed), start=1):
        for lookahead, run in runs.items():
            enc, opt, jstep, params, state = run
            _set_grads(enc, g, to_path)
            opt.step()
            run[3], run[4] = params, state = jstep(params, state, g)
            if t in CHECK or (lookahead and t % 6 == 0):
                ps = dict(enc.named_parameters())
                if lookahead:
                    _hold(ps, params.fast, to_path, t, "fast")
                    _hold({n: opt.state[p]["slow"] for n, p in ps.items()},
                          params.slow, to_path, t, "slow")
                else:
                    _hold(ps, params, to_path, t, "ranger_simple")


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
