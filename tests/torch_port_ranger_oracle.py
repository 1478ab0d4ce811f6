"""Shared pieces of the Ranger parity tests
(``test_torch_port_ranger{,_seeds}.py``): the reduced encoder's tree on
both sides, the map between their names, the per-step gradients and the
comparison (what is held, and why, is in ``test_torch_port_ranger.py``'s
docstring).  One seed's run of both optimizers is ``run_seed``.
"""

import functools

import jax
import numpy as np
import optax
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


def run_seed(seed):
    """``ranger_simple`` and ``ranger`` (Lookahead) side by side, each
    against its optax counterpart (jitted, as the JAX coach runs it), on
    seed ``seed``'s 20 gradients."""
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
