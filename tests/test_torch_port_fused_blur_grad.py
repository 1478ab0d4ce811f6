"""The backward of the port's ``fused_blur4`` vs JAX autodiff.

The reference is ``jax.vjp`` of the JAX package's unfused chain, as
``transeditor_tpu/ops/modconv.py:114-121`` runs it: the ``upfirdn2d``
blur, then the demodulation scale, bias and leaky ReLU.  The port's
backward (``ops/fused_blur.py::_FusedBlur4``) is the adjoint launch,
the recompute and two sums; on the CPU each launch is the plain
version, so this checks the backward's formulas themselves.  The card
holds the kernel-backed backward against the plain one
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).

Limit 1e-5 in float32, absolute, and relative for grad_scale and
grad_bias, which sum H*W (and B) products.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from transeditor_tpu.ops.act import fused_leaky_relu as jax_lrelu
from transeditor_tpu.ops.resample import upfirdn2d as jax_upfirdn2d

from transeditor_tpu_torch.ops import fused_blur

TAPS = tuple((np.asarray([1., 3., 3., 1.]) / 8.0 * 2.0).tolist())  # up gain
TOL = dict(rtol=1e-5, atol=1e-5)
EPILOGUES = {"none": (False, False, False), "scale": (True, False, False),
             "bias_act": (False, True, True),
             "scale_bias_act": (True, True, True)}


def _jax_chain(pad, use_s, use_b, act):
    k2 = jnp.asarray(np.outer(TAPS, TAPS), jnp.float32)

    def f(x, s, b):
        y = jax_upfirdn2d(x, k2, up=1, down=1, pad=pad)
        if use_s:
            y = y * s[:, None, None, :]
        if act:
            return jax_lrelu(y, b if use_b else None)
        return y + b if use_b else y
    return f


def _inputs(h, pad, seed, b=2, c=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, h, c).astype(np.float32)
    s = (rng.rand(b, c) + 0.5).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    ho = h + pad[0] + pad[1] - 3
    gy = rng.randn(b, ho, ho, c).astype(np.float32)
    return x, s, bias, gy


def _port(x, s, bias, use_s, use_b, act, pad):
    """Leaf tensors and the port's output."""
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(s).requires_grad_() if use_s else None
    bt = torch.from_numpy(bias).requires_grad_() if use_b else None
    y = fused_blur.fused_blur4(xt, TAPS, pad, scale=st, bias=bt, act=act)
    return xt, st, bt, y


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


@pytest.mark.parametrize("h", [9, 17, 33])
@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("pad", [(1, 1), (2, 1)])
def test_first_derivatives_match_jax(pad, epilogue, h):
    use_s, use_b, act = EPILOGUES[epilogue]
    x, s, bias, gy = _inputs(h, pad, seed=h)
    f = _jax_chain(pad, use_s, use_b, act)
    want_y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(s),
                          jnp.asarray(bias))
    want = vjp(jnp.asarray(gy))

    xt, st, bt, y = _port(x, s, bias, use_s, use_b, act, pad)
    _close(y, want_y, "y")
    leaves = [t for t in (xt, st, bt) if t is not None]
    got = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
    names = ["x"] + ["scale"] * use_s + ["bias"] * use_b
    wants = [want[0]] + [want[1]] * use_s + [want[2]] * use_b
    for name, g, w in zip(names, got, wants):
        _close(g, w, f"grad_{name}")


@pytest.mark.parametrize("epilogue", ["scale", "scale_bias_act"])
@pytest.mark.parametrize("pad", [(1, 1), (2, 1)])
def test_double_backward_matches_jax(pad, epilogue):
    """d<grad_x, v>/d(gy, scale, x), and the same of <grad_x, v> +
    <grad_scale, w> (which reaches x through the recompute)."""
    use_s, use_b, act = EPILOGUES[epilogue]
    x, s, bias, gy = _inputs(17, pad, seed=5)
    rng = np.random.RandomState(6)
    v = rng.randn(*x.shape).astype(np.float32)
    w = rng.randn(*s.shape).astype(np.float32)
    f = _jax_chain(pad, use_s, use_b, act)

    for with_scale_term in (False, True):
        def inner(gy_, s_, x_):
            _, vjp = jax.vjp(f, x_, s_, jnp.asarray(bias))
            gx, gs, _ = vjp(gy_)
            out = jnp.sum(gx * v)
            return out + jnp.sum(gs * w) if with_scale_term else out

        want = jax.grad(inner, argnums=(0, 1, 2))(
            jnp.asarray(gy), jnp.asarray(s), jnp.asarray(x))

        xt, st, bt, y = _port(x, s, bias, use_s, use_b, act, pad)
        gyt = torch.from_numpy(gy).requires_grad_()
        leaves = [t for t in (xt, st, bt) if t is not None]
        gx, gs = torch.autograd.grad(y, leaves, gyt, create_graph=True)[:2]
        out = (gx * torch.from_numpy(v)).sum()
        if with_scale_term:
            out = out + (gs * torch.from_numpy(w)).sum()
        got = torch.autograd.grad(out, [gyt, st, xt], allow_unused=True,
                                  materialize_grads=True)
        for name, g, wnt in zip(("gy", "scale", "x"), got, want):
            _close(g, wnt, f"{with_scale_term} d/d{name}")


def test_grad_routing_and_roles():
    """The Function runs only when autograd records: no-grad calls go
    straight to the blur; the CPU counts no launches in either case."""
    x = torch.randn(1, 9, 9, 4, requires_grad=True)
    s = torch.rand(1, 4) + 0.5
    y = fused_blur.fused_blur4(x, TAPS, scale=s, act=True)
    assert y.grad_fn is not None and "FusedBlur4" in type(y.grad_fn).__name__
    with torch.no_grad():
        assert fused_blur.fused_blur4(x, TAPS, scale=s).grad_fn is None
    with torch.inference_mode():
        assert fused_blur.fused_blur4(x, TAPS).grad_fn is None
    assert fused_blur.fused_blur4(x.detach(), TAPS).grad_fn is None
    before = fused_blur.launches.value
    y.sum().backward()
    assert fused_blur.launches.value == before
    assert x.grad is not None and math.isfinite(float(x.grad.sum()))


def test_launch_counter_counts_by_role():
    c = fused_blur.LaunchCounter()
    c.add("tma")
    c.add("tma", "adjoint")
    c.add("general", "recompute")
    c.add("tma", "adjoint")
    assert c.value == 4
    assert c.by_path == {"tma": 3, "general": 1}
    assert c.by_role == {"forward": 1, "adjoint": 2, "recompute": 1}
    assert c.by_role_path == {"forward": {"tma": 1}, "adjoint": {"tma": 2},
                              "recompute": {"general": 1}}
