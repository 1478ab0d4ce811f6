"""The port's train step vs the JAX package: the spatial path
regulariser in P+ and in P, and gradient accumulation.

Same weights, batch and draws as ``test_torch_port_train_step.py``, with
the tolerances of ``torch_port_train_oracle.py``.  ``grad_accum=2`` is
held against the JAX step with ``grad_accum=2`` (whose own test,
``tests/test_train_step.py``, pins it to the mean of the two microbatch
gradients) and against the port's own mean of two microbatch steps.
"""

import numpy as np
import pytest
import torch

import torch_port_train_oracle as oracle
from torch_port_threads import torch_worker_threads  # noqa: F401


@pytest.mark.parametrize("space", ["p+", "p"])
def test_spatial_step_matches_jax(space):
    jstate, jstep, state, step, cfg, tcfg = oracle.setup(
        spatial_regu=True, regu_space=space)
    jnew, jm, new, m = oracle.run_both(jstate, jstep, state, step, cfg, tcfg,
                                       do_spatial_reg=True)
    oracle.assert_step_matches(jnew, jm, new, m, cfg, tcfg)
    assert float(m["spatial_path_length"]) > 0
    assert float(new.mean_spatial_path_length) != 0


def test_grad_accum_matches_jax():
    """Batch 8 in two microbatches of 4.  At microbatches of 2 the
    minibatch-stddev group is 2, and the second derivative of
    sqrt(var + 1e-8) over two samples amplifies rounding in R1's small
    bias gradients to ~1e-2 of their magnitude, in either framework."""
    jstate, jstep, state, step, cfg, tcfg = oracle.setup(batch_size=8,
                                                         grad_accum=2)
    jnew, jm, new, m = oracle.run_both(jstate, jstep, state, step, cfg, tcfg,
                                       do_d_reg=True)
    oracle.assert_step_matches(jnew, jm, new, m, cfg, tcfg)


def test_grad_accum_is_the_mean_of_microbatch_gradients():
    """K=2 applies the mean of the two microbatch gradients: with beta1
    = 0 the D first moment after the step is exactly that mean, which
    two one-microbatch D losses give."""
    from transeditor_tpu_torch.train import losses

    _, _, state, step, cfg, tcfg = oracle.setup(grad_accum=2)
    d0 = {k: v.clone() for k, v in state.d.state_dict().items()}
    real = torch.from_numpy(oracle.real_batch()).float() / 127.5 - 1.0
    rng = np.random.RandomState(3)
    z, p = (torch.from_numpy(rng.randn(4, 16, 32).astype(np.float32))
            for _ in range(2))
    draws = {"d": (z, p), "g": (z, p)}

    params = list(state.d.parameters())
    want = []
    for sl in (slice(0, 2), slice(2, 4)):
        with torch.no_grad():
            fake = state.g(z[sl], p[sl]).image
        loss = losses.d_logistic_loss(state.d(real[sl]), state.d(fake))
        want.append(torch.autograd.grad(loss, params))
    new, _ = step(state, real, torch.Generator(), draws=draws)
    for prm, a, b in zip(params, *want):
        got = new.opt_d.state[prm]["exp_avg"]
        torch.testing.assert_close(got, (a + b) / 2, rtol=1e-5, atol=1e-8)
    assert any(not torch.equal(d0[k], v)
               for k, v in new.d.state_dict().items())

    bad = oracle.make_train_step(cfg, oracle.TrainConfig(batch_size=4,
                                                         grad_accum=3),
                                 device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        bad(state, real, torch.Generator(), draws=draws)
