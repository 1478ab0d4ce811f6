"""One whole train step of the port vs the JAX package, per lazy
regularisation variant (do_d_reg, do_g_reg) in {F, T}^2.

Same weights, same uint8 batch, same latents and path noise (drawn by
JAX's key sequence, passed to the port as ``draws=``); float32 on the
CPU.  Tolerances are stated in ``torch_port_train_oracle.py``: metrics
rtol 1e-4, each phase's gradients (as Adam's first moments) 1e-4 of the
tensor's largest magnitude + 1e-8, parameters and g_ema within 0.1 * lr.
"""

import pytest

import torch_port_train_oracle as oracle


@pytest.mark.parametrize("do_d_reg,do_g_reg", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_step_matches_jax(do_d_reg, do_g_reg):
    jstate, jstep, state, step, cfg, tcfg = oracle.setup()
    jnew, jm, new, m = oracle.run_both(jstate, jstep, state, step, cfg, tcfg,
                                       do_d_reg=do_d_reg, do_g_reg=do_g_reg)
    oracle.assert_step_matches(jnew, jm, new, m, cfg, tcfg)
    if do_d_reg:
        assert float(m["r1"]) > 0
    if do_g_reg:
        assert float(m["path_length"]) > 0
        assert float(new.mean_path_length) != 0
