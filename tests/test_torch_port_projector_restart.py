"""Five free-running steps of the port's projector on the LPIPS draws
other than seed 0: JAX's result is one of the port's own rounding
restarts (``test_torch_port_projector.py``'s docstring says why; the
shared pieces are in ``torch_port_projector_oracle.py``)."""

import jax
import numpy as np
import pytest
import torch

from transeditor_tpu_torch.invert import projector as tp
from torch_port_projector_oracle import (RESTART_REL, RESTARTS, STEPS,
                                         _jax_draws, _models,
                                         _project_pair, _stats, _target)
from torch_port_threads import torch_worker_threads  # noqa: F401


@pytest.mark.parametrize("optimize_noise", [False, True])
@pytest.mark.parametrize("draw", ["init1", "he0"])
def test_free_running_gap_is_a_rounding_restart(draw, optimize_noise):
    """Five free-running steps on the draws other than seed 0: JAX's z+,
    p+ and image lie within RESTART_REL of their largest magnitudes of
    the port's own 5-step result from one of RESTARTS, the same start or
    one (z+, p+) changed by a float32 rounding or two, although JAX and
    the port from the same start may be far further apart (seed 1
    without latent noise, 2e-2)."""
    models = _models(optimize_noise, draw)
    jcfg, params, g, _, lp = models
    got, want = _project_pair(models, optimize_noise)
    target = _target(jcfg, params)
    (zm, zs, pm), _ = _stats(jcfg, params)
    noises, latent = _jax_draws(jax.random.PRNGKey(5), jcfg,
                                target.shape[0], STEPS)
    pcfg = tp.ProjectorConfig(steps=STEPS, optimize_noise=optimize_noise)
    keys = ("z_plus", "p_plus", "image")

    def apart(a, b):
        return max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
                   for k in keys)

    gaps = {}
    for d in RESTARTS:
        stats = (torch.from_numpy(np.array(zm)) * (1.0 + d),
                 torch.from_numpy(np.array(zs)),
                 torch.from_numpy(np.array(pm)) * (1.0 + d))
        out = tp.project(g, lp, target, pcfg, stats=stats, noises=noises,
                         latent_noise=latent, device="cpu")
        gaps[d] = apart(out, want)
    assert gaps[0.0] == apart(got, want)
    assert min(gaps.values()) <= RESTART_REL, gaps

