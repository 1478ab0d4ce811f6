"""Ranger: RAdam + Lookahead + gradient centralisation
(``transeditor_tpu/train/ranger.py``; reference ``pSp/training/ranger.py``).

The JAX package composes it from optax: ``centralize_gradients``, then
``optax.scale_by_radam`` (b1 0.95, b2 0.999, eps 1e-5), ``optax.scale(
-lr)``, and for ``ranger`` ``optax.lookahead`` (k 6, alpha 0.5).  This
optimizer reproduces that composition step for step:

* gradient centralisation: every parameter with more than one dimension
  has its gradient's mean over all dims but dim 0 (the output dim in
  torch's layouts) subtracted; the JAX package averages over all axes
  but the last, its output axis, which is the same statistic;
* RAdam as optax computes it under ``jit``: the moments ``(1 - b) * g +
  b * m``; the step count's ``b2 ** t``, rho_t and the rectifier r in
  float32 (0-dim CPU tensors, ``pow`` as ``powf``), where the float32
  cancellation in ``2 t b2^t / (1 - b2^t)`` puts rho_6 at 5.9747 against
  5.9942 in float64 (a rectifier 0.57% smaller); the rectified step ``r * m_hat / (sqrt(v_hat) + eps)`` when
  rho_t >= 5, else ``m_hat`` (steps 1-5);
* Lookahead (optax's update rule): the parameters are the fast weights;
  every k-th step the slow weights move by alpha toward the fast ones
  and the fast ones are set to them.

``torch.optim.RAdam`` differs: its eps sits inside the rectified
denominator's other side and its threshold test is rho_t > 5.
"""

from __future__ import annotations

import functools
from typing import Iterable

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


@functools.lru_cache(maxsize=64)
def radam_schedule(step: int, betas=(0.95, 0.999)):
    """(1 - b1^t, 1 - b2^t, r or None) for step ``t`` (1-based), in
    float32 as optax's ``scale_by_radam``; r is None where rho_t < 5
    (the unrectified branch).  Cached: every parameter of a step asks."""
    b1, b2 = betas
    t = _f32(float(step))
    bc1 = 1 - _f32(b1) ** t
    b2t = _f32(b2) ** t
    bc2 = 1 - b2t
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    ro = _f32(ro_inf) - _f32(float(2 * step)) * b2t / (1 - b2t)
    r = None
    if bool(ro >= 5.0):
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * _f32(ro_inf)
                       / (_f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        r = r.item()
    return bc1.item(), bc2.item(), r


class Ranger(torch.optim.Optimizer):
    """RAdam with gradient centralisation (``use_gc``) and, when
    ``lookahead``, Lookahead with sync period ``k`` and slow step
    ``alpha``.  ``state['step']`` counts updates of each parameter."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas=(0.95, 0.999), eps: float = 1e-5, k: int = 6,
                 alpha: float = 0.5, use_gc: bool = True,
                 lookahead: bool = True):
        if lr < 0:
            raise ValueError(f"lr must be >= 0, got {lr}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      k=k, alpha=alpha, use_gc=use_gc,
                                      lookahead=lookahead))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["use_gc"] and g.dim() > 1:
                    g = g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                    if group["lookahead"]:
                        state["slow"] = p.detach().clone()
                state["step"] += 1
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g * g * (1 - b2))
                bc1, bc2, r = radam_schedule(state["step"], (b1, b2))
                u = m / bc1
                if r is not None:
                    u.mul_(r).div_(torch.sqrt(v / bc2).add_(group["eps"]))
                u.mul_(-group["lr"])
                if group["lookahead"] and state["step"] % group["k"] == 0:
                    slow = state["slow"]
                    diff = p + u - slow
                    slow.add_(diff * group["alpha"])
                    u.sub_(diff.mul_(1 - group["alpha"]))
                p.add_(u)
        return loss


def ranger(params: Iterable, learning_rate: float = 1e-3,
           betas=(0.95, 0.999), eps: float = 1e-5, k: int = 6,
           alpha: float = 0.5, use_gc: bool = True) -> Ranger:
    """RAdam + gradient centralisation inside Lookahead."""
    return Ranger(params, learning_rate, betas, eps, k, alpha, use_gc,
                  lookahead=True)


def ranger_simple(params: Iterable, learning_rate: float = 1e-3,
                  betas=(0.95, 0.999), eps: float = 1e-5,
                  use_gc: bool = True) -> Ranger:
    """RAdam + gradient centralisation, no Lookahead (the coach's)."""
    return Ranger(params, learning_rate, betas, eps, use_gc=use_gc,
                  lookahead=False)
