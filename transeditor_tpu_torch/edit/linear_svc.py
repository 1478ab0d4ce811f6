"""A linear C-SVC solved in torch, on the device: the fit that
``transeditor_tpu/edit/boundary.py`` leaves to ``sklearn.svm.SVC(
kernel="linear")`` (libsvm), without scikit-learn.

The problem is libsvm's C-SVC with a linear kernel and an unregularised
intercept.  For labels y in {+1, -1} its dual is

    min_a  1/2 a^T Q a - 1^T a    s.t.  0 <= a_t <= C,  y^T a = 0,
    Q = (y y^T) * (X X^T),

solved here as libsvm solves it: SMO (two variables a step) with the
second-order working-set selection of Fan, Chen and Lin (JMLR 2005), on
the precomputed Gram matrix ``X X^T`` in float64 (``torch.matmul``; 141
MB at the editing protocol's 4,200 training rows), without shrinking.
The device holds ``v = -y * G`` (G the dual's gradient) and the sets
I_up / I_low as rows of 0 / inf penalties; the dual variables live on the
host, where libsvm's two-variable update runs in float64.  A step selects
i on the device and fetches it, selects j and fetches six scalars (two
synchronisations, about 17 small launches), and updates ``v`` by two
rows of the Gram matrix: on the card the loop is bound by the host's
launches, not by the device.  It stops when the maximal KKT violation
``m(a) - M(a)`` is below ``tol`` (libsvm's ``eps``, 1e-3 by default; here
1e-6).  The primal normal ``w = sum_t a_t y_t x_t`` is unique, so a fit
this tight meets libsvm's to within libsvm's own tolerance.

The intercept is libsvm's: ``b = -rho`` with ``rho`` the mean of
``y_t G_t`` over the free support vectors (0 < a_t < C), or the middle of
its feasible interval when none is free.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from transeditor_tpu_torch.device import resolve_device

C = 1.0                     # the box, sklearn's SVC default
TAU = 1e-12                 # libsvm's floor on a non-positive curvature


@dataclasses.dataclass
class LinearSVC:
    """A fitted linear C-SVC: decision ``x @ coef + intercept`` (float64
    tensors on the fit's device); positive means the +1 class."""

    coef: torch.Tensor          # [D]
    intercept: float
    alpha: torch.Tensor         # [N] dual variables
    iterations: int
    kkt_gap: float              # m(a) - M(a) at the stop

    def decision_function(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.coef.device).to(torch.float64)
        return x @ self.coef + self.intercept

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """1 where the decision is positive, else 0 (the labels of
        ``boundary.train_boundary``)."""
        return (self.decision_function(x) > 0).to(torch.int64)


def _rho(y, grad, alpha) -> float:
    """libsvm's ``Solver::calculate_rho``."""
    yg = y * grad
    upper, lower = alpha >= C, alpha <= 0
    free = ~(upper | lower)
    if bool(free.any()):
        return float(yg[free].mean())
    pos = y > 0
    # bounded variables bound rho from above (ub) and below (lb)
    ub_mask = (upper & ~pos) | (lower & pos)
    lb_mask = (upper & pos) | (lower & ~pos)
    ub = float(yg[ub_mask].min()) if bool(ub_mask.any()) else math.inf
    lb = float(yg[lb_mask].max()) if bool(lb_mask.any()) else -math.inf
    return (ub + lb) / 2


def _two_variable_step(yi, yj, ai, aj, gi, gj, kii, kjj, kij):
    """libsvm's analytic update of (a_i, a_j) under the box and the
    equality constraint (``Solver::Solve``, C_i = C_j = C)."""
    if yi != yj:
        quad = kii + kjj + 2 * (yi * yj * kij)
        quad = quad if quad > 0 else TAU
        delta = (-gi - gj) / quad
        diff = ai - aj
        ai, aj = ai + delta, aj + delta
        if diff > 0:
            if aj < 0:
                aj, ai = 0.0, diff
        elif ai < 0:
            ai, aj = 0.0, -diff
        if diff > 0:                      # C_i - C_j == 0
            if ai > C:
                ai, aj = C, C - diff
        elif aj > C:
            aj, ai = C, C + diff
    else:
        quad = kii + kjj - 2 * (yi * yj * kij)
        quad = quad if quad > 0 else TAU
        delta = (gi - gj) / quad
        total = ai + aj
        ai, aj = ai - delta, aj + delta
        if total > C:
            if ai > C:
                ai, aj = C, total - C
        elif aj < 0:
            aj, ai = 0.0, total
        if total > C:
            if aj > C:
                aj, ai = C, total - C
        elif ai < 0:
            ai, aj = 0.0, total
    return ai, aj


def fit_linear_svc(x, labels, tol: float = 1e-6,
                   device: str | torch.device | None = None) -> LinearSVC:
    """Fit a linear C-SVC (C = 1) to rows ``x`` [N, D] with 0/1
    ``labels`` [N] (1 is the positive class) on ``device`` (default
    cuda).  Raises ``RuntimeError`` if libsvm's bound of
    ``max(10_000_000, 100 N)`` steps does not reach ``tol``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev, torch.float64)
    y = torch.as_tensor(labels).to(dev, torch.float64) * 2 - 1
    n = x.shape[0]
    if n < 2 or not bool((y > 0).any()) or not bool((y < 0).any()):
        raise ValueError("fit_linear_svc needs rows of both classes")
    max_iter = max(10_000_000, 100 * n)
    gram = x @ x.T
    diag = gram.diagonal().clone()
    diag_host, y_host = diag.tolist(), y.tolist()
    alpha = [0.0] * n
    # v = -y * G, G = Q a - 1 the dual's gradient (-1 at a = 0); pen[0]
    # is 0 on I_up (a_t can move so that y_t a_t grows), -inf elsewhere;
    # pen[1] is 0 on I_low (... so that it shrinks), +inf elsewhere
    v = y.clone()
    pos = y > 0
    pen = torch.stack([torch.where(pos, 0.0, -math.inf),
                       torch.where(pos, math.inf, 0.0)])

    def place(t):
        """(pen[0][t], pen[1][t]) of a_t."""
        up = alpha[t] < C if y_host[t] > 0 else alpha[t] > 0
        low = alpha[t] > 0 if y_host[t] > 0 else alpha[t] < C
        return 0.0 if up else -math.inf, 0.0 if low else math.inf

    it = 0
    while True:
        g_max, i = (v + pen[0]).max(0)
        g_min = (v + pen[1]).min()
        i = int(i)
        # second-order selection of j among I_low with v_t < m(a): the
        # least -b^2 / a (b <= 0 gives 0, never below a candidate's); a
        # PSD Gram matrix gives a >= 0, floored at TAU as libsvm floors
        # a <= 0
        b = torch.sub(g_max, v).clamp_min_(0.0)
        a = torch.add(diag, gram[i], alpha=-2.0).add_(diag_host[i])
        obj_j, j = torch.addcdiv(pen[1], b.square_(), a.clamp_min_(TAU),
                                 value=-1.0).min(0)
        gap, obj_j, j, vi, vj, kij = torch.stack([
            g_max - g_min, obj_j, j.to(torch.float64), v[i], v[j],
            gram[i][j]]).tolist()
        if gap < tol or obj_j >= 0:
            break
        if it >= max_iter:
            raise RuntimeError(f"fit_linear_svc: KKT gap {gap:.3e} after "
                               f"{it} steps (tol {tol:g})")
        j = int(j)
        yi, yj = y_host[i], y_host[j]
        ai_old, aj_old = alpha[i], alpha[j]
        alpha[i], alpha[j] = _two_variable_step(
            yi, yj, ai_old, aj_old, -yi * vi, -yj * vj, diag_host[i],
            diag_host[j], kij)
        # v -= y * (Q[:, i] da_i + Q[:, j] da_j), Q[:, t] = y y_t K[t]
        v.sub_(gram[i], alpha=yi * (alpha[i] - ai_old))
        v.sub_(gram[j], alpha=yj * (alpha[j] - aj_old))
        for t, old in ((i, ai_old), (j, aj_old)):
            if (old > 0, old < C) != (alpha[t] > 0, alpha[t] < C):
                pen[0][t], pen[1][t] = place(t)
        it += 1

    alpha_t = torch.tensor(alpha, dtype=torch.float64, device=dev)
    coef = (alpha_t * y) @ x
    return LinearSVC(coef=coef, intercept=-_rho(y, -y * v, alpha_t),
                     alpha=alpha_t, iterations=it, kkt_gap=gap)
