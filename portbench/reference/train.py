"""Plain reference of one GAN training step: the StyleGAN2 recipe that
TransEditor trains with (non-saturating logistic losses, lazy R1 on the
discriminator, lazy path-length regularisation on the generator's styles,
Adam with the lazy-regularisation scaling of lr and betas, and an EMA of
the generator), on ``model.Generator`` and ``model.Discriminator``.

Adam is written out here.  The latents, the path-length noise and the real
images are passed in by the caller, which hands the same ones to the
program.  Only ``torch`` is imported.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F


class Adam:
    """Adam on a list of tensors: m, v, bias-corrected step."""

    def __init__(self, params, lr: float, betas, eps: float = 1e-8):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / c1 * m / ((v / c2).sqrt() + self.eps))


def lazy_adam(params, lr: float, every: int) -> Adam:
    r = every / (every + 1)
    return Adam(params, lr * r, (0.0 ** r, 0.99 ** r))


@dataclasses.dataclass
class State:
    g: torch.nn.Module
    d: torch.nn.Module
    g_ema: torch.nn.Module
    opt_g: Adam
    opt_d: Adam
    mean_path: torch.Tensor


def init(g, d, tcfg: dict) -> State:
    g_ema = copy.deepcopy(g).requires_grad_(False)
    return State(g, d, g_ema, lazy_adam(g.parameters(), tcfg["lr"],
                                        tcfg["g_reg_every"]),
                 lazy_adam(d.parameters(), tcfg["lr"], tcfg["d_reg_every"]),
                 torch.zeros((), device=next(g.parameters()).device))


def _grads(loss, params):
    got = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if x is None else x
            for p, x in zip(params, got)]


def step(st: State, real_u8: torch.Tensor, draws: dict, tcfg: dict,
         do_d_reg: bool, do_g_reg: bool, rows: slice | None = None) -> dict:
    """One step; returns the losses (detached scalars).  ``rows`` keeps only those
    rows of every batch (a fault for the checks: part of the batch left
    out, the mean taken over the rest)."""
    g, d = st.g, st.d
    pg, pd = list(g.parameters()), list(d.parameters())
    cut = (lambda t: t) if rows is None else (lambda t: t[rows])
    real = cut(real_u8).float() / 127.5 - 1.0
    out = {}

    zd, p_d = (cut(t) for t in draws["d"])
    with torch.no_grad():
        fake = g(zd, p_d)
    loss = F.softplus(-d(real)).mean() + F.softplus(d(fake)).mean()
    st.opt_d.step(_grads(loss, pd))
    out["d"] = loss.detach()

    if do_d_reg:
        r = real.detach().requires_grad_(True)
        grad, = torch.autograd.grad(d(r).sum(), r, create_graph=True)
        r1 = grad.pow(2).reshape(grad.shape[0], -1).sum(1).mean()
        st.opt_d.step(_grads(tcfg["r1_gamma"] / 2 * r1 * tcfg["d_reg_every"],
                             pd))
        out["r1"] = r1.detach()

    zg, p_g = (cut(t) for t in draws["g"])
    loss = F.softplus(-d(g(zg, p_g))).mean()
    st.opt_g.step(_grads(loss, pg))
    out["g"] = loss.detach()

    if do_g_reg:
        z, p, noise = (cut(t) for t in draws["path"])
        z_plus, p_plus = g.map_codes(z, p)
        latent = g.latents(z_plus, p_plus)
        img = g.synthesize(p_plus, latent)
        grad, = torch.autograd.grad((img * noise).sum(), latent,
                                    create_graph=True)
        lengths = torch.sqrt(grad.pow(2).sum(2).mean(1))
        path_mean = st.mean_path + 0.01 * (lengths.mean() - st.mean_path)
        penalty = (lengths - path_mean).pow(2).mean()
        st.opt_g.step(_grads(tcfg["path_regularize"] * tcfg["g_reg_every"]
                             * penalty, pg))
        st.mean_path = path_mean.detach()
        out["path"] = penalty.detach()

    decay = 0.5 ** (32.0 / (tcfg["ema_halflife_kimg"] * 1000.0))
    with torch.no_grad():
        for e, p in zip(st.g_ema.parameters(), pg):
            e.mul_(decay).add_(p, alpha=1 - decay)
    return out
