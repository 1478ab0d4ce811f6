"""One bfloat16 train step of the port against the JAX package's bfloat16
step, on the CPU: the lazy-regularisation variants plain, R1, path
length, R1 + path length and the spatial regulariser.

Both compute in bfloat16 over float32 parameters (``ModelConfig(dtype=
"bfloat16")``), from the same weights and the same draws
(``torch_port_train_oracle``), at lr 0 so that every phase of both steps
starts from the same weights.  bfloat16 keeps 8 significant bits, and
the two frameworks round in other places (a convolution's sum, a fused
chain), so the steps cannot agree to float32 tolerances.  The limit is
what bfloat16 rounding alone does to the JAX step (the method of
``chip_smoke.py::train_card_vs_cpu``): a second JAX step whose inputs
lie one bfloat16 ulp away, the real images scaled by ``1 + 2**-8`` and
each latent element by ``1 +- 2**-8`` with a seeded sign (the mapping's
PixelNorm cancels a uniform scale, which left the generator's side of
that floor at exactly 0).  Against JAX's step the port's must lie, for
each metric and running path mean, and per optimizer and Adam moment
for the worst per-tensor L2 error and for the L2 error over all the
optimizer's tensors at once, within ``FLOOR_X`` times that floor, or
within ``METRIC_REL`` / ``MOMENT_REL`` where the floor is smaller.  Each
metric has JAX's type (float32 losses, bfloat16 score means).  At lr 0
both keep float32 parameters, g_ema, Adam moments and path means; the
parameters equal JAX's bit for bit and g_ema lies within float32
rounding of JAX's.

Seeded faults are each applied by monkeypatching, and the comparison
must reject each one by the check named beside it.  The worst tensor's
gradient moves by 15-40% under a one-ulp input change (a small bias's
gradient is rounding noise), so 3x that floor passes a gradient half
its size; over all tensors the floor is 7-13%, and that limit is what
rejects a fault of value (a regulariser's weight halved).  Faults of rounding level pass
both: path lengths taken from the bfloat16 gradient and cast back, or
the minibatch stddev in bfloat16 (bit for bit the same step: torch's
``var`` accumulates in float32).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_train_oracle as oracle
from transeditor_tpu_torch.config import TrainConfig
from transeditor_tpu_torch.io.torch_export import (
    discriminator_state_dict_from_jax, generator_state_dict_from_jax)
from transeditor_tpu_torch.train import gan as tgan
from transeditor_tpu_torch.train import losses as tlosses
from torch_port_threads import torch_worker_threads  # noqa: F401

NUDGE = 2.0 ** -8                  # one bfloat16 ulp
FLOOR_X = 3.0
METRIC_REL = 2.0 ** -7             # of the metric's magnitude
MOMENT_REL = 2.0 ** -7
ZERO_REL = 2.0 ** -8               # a tensor whose gradient is 0 in exact
#                                    arithmetic: against this share of
#                                    its optimizer's largest L2 norm
EMA_REL = 2.0 ** -21               # g_ema: a few float32 ulps
VARIANTS = {
    "plain": {},
    "r1": dict(do_d_reg=True),
    "path": dict(do_g_reg=True),
    "r1_path": dict(do_d_reg=True, do_g_reg=True),
    "spatial": dict(do_spatial_reg=True),
}


def _train_kw(variant):
    kw = {"lr": 0.0}
    if variant == "spatial":
        kw["spatial_regu"] = True
    return kw


@functools.lru_cache(maxsize=None)
def _jax_steps(variant):
    """(JAX's step, its rounding floor): each a (state, metrics) pair of
    the bfloat16 step, the floor's from inputs one bfloat16 ulp away."""
    flags = VARIANTS[variant]
    jstate, jstep, *_ = oracle.setup(dtype="bfloat16", **_train_kw(variant))
    real = oracle.real_batch()
    rng = jax.random.PRNGKey(2)
    base = jstep(jstate, jnp.asarray(real), rng, **flags)
    floor = oracle.run_jax_nudged(jstate, "bfloat16", _train_kw(variant),
                                  real, rng, NUDGE, **flags)
    return base, floor


def _port_step(variant):
    *_, state, step, cfg, tcfg = oracle.setup(dtype="bfloat16",
                                              **_train_kw(variant))
    real = oracle.real_batch()
    rng = jax.random.PRNGKey(2)
    draws = oracle.draws_from_jax(rng, cfg, tcfg, real.shape[0])
    return step(state, torch.from_numpy(real), torch.Generator(),
                draws=draws, **VARIANTS[variant]), cfg


def _moment_errors(a, b):
    """Per moment ("G exp_avg", "G sqrt exp_avg_sq", ...) of ``a`` against
    ``b`` ({name: array}): (the worst per-tensor relative L2 error, each
    tensor against max(its norm, ZERO_REL * the largest), its tensor, the
    relative L2 error over all tensors at once)."""
    out = {}
    for key in a:
        top = max(np.linalg.norm(v) for v in b[key].values())
        worst = max(
            (float(np.linalg.norm(a[key][n] - w)
                   / max(np.linalg.norm(w), ZERO_REL * top)), n)
            for n, w in b[key].items())
        every = np.sqrt(sum(np.sum((a[key][n] - w) ** 2)
                            for n, w in b[key].items())
                        / sum(np.sum(w ** 2) for w in b[key].values()))
        out[key] = (*worst, float(every))
    return out


def _jax_moments(jstate, state, cfg):
    """{"G exp_avg": {name: array}, ...} of JAX's Adam moments for the
    port's parameters, in its names and layouts (the square root of the
    second)."""
    out = {}
    for what, to, opt, mod in (
            ("G", generator_state_dict_from_jax, jstate.opt_g, state.g),
            ("D", discriminator_state_dict_from_jax, jstate.opt_d, state.d)):
        mu = to(oracle.np_tree(opt[0].mu), cfg)
        nu = to(oracle.np_tree(opt[0].nu), cfg)
        names = [n for n, _ in mod.named_parameters()]
        out[f"{what} exp_avg"] = {n: np.asarray(mu[n], np.float32)
                                  for n in names}
        out[f"{what} sqrt exp_avg_sq"] = {
            n: np.sqrt(np.asarray(nu[n], np.float32)) for n in names}
    return out


def _port_moments(state):
    out = {}
    for what, opt, mod in (("G", state.opt_g, state.g),
                           ("D", state.opt_d, state.d)):
        st = {n: opt.state[p] for n, p in mod.named_parameters()}
        out[f"{what} exp_avg"] = {n: s["exp_avg"].float().numpy()
                                  for n, s in st.items()}
        out[f"{what} sqrt exp_avg_sq"] = {
            n: s["exp_avg_sq"].float().sqrt().numpy() for n, s in st.items()}
    return out


def bf16_failures(variant, state, metrics, cfg):
    """What of the port's step after ``variant`` lies outside its
    limits against JAX's, as a list of messages (empty: it holds)."""
    (jnew, jm), (fnew, fm) = _jax_steps(variant)
    bad = []
    got = {k: float(v) for k, v in metrics.items()}
    got["mean_path_length"] = float(state.mean_path_length)
    got["mean_spatial_path_length"] = float(state.mean_spatial_path_length)
    want = {k: float(v) for k, v in jm.items()}
    floor = {k: float(v) for k, v in fm.items()}
    for k in ("mean_path_length", "mean_spatial_path_length"):
        want[k], floor[k] = float(getattr(jnew, k)), float(getattr(fnew, k))
    if set(got) != set(want):
        bad.append(f"metric keys {sorted(got)} != {sorted(want)}")
    for k in sorted(set(metrics) & set(jm)):
        # float32 where JAX's is (losses, penalties), bfloat16 where
        # JAX's is (the score means)
        if str(metrics[k].dtype).split(".")[-1] != str(jm[k].dtype):
            bad.append(f"metric {k} is {metrics[k].dtype}, JAX's "
                       f"{jm[k].dtype}")
    for k in ("mean_path_length", "mean_spatial_path_length"):
        if getattr(state, k).dtype != torch.float32:
            bad.append(f"{k} is {getattr(state, k).dtype}")
    for k in sorted(set(got) & set(want)):
        err, fl = abs(got[k] - want[k]), abs(floor[k] - want[k])
        limit = max(FLOOR_X * fl, METRIC_REL * abs(want[k]))
        if not err <= limit:
            bad.append(f"metric {k}: port {got[k]} jax {want[k]} (floor "
                       f"{fl:.3g}, limit {limit:.3g})")
    jmom = _jax_moments(jnew, state, cfg)
    pmom = _port_moments(state)
    errs = _moment_errors(pmom, jmom)
    floors = _moment_errors(_jax_moments(fnew, state, cfg), jmom)
    for k, (err, at, every) in errs.items():
        limit = max(FLOOR_X * floors[k][0], MOMENT_REL)
        if not err <= limit:
            bad.append(f"{k} worst tensor: L2 {err:.3g} at {at} (floor "
                       f"{floors[k][0]:.3g} at {floors[k][1]}, limit "
                       f"{limit:.3g})")
        limit = max(FLOOR_X * floors[k][2], MOMENT_REL)
        if not every <= limit:
            bad.append(f"{k} all tensors: L2 {every:.3g} (floor "
                       f"{floors[k][2]:.3g}, limit {limit:.3g})")
    # lr 0: float32 parameters, g_ema and moments; the parameters equal
    # JAX's, g_ema (decay * e + (1 - decay) * e) within float32 rounding
    for what, mod, tree, to, rel in (
            ("G", state.g, jnew.params_g, generator_state_dict_from_jax, 0),
            ("g_ema", state.g_ema, jnew.g_ema, generator_state_dict_from_jax,
             EMA_REL),
            ("D", state.d, jnew.params_d, discriminator_state_dict_from_jax,
             0)):
        ref = to(oracle.np_tree(tree), cfg)
        for n, p in mod.named_parameters():
            if p.dtype != torch.float32:
                bad.append(f"{what} {n} is {p.dtype}")
                continue
            want = np.asarray(ref[n])
            err = np.abs(p.detach().numpy() - want).max()
            if not err <= rel * np.abs(want).max():
                bad.append(f"{what} parameters: {n} {err:.3g} from JAX's "
                           f"at lr 0")
    for what, opt in (("G", state.opt_g), ("D", state.opt_d)):
        dtypes = {s[k].dtype for s in opt.state.values()
                  for k in ("exp_avg", "exp_avg_sq")}
        if dtypes != {torch.float32}:
            bad.append(f"{what} Adam moments in {dtypes}")
    return bad


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_step_matches_jax_within_its_rounding_floor(variant):
    (state, metrics), cfg = _port_step(variant)
    assert cfg.compute_dtype == torch.bfloat16
    bad = bf16_failures(variant, state, metrics, cfg)
    assert not bad, "\n".join(bad)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    flags = VARIANTS[variant]
    if flags.get("do_d_reg"):
        assert float(metrics["r1"]) > 0
    if flags.get("do_g_reg"):
        assert float(metrics["path_length"]) > 0
    if flags.get("do_spatial_reg"):
        assert float(metrics["spatial_path_length"]) > 0


# ------------------------------------------------------------ seeded faults

def _path_grad_cast_left_out(synth_fn, latent, noise_img, mean_path_length,
                             decay=0.01, mesh=None):
    """``losses.path_length_penalty`` without its ``grad = grad.float()``:
    the path lengths are taken from the bfloat16 gradient."""
    img = synth_fn(latent).float()
    grad, = torch.autograd.grad((img * noise_img).sum(), latent,
                                create_graph=True)
    lengths = torch.sqrt(grad.pow(2).sum(dim=2).mean(dim=1))
    path_mean = mean_path_length + decay * (lengths.mean()
                                            - mean_path_length)
    penalty = (lengths - path_mean).pow(2).mean()
    return penalty, path_mean.detach(), lengths


def _d_loss_in_bf16(monkeypatch):
    """The logistic D loss taken on the bfloat16 logits (the float32
    casts left out)."""
    real = tlosses.d_logistic_loss
    monkeypatch.setattr(
        tlosses, "d_logistic_loss",
        lambda r, f: real(r.to(torch.bfloat16), f.to(torch.bfloat16)))


def _adam_on_bf16_copies(monkeypatch):
    """Each optimizer step applied to bfloat16 copies of the float32
    master weights, written back."""
    real = tgan._apply

    def apply(opt, params, grads, mesh=None, layout=None):
        real(opt, params, grads, mesh, layout)
        with torch.no_grad():
            for p in params:
                p.copy_(p.to(torch.bfloat16))

    monkeypatch.setattr(tgan, "_apply", apply)


def _ema_on_bf16_copies(monkeypatch):
    """g_ema's update taken on bfloat16 copies, written back: the
    decay's products rounded to 8 bits."""
    real = torch._foreach_add_

    def add(ema, params, alpha=1):
        real(ema, params, alpha=alpha)
        with torch.no_grad():
            for e in ema:
                e.copy_(e.to(torch.bfloat16))

    monkeypatch.setattr(torch, "_foreach_add_", add)


def _train_config(**change):
    """The port's step built with ``change`` made to its TrainConfig, the
    JAX step's left as it is: every type and the state stay right, only
    values move."""
    def apply(monkeypatch):
        real = oracle.make_train_step
        monkeypatch.setattr(
            oracle, "make_train_step", lambda cfg, tcfg, **kw: real(
                cfg, dataclasses.replace(tcfg, **change), **kw))
    return apply


# fault -> (the variant it runs in, how it is applied, the start of the
# message of the check that must reject it)
FAULTS = {
    "path_grad_cast_left_out": ("path", lambda m: m.setattr(
        tlosses, "path_length_penalty", _path_grad_cast_left_out),
        "metric path_length is torch.bfloat16"),
    "d_loss_in_bf16": ("r1", _d_loss_in_bf16, "metric d is torch.bfloat16"),
    "adam_on_bf16_copies": ("plain", _adam_on_bf16_copies, "G parameters"),
    "ema_on_bf16_copies": ("plain", _ema_on_bf16_copies,
                           "g_ema parameters"),
    # of value: the regulariser's gradient at half its size
    "r1_gamma_halved": ("r1", _train_config(
        r1_gamma=TrainConfig.r1_gamma / 2), "D exp_avg all tensors"),
    "path_regularize_halved": ("path", _train_config(
        path_regularize=TrainConfig.path_regularize / 2),
        "G exp_avg all tensors"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_seeded_fault_fails_the_comparison(fault, monkeypatch):
    variant, apply, rejected_by = FAULTS[fault]
    with monkeypatch.context() as m:
        apply(m)
        (state, metrics), cfg = _port_step(variant)
    bad = bf16_failures(variant, state, metrics, cfg)
    assert any(msg.startswith(rejected_by) for msg in bad), (
        f"{fault} not rejected by '{rejected_by}': {bad}")
