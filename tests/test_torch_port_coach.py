"""The port's encoder coach (``transeditor_tpu_torch/train/coach.py``)
against the JAX package's ``make_coach``, on the CPU in float32.

The coach runs at 64px on the reduced encoder (``torch_port_encoder_oracle``:
IR-SE-50 trunk, 3 + 16 heads of ``HEAD`` channels) and a decoder of the
same width (``style_dim`` = ``param_dim`` = ``HEAD``, one interaction
block, 32 synthesis channels), with a random AlexNet LPIPS in
torchvision's layout, random plus-space latent averages, the L2, LPIPS
and w-norm terms and fake guidance (0.5).  The JAX coach is the package's
own ``make_coach``, built and traced inside ``reduced_jax_encoder``; its
state starts from the same random pSp-layout weights as the port's.

From the same state, on three seeds (encoder weights, images, the fake
step's codes):

* one train step: the losses (rtol 1e-4), the encoder's gradients as
  both optimizers hold them after their first update, (1 - b1) GC(g) and
  (1 - b2) GC(g)^2 with GC the gradient centralisation (1e-4 and 2e-4 of
  each tensor's largest magnitude), the BatchNorm running statistics
  (1e-5 of each BN's scale) and every parameter after the Ranger update
  (0.1 * lr);
* then one fake step with JAX's codes fed to the port (``draws=``): the
  latent loss, the statistics and the parameters;
* then one eval step on the running statistics: the losses and the
  inversions (1e-5).

The images the frameworks decode differ by rounding, and the AlexNet's
ReLUs, the encoder's PReLUs and leaky ReLUs and the decoder's leaky
ReLUs are kinks: an input within rounding of 0 takes either slope.  At
this size the three seeds meet none that moves a gradient past 1e-4, so
nothing is pinned here; ``face_crop`` / ``resize_112`` and the ArcFace
ID loss, which need 256px images, are held on their own below.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.io import zoo_port as jz
from transeditor_tpu.models import Generator as JaxGenerator
from transeditor_tpu.models.irse import ArcFaceBackbone as JaxArcFace
from transeditor_tpu.train import coach as jc
from transeditor_tpu.train.ranger import ranger_simple as jax_ranger_simple
from transeditor_tpu.utils.sampling import sample_zp as jax_sample_zp
from transeditor_tpu.zoo.lpips import load_lpips_params as jax_load_lpips

import torch_port_encoder_oracle as orc
from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.io import torch_export as te
from transeditor_tpu_torch.models import irse as ti
from transeditor_tpu_torch.models import psp as tp
from transeditor_tpu_torch.models.generator import Generator
from transeditor_tpu_torch.train import coach as tc
from transeditor_tpu_torch.zoo.lpips import LPIPS, load_lpips_params

DECODER = dict(size=64, style_dim=orc.HEAD, param_dim=orc.HEAD,
               max_channels=32, n_trans=1)
CCFG = dict(batch_size=2, id_lambda=0.0, lpips_lambda=0.8, l2_lambda=1.0,
            w_norm_lambda=0.1, use_fake_lambda=0.5)
LOSS_RTOL = 1e-4
GRAD_REL = 1e-4
STATS_TOL = 1e-5
OUT_REL = 1e-5
ALEX = [(0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3), (8, 256, 384, 3),
        (10, 256, 256, 3)]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with orc.worker_threads():
        yield


def _alex_sd(seed=7):
    rng = np.random.default_rng(seed)
    sd = {}
    for idx, o, i, k in ALEX:
        sd[f"features.{idx}.weight"] = (
            rng.standard_normal((o, i, k, k), np.float32)
            * np.float32(np.sqrt(2.0 / (i * k * k))))
        sd[f"features.{idx}.bias"] = 0.1 * rng.standard_normal(o, np.float32)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        sd[f"lin{i}.model.1.weight"] = np.abs(rng.standard_normal(
            (1, c, 1, 1), np.float32))
    return sd


@functools.lru_cache(maxsize=None)
def _frozen():
    """The frozen networks and latent averages, both sides."""
    jcfg = JaxConfig(**DECODER)
    z0 = jnp.zeros((1, 16, orc.HEAD))
    dec = orc.np_tree(jax.jit(JaxGenerator(jcfg).init)(
        jax.random.PRNGKey(0), z0, z0))
    cfg = ModelConfig(**DECODER)
    g = Generator(cfg, device="cpu")
    g.load_state_dict(te.generator_state_dict_from_jax(dec, cfg), strict=True)
    sd = _alex_sd()
    lp = LPIPS("alex", device="cpu")
    lp.load_state_dict(load_lpips_params(sd, "alex"), strict=True)
    rng = np.random.default_rng(9)
    avg = tuple(rng.standard_normal((16, orc.HEAD), np.float32)
                for _ in range(2))
    return jcfg, dec, jax_load_lpips(sd, "alex"), avg, cfg, g.eval(), lp


@functools.lru_cache(maxsize=None)
def _jax_coach():
    """``make_coach`` of the JAX package for the reduced encoder; its
    jitted steps trace at their first calls, made inside
    ``reduced_jax_encoder``."""
    jcfg, dec, lpp, avg, *_ = _frozen()
    with orc.reduced_jax_encoder():
        return jc.make_coach(jcfg, jc.CoachConfig(**CCFG), dec, lpp,
                             latent_avg=avg)


def _states(seed):
    """(JAX CoachState, port CoachState, port train/eval/fake steps) from
    the same random pSp-layout encoder weights."""
    sd = orc.reduced_sd(seed)
    variables = orc.jax_encoder_vars(sd)
    params = jax.device_put(variables["params"])
    jstate = jc.CoachState(
        step=jnp.zeros((), jnp.int32), enc_params=params,
        enc_stats=jax.device_put(variables["batch_stats"]),
        opt_state=jax_ranger_simple(jc.CoachConfig().learning_rate).init(
            params),
        best_val_loss=jnp.asarray(jnp.inf))
    *_, avg, cfg, g, lp = _frozen()
    pinit, ptrain, peval, pfake = tc.make_coach(
        cfg, tc.CoachConfig(**CCFG), g, lp, None, avg)
    enc = tp.GradualStyleEncoder(head_channels=orc.HEAD, **orc.REDUCED)
    enc.load_state_dict(orc.torch_sd(sd), strict=True)
    return jstate, pinit(enc), ptrain, peval, pfake


def _to_port(tree, bridge_stats):
    """A JAX params tree (values or gradients) -> {port name: array}."""
    sd = te.gradual_style_encoder_state_dict_from_jax(
        {"params": orc.np_tree(tree), "batch_stats": bridge_stats})
    return sd


def _hold_params(enc, jparams, jstats, atol, what):
    want = _to_port(jparams, orc.np_tree(jstats))
    for name, p in enc.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= atol, f"{what} {name}: {err:.3e} > {atol:.1e}"


def _hold_logs(logs, jlogs, what):
    assert set(logs) == set(jlogs), (sorted(logs), sorted(jlogs))
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=LOSS_RTOL,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("seed", orc.SEEDS)
def test_train_fake_eval_steps_match_jax(seed):
    jstate, state, ptrain, peval, pfake = _states(seed)
    _, jtrain, jeval, jfake = _jax_coach()
    lr = jc.CoachConfig(**CCFG).learning_rate
    real = orc.images(seed)

    # --- train step
    with orc.reduced_jax_encoder():
        jstate1, jlogs, jinv = jtrain(jstate, jnp.asarray(real))
    state, logs, inv = ptrain(state, torch.from_numpy(real))
    assert state.step == 1 and int(jstate1.step) == 1
    _hold_logs(logs, jlogs, "train")
    orc.assert_close(inv, jinv, OUT_REL, "train inversions")
    # the gradients, as both optimizers hold them after their first
    # update: (1 - b1) GC(g) and (1 - b2) GC(g)^2
    adam = jstate1.opt_state[1]
    stats = orc.np_tree(jstate.enc_stats)
    for key, tree, rel in (("exp_avg", adam.mu, GRAD_REL),
                           ("exp_avg_sq", adam.nu, 2 * GRAD_REL)):
        want = _to_port(tree, stats)
        for name, p in state.encoder.named_parameters():
            orc.assert_close(state.optimizer.state[p][key], want[name], rel,
                             f"{key} {name}")
    want_stats = _to_port(jstate1.enc_params, orc.np_tree(jstate1.enc_stats))
    orc.assert_stats_close(state.encoder.state_dict(), want_stats, STATS_TOL,
                           "train stats")
    _hold_params(state.encoder, jstate1.enc_params, jstate1.enc_stats,
                 0.1 * lr, "train params")

    # --- fake step on JAX's codes
    key = jax.random.PRNGKey(100 + seed)
    draws = [np.asarray(t) for t in jax_sample_zp(key, 2, 16, orc.HEAD)]
    with orc.reduced_jax_encoder():
        jstate2, jfloss = jfake(jstate1, key)
    state, floss = pfake(state, draws=draws)
    np.testing.assert_allclose(float(floss), float(jfloss), rtol=LOSS_RTOL)
    want_stats = _to_port(jstate2.enc_params, orc.np_tree(jstate2.enc_stats))
    orc.assert_stats_close(state.encoder.state_dict(), want_stats, STATS_TOL,
                           "fake stats")
    _hold_params(state.encoder, jstate2.enc_params, jstate2.enc_stats,
                 0.1 * lr, "fake params")
    assert state.step == 1 and int(jstate2.step) == 1

    # --- eval step on the running statistics
    with orc.reduced_jax_encoder():
        jlogs, jinv = jeval(jstate2, jnp.asarray(real))
    logs, inv = peval(state, torch.from_numpy(real))
    _hold_logs(logs, jlogs, "eval")
    orc.assert_close(inv, jinv, OUT_REL, "eval inversions")


def test_fake_step_decodes_only_its_codes(monkeypatch):
    """Trap 5: the fake step decodes its sampled codes once (no grad) and
    never decodes the encoder's output; the train and eval steps decode
    once each."""
    _, state, ptrain, peval, pfake = _states(0)
    calls = []
    forward = Generator.forward

    def counting(self, *args, **kw):
        calls.append(torch.is_grad_enabled())
        return forward(self, *args, **kw)

    monkeypatch.setattr(Generator, "forward", counting)
    real = torch.from_numpy(orc.images(0))
    ptrain(state, real)
    assert calls == [True]
    calls.clear()
    pfake(state, rng=torch.Generator().manual_seed(0))
    assert calls == [False]
    calls.clear()
    peval(state, real)
    assert calls == [False]


def test_coach_checkpoint_round_trip(tmp_path):
    """``save_coach_state`` / ``restore_coach_state``: a restored state
    (encoder with its BN buffers, Ranger state, step, best validation
    loss) continues exactly as the saved one does; an orbax directory,
    the JAX coach's format, raises naming it."""
    from transeditor_tpu_torch.io.checkpoint import (restore_coach_state,
                                                     save_coach_state)

    _, state, ptrain, _, _ = _states(1)
    real = torch.from_numpy(orc.images(1))
    state, _, _ = ptrain(state, real)
    state.best_val_loss = 1.5
    path = save_coach_state(str(tmp_path / "ckpt_000001.pt"), state)
    _, fresh, *_ = _states(2)
    fresh = restore_coach_state(path, fresh)
    assert fresh.step == 1 and fresh.best_val_loss == 1.5
    for (k, a), b in zip(state.encoder.state_dict().items(),
                         fresh.encoder.state_dict().values()):
        assert torch.equal(a, b), k
    for s in (state, fresh):
        ptrain(s, real)
    for a, b in zip(state.encoder.parameters(), fresh.encoder.parameters()):
        assert torch.equal(a, b)
    (tmp_path / "best_model").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        restore_coach_state(str(tmp_path / "best_model"), fresh)


# ------------------------------------------------------------ 256px pieces

def test_face_crop_raises_below_224px():
    with pytest.raises(ValueError, match="224px"):
        tc.face_crop(torch.zeros(1, 223, 256, 3))
    with pytest.raises(ValueError, match="224px"):
        tc.face_crop(torch.zeros(1, 256, 200, 3))


@pytest.mark.parametrize("seed", orc.SEEDS)
def test_face_crop_resize_and_id_loss_match_jax(seed):
    """``face_crop`` / ``resize_112`` on 256px images, and
    ``make_arcface_id_loss`` with a random IR-SE-50 ArcFace (eval mode)
    against the JAX package's, on two image batches."""
    rng = np.random.default_rng(200 + seed)
    a, b = (rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
            for _ in range(2))
    for img in (a, b):
        want = jc.resize_112(jc.face_crop(jnp.asarray(img)))
        got = tc.resize_112(tc.face_crop(torch.from_numpy(img)))
        assert tuple(got.shape) == (2, 112, 112, 3)
        orc.assert_close(got, want, 1e-6, "resize_112(face_crop)")
    sd = _arcface(seed)
    arc = JaxArcFace()
    jid = jc.make_arcface_id_loss(lambda v, x: arc.apply(v, x),
                                  jz.port_arcface(sd))
    jloss, jimprove = jax.jit(jid.fn)(jid.params, jnp.asarray(a),
                                      jnp.asarray(b))
    net = ti.ArcFaceBackbone()
    net.load_state_dict(orc.torch_sd(sd), strict=True)
    loss, improve = tc.make_arcface_id_loss(net)(torch.from_numpy(a),
                                                 torch.from_numpy(b))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(improve), float(jimprove), rtol=1e-5)
    assert not net.training


@functools.lru_cache(maxsize=1)
def _arcface(seed):
    return orc.arcface_sd(seed)
