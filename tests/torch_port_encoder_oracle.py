"""Shared pieces of the encoder-slice parity tests (``test_torch_port_{irse,
psp,ranger,coach,encode_cli}.py``): random reference-layout state dicts
(InsightFace for IR-SE trunks and ArcFace, pSp for the encoders), their
JAX variables through the JAX package's ``io/zoo_port.py``, and the
reduced JAX encoder.

The reduced encoder keeps the IR-SE-50 trunk and sets the JAX module's
own fields ``style_count=3, coarse_ind=1, middle_ind=2`` (one head per
pyramid level); ``spatial_count`` stays 16, the decoder's token count (P+
is its 4x4 input map).  The 16 spatial heads at the reference's 512
channels alone would hold 151M parameters, so the heads are ``HEAD``
channels wide and the decoder's ``style_dim`` / ``param_dim`` match: on
the JAX side by ``reduced_jax_encoder``, which swaps the names
``GradualStyleBlock`` / ``GradualStyleEncoder`` that ``models/psp.py``
and ``train/coach.py`` look up for narrow / reduced ones while it is
entered; on the port by ``GradualStyleEncoder(head_channels=HEAD)``.
"""

from __future__ import annotations

import contextlib
import functools
import os

import jax
import numpy as np
import torch

from transeditor_tpu.io import zoo_port as jz
from transeditor_tpu.models import psp as jpsp
from transeditor_tpu.models.irse import unit_list
from transeditor_tpu.train import coach as jcoach

HEAD = 32
REDUCED = dict(style_count=3, coarse_ind=1, middle_ind=2, spatial_count=16)
SEEDS = (0, 1, 2)
RES_GAIN = 0.2


@contextlib.contextmanager
def worker_threads(n=2):
    """Under pytest-xdist, torch's intra-op threads set to ``n`` while
    entered: these files' large elementwise and convolution work on
    torch's default of one thread per core, in every worker at once,
    oversubscribes the machine many times over (the five files took 941
    s together on 5 workers of 8 cores, against 124 s at 2 threads)."""
    before = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def images(seed, b=2, size=64):
    rng = np.random.RandomState(100 + seed)
    return rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


def _he(rng, shape):
    fan_in = int(np.prod(shape[1:]))
    return (rng.standard_normal(shape, dtype=np.float32)
            * np.float32(np.sqrt(2.0 / fan_in)))


def _bn(sd, prefix, rng, c, gain=1.0):
    sd[f"{prefix}.weight"] = gain * (1 + 0.1 * rng.standard_normal(
        c, np.float32))
    sd[f"{prefix}.bias"] = 0.1 * rng.standard_normal(c, np.float32)
    sd[f"{prefix}.running_mean"] = 0.1 * rng.standard_normal(c, np.float32)
    sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(7, np.int64)


def _trunk(sd, rng, num_layers=50, use_se=True):
    sd["input_layer.0.weight"] = _he(rng, (64, 3, 3, 3))
    _bn(sd, "input_layer.1", rng, 64)
    sd["input_layer.2.weight"] = (0.25 + 0.05 * rng.standard_normal(
        64, np.float32))
    for i, (cin, d, _) in enumerate(unit_list(num_layers)):
        pre = f"body.{i}"
        if cin != d:
            sd[f"{pre}.shortcut_layer.0.weight"] = _he(rng, (d, cin, 1, 1))
            _bn(sd, f"{pre}.shortcut_layer.1", rng, d)
        _bn(sd, f"{pre}.res_layer.0", rng, cin)
        sd[f"{pre}.res_layer.1.weight"] = _he(rng, (d, cin, 3, 3))
        sd[f"{pre}.res_layer.2.weight"] = (0.25 + 0.05 * rng.standard_normal(
            d, np.float32))
        sd[f"{pre}.res_layer.3.weight"] = _he(rng, (d, d, 3, 3))
        # a small residual branch, as trained nets have: with unit gain
        # the random 24-unit trunk is chaotic (rounding grows 50x every
        # 4 units), which no comparison of two frameworks survives
        _bn(sd, f"{pre}.res_layer.4", rng, d, gain=RES_GAIN)
        if use_se:
            sd[f"{pre}.res_layer.5.fc1.weight"] = _he(rng, (d // 16, d, 1, 1))
            sd[f"{pre}.res_layer.5.fc2.weight"] = _he(rng, (d, d // 16, 1, 1))


def _linear(sd, prefix, rng, o, i, equal=False):
    sd[f"{prefix}.weight"] = (rng.standard_normal((o, i), np.float32) if equal
                              else _he(rng, (o, i)))
    sd[f"{prefix}.bias"] = 0.1 * rng.standard_normal(o, np.float32)


def trunk_sd(seed, num_layers=50, use_se=True):
    sd = {}
    _trunk(sd, np.random.default_rng(seed), num_layers, use_se)
    return sd


def arcface_sd(seed, num_layers=50, use_se=True):
    """A model_irse ``Backbone`` (112px) state dict."""
    rng = np.random.default_rng(seed)
    sd = {}
    _trunk(sd, rng, num_layers, use_se)
    _bn(sd, "output_layer.0", rng, 512)
    _linear(sd, "output_layer.3", rng, 512, 512 * 49)
    _bn(sd, "output_layer.4", rng, 512)
    return sd


def _level(j, coarse_ind, middle_ind):
    return 16 if j < coarse_ind else 32 if j < middle_ind else 64


def psp_encoder_sd(seed, style_count=14, coarse_ind=3, middle_ind=7,
                   spatial_count=16, head=512):
    """A pSp ``GradualStyleEncoder`` state dict (no ``encoder.``
    prefix)."""
    rng = np.random.default_rng(seed)
    sd = {}
    _trunk(sd, rng)

    def block(prefix, spatial):
        for n in range(int(np.log2(spatial))):
            cin = 512 if n == 0 else head
            sd[f"{prefix}.convs.{2 * n}.weight"] = _he(rng, (head, cin, 3, 3))
            sd[f"{prefix}.convs.{2 * n}.bias"] = 0.1 * rng.standard_normal(
                head, np.float32)
        _linear(sd, f"{prefix}.linear", rng, head, head, equal=True)

    for j in range(style_count):
        block(f"styles.{j}", _level(j, coarse_ind, middle_ind))
    for j in range(spatial_count):
        block(f"spatials.{j}", 16)
    for name, cin in (("latlayer1", 256), ("latlayer2", 128)):
        sd[f"{name}.weight"] = _he(rng, (512, cin, 1, 1))
        sd[f"{name}.bias"] = 0.1 * rng.standard_normal(512, np.float32)
    _linear(sd, "adjust_style", rng, spatial_count, style_count, equal=True)
    return sd


def reduced_sd(seed):
    return psp_encoder_sd(seed, head=HEAD, **REDUCED)


def into_w_sd(seed):
    rng = np.random.default_rng(seed)
    sd = {}
    _trunk(sd, rng)
    _linear(sd, "linear", rng, 512, 512, equal=True)
    return sd


def into_wplus_sd(seed, n_styles=18):
    rng = np.random.default_rng(seed)
    sd = {}
    _trunk(sd, rng)
    _bn(sd, "output_layer_2.0", rng, 512)
    _linear(sd, "output_layer_2.3", rng, 512, 512 * 49)
    _linear(sd, "linear", rng, 512 * n_styles, 512, equal=True)
    return sd


def jax_encoder_vars(sd):
    """The JAX package's port of a pSp encoder state dict with any head
    counts: ``port_gradual_style_encoder`` for the 14 + 16 heads it
    names, the same pieces (``port_irse_backbone``,
    ``_gradual_style_block``) for others."""
    n_style = len({k.split(".")[1] for k in sd if k.startswith("styles.")})
    n_spatial = len({k.split(".")[1] for k in sd if k.startswith("spatials.")})
    if (n_style, n_spatial) == (14, 16):
        return jz.port_gradual_style_encoder(sd)
    trunk_p, trunk_s = jz.port_irse_backbone(sd)
    params = {"trunk": trunk_p}
    for j in range(n_style):
        params[f"style_{j}"] = jz._gradual_style_block(sd, f"styles.{j}")
    for j in range(n_spatial):
        params[f"spatial_{j}"] = jz._gradual_style_block(sd, f"spatials.{j}")
    for name in ("latlayer1", "latlayer2"):
        params[name] = {"conv": {"kernel": jz._conv_hwio(sd[f"{name}.weight"]),
                                 "bias": sd[f"{name}.bias"]}}
    params["adjust_style"] = {"kernel": sd["adjust_style.weight"].T,
                              "bias": sd["adjust_style.bias"]}
    return {"params": params, "batch_stats": {"trunk": trunk_s}}


def torch_sd(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def port_module(build, sd):
    """``build()`` on the meta device, given storage and ``sd`` loaded
    with ``strict=True`` (torch's initialisers are skipped)."""
    with torch.device("meta"):
        module = build()
    module.to_empty(device="cpu")
    module.load_state_dict(torch_sd(sd), strict=True)
    return module


@contextlib.contextmanager
def reduced_jax_encoder(head=HEAD):
    """While entered, ``models/psp.py`` and ``train/coach.py`` build the
    reduced encoder (``REDUCED`` heads, ``head`` channels wide)."""
    block, enc = jpsp.GradualStyleBlock, jpsp.GradualStyleEncoder
    reduced = functools.partial(enc, **REDUCED)
    try:
        jpsp.GradualStyleBlock = (
            lambda out_c, spatial, name=None: block(head, spatial, name=name))
        jpsp.GradualStyleEncoder = reduced
        jcoach.GradualStyleEncoder = reduced
        yield reduced
    finally:
        jpsp.GradualStyleBlock = block
        jpsp.GradualStyleEncoder = enc
        jcoach.GradualStyleEncoder = enc


def rel_err(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_close(got, want, rel, name):
    err = rel_err(got, want)
    assert err <= rel, f"{name}: {err:.3e} of the largest > {rel}"
    return err


def stats_errors(got_sd, want_sd):
    """{bn prefix: error} of BN running statistics: the variance's
    largest error over its largest value, and the mean's over the larger
    of its largest magnitude and the root of the largest variance (a
    running mean near 0 is measured in units of the activations'
    spread)."""
    out = {}
    for k in want_sd:
        if not k.endswith("running_mean"):
            continue
        pre = k[:-len("running_mean")]
        gm, gv = (np.asarray(got_sd[pre + s], np.float64)
                  for s in ("running_mean", "running_var"))
        wm, wv = (np.asarray(want_sd[pre + s], np.float64)
                  for s in ("running_mean", "running_var"))
        scale = max(np.abs(wm).max(), np.sqrt(wv.max()))
        out[pre] = max(np.abs(gm - wm).max() / scale,
                       np.abs(gv - wv).max() / wv.max())
    return out


def assert_stats_close(got_sd, want_sd, tol, name):
    errs = stats_errors(got_sd, want_sd)
    pre, worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst <= tol, f"{name} {pre}: {worst:.3e} > {tol}"
    return worst
