"""Shared pieces of the editing-slice parity tests
(``test_torch_port_{classifiers,boundary,edit_sweep,edit_cli}.py``):
random reference-layout classifier state dicts drawn with numpy (DEX
VGG16, the ClassifyModel resnet18 of the pose net, the gan-ensembling
CelebA-HQ D), their JAX variables through the JAX package's ``port_*``,
the port's modules loaded from them with ``strict=True``, and a tiny
generator pair (JAX and port on the same weights).

Narrowing: the DEX net's widths come from ``VGG_PLAN`` and the CelebA-HQ
net's from ``_nf``, module globals that both packages read when a
network is built or applied; ``narrow_dex`` / ``narrow_celebahq`` swap
them in both while entered (the fully connected layers stay 4096 wide:
the JAX ``DexVGG`` names that width itself).
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from transeditor_tpu.config import ModelConfig as JaxConfig
from transeditor_tpu.edit import celebahq_classifier as jceleb
from transeditor_tpu.edit import classifiers as jcls
from transeditor_tpu.models import Generator as JaxGenerator

from torch_port_encoder_oracle import (assert_close, port_module, rel_err,
                                       torch_sd)
from transeditor_tpu_torch.config import ModelConfig
from transeditor_tpu_torch.edit import celebahq_classifier as tceleb
from transeditor_tpu_torch.edit import classifiers as tcls
from transeditor_tpu_torch.io.torch_export import \
    generator_state_dict_from_jax
from transeditor_tpu_torch.models.generator import Generator

__all__ = ["assert_close", "port_module", "rel_err", "torch_sd"]

NARROW_PLAN = [(8, 2), (8, 2), (16, 3), (16, 3), (16, 3)]
NARROW_NF = dict(fmap_base=256, fmap_max=16)
TINY = dict(size=16, style_dim=32, param_dim=32, max_channels=32,
            n_trans=1)


@contextlib.contextmanager
def narrow_dex(plan=NARROW_PLAN):
    before = (jcls.VGG_PLAN, tcls.VGG_PLAN)
    jcls.VGG_PLAN = tcls.VGG_PLAN = plan
    try:
        yield plan
    finally:
        jcls.VGG_PLAN, tcls.VGG_PLAN = before


@contextlib.contextmanager
def narrow_celebahq(**nf_kw):
    nf_kw = nf_kw or NARROW_NF
    before = (jceleb._nf, tceleb._nf)
    jceleb._nf = functools.partial(before[0], **nf_kw)
    tceleb._nf = functools.partial(before[1], **nf_kw)
    try:
        yield
    finally:
        jceleb._nf, tceleb._nf = before


def _he(rng, shape, gain=1.0):
    fan_in = int(np.prod(shape[1:]))
    return (rng.standard_normal(shape, dtype=np.float32)
            * np.float32(gain * np.sqrt(2.0 / fan_in)))


def _bn(sd, prefix, rng, c):
    sd[f"{prefix}.weight"] = 1 + 0.1 * rng.standard_normal(c, np.float32)
    sd[f"{prefix}.bias"] = 0.1 * rng.standard_normal(c, np.float32)
    sd[f"{prefix}.running_mean"] = 0.1 * rng.standard_normal(c, np.float32)
    sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(7, np.int64)


def dex_sd(seed, classes=101, plan=None):
    """A DEX VGG16 state dict (``conv.{b}.conv{i}``, ``fc1.0``, ``fc2.0``,
    ``cls``) for 0..255 inputs: He-scaled convs over the input's spread,
    a small head so that the softmax is not saturated."""
    rng = np.random.default_rng(seed)
    plan = plan or jcls.VGG_PLAN
    sd, cin = {}, 3
    for b, (feat, n) in enumerate(plan):
        for c in range(n):
            gain = 1 / 128 if (b, c) == (0, 0) else 1.0
            sd[f"conv.{b}.conv{c + 1}.weight"] = _he(rng, (feat, cin, 3, 3),
                                                     gain)
            sd[f"conv.{b}.conv{c + 1}.bias"] = 0.1 * rng.standard_normal(
                feat, np.float32)
            cin = feat
    for name, o, i, gain in (("fc1.0", 4096, cin * 49, 1.0),
                             ("fc2.0", 4096, 4096, 1.0),
                             ("cls", classes, 4096, 0.5)):
        sd[f"{name}.weight"] = _he(rng, (o, i), gain)
        sd[f"{name}.bias"] = 0.1 * rng.standard_normal(o, np.float32)
    return sd


def pose_sd(seed, n_class=2):
    """A ClassifyModel (resnet18 minus fc as ``backbone`` + ``extra_layer``)
    state dict for 0..255 inputs (the DEX feed), with non-trivial BN
    statistics and a small head, so that the softmax is not saturated."""
    rng = np.random.default_rng(seed)
    sd = {"backbone.0.weight": _he(rng, (64, 3, 7, 7), 1 / 128)}
    _bn(sd, "backbone.1", rng, 64)
    cin = 64
    for layer, (cout, stride) in enumerate(((64, 1), (128, 2), (256, 2),
                                            (512, 2))):
        for b in range(2):
            pre = f"backbone.{4 + layer}.{b}"
            s, ci = (stride, cin) if b == 0 else (1, cout)
            sd[f"{pre}.conv1.weight"] = _he(rng, (cout, ci, 3, 3))
            _bn(sd, f"{pre}.bn1", rng, cout)
            sd[f"{pre}.conv2.weight"] = _he(rng, (cout, cout, 3, 3))
            _bn(sd, f"{pre}.bn2", rng, cout)
            if s != 1 or ci != cout:
                sd[f"{pre}.downsample.0.weight"] = _he(rng, (cout, ci, 1, 1))
                _bn(sd, f"{pre}.downsample.1", rng, cout)
        cin = cout
    sd["extra_layer.weight"] = _he(rng, (n_class, 512), 0.1)
    sd["extra_layer.bias"] = 0.1 * rng.standard_normal(n_class, np.float32)
    return sd


def celebahq_sd(seed, resolution=256):
    """A gan-ensembling attribute D state dict (N(0, 1) weights and
    biases, as the wscale layers expect; ``_nf`` as patched)."""
    rng = np.random.default_rng(seed)
    nf = jceleb._nf
    sd = {}

    def conv(prefix, cin, cout, k):
        sd[f"{prefix}.conv.weight"] = rng.standard_normal(
            (cout, cin, k, k), np.float32)
        sd[f"{prefix}.wscale.b"] = 0.1 * rng.standard_normal(cout, np.float32)

    def dense(prefix, cin, cout):
        sd[f"{prefix}.linear.weight"] = rng.standard_normal((cout, cin),
                                                            np.float32)
        sd[f"{prefix}.wscale.b"] = 0.1 * rng.standard_normal(cout, np.float32)

    log2res = int(np.log2(resolution))
    conv("fromrgb_lod0.conv", 3, nf(log2res - 1), 1)
    cin = nf(log2res - 1)
    for res in range(log2res, 2, -1):
        r = 2 ** res
        conv(f"{r}x{r}.conv0", cin, nf(res - 1), 3)
        conv(f"{r}x{r}.conv1", nf(res - 1), nf(res - 2), 3)
        cin = nf(res - 2)
    conv("4x4.conv", cin, nf(1), 3)
    dense("4x4.dense0", nf(1) * 16, nf(0))
    dense("4x4.dense1", nf(0), 1)
    return sd


def save_sd(path, sd):
    torch.save(torch_sd(sd), path)
    return str(path)


def images(seed, b=2, size=64):
    rng = np.random.RandomState(200 + seed)
    return rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


def generator_pair(seed=0, **kw):
    """(JAX Generator module, its params, the port ``Generator`` on the
    CPU holding the same weights)."""
    kw = {**TINY, **kw}
    jg = JaxGenerator(JaxConfig(**kw))
    z0 = jnp.zeros((1, 16, kw["style_dim"]))
    params = jg.init({"params": jax.random.PRNGKey(seed),
                      "noise": jax.random.PRNGKey(seed + 1)}, z0, z0)
    cfg = ModelConfig(**kw)
    g = Generator(cfg, device="cpu")
    g.load_state_dict(generator_state_dict_from_jax(
        jax.tree.map(np.asarray, params), cfg), strict=True)
    return jg, params, g.eval()
