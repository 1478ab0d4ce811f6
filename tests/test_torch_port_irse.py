"""The port's IR-SE backbones (``transeditor_tpu_torch/models/irse.py``,
``BackboneEncoderIntoW`` / ``IntoWPlus`` of ``models/psp.py``) against
the JAX package's, on the CPU in float32.

Random InsightFace / pSp-layout state dicts (``torch_port_encoder_oracle``)
go through the JAX package's ``io/zoo_port.py`` into JAX and load
straight into the port with ``strict=True``; the JAX variables also come
back through the port's ``io/torch_export.py`` bridge unchanged.  Outputs
are held within 1e-5 of their largest magnitude in eval mode and in
train mode, where the BatchNorm running statistics each step updates are
held too (1e-5 of each BN's scale), on three seeds.  The default-size
encoder and ArcFace are checked key by key and shape by shape on the
meta device against ``jax.eval_shape`` of the JAX ``init``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from transeditor_tpu.io import zoo_port as jz
from transeditor_tpu.models import irse as ji
from transeditor_tpu.models import psp as jp

import torch_port_encoder_oracle as orc
from transeditor_tpu_torch.io import torch_export as te
from transeditor_tpu_torch.models import irse as ti
from transeditor_tpu_torch.models import psp as tp

OUT_REL = 1e-5
STATS_TOL = 1e-5
ARCFACE = {"ir_se50": (50, True), "ir101": (100, False)}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with orc.worker_threads():
        yield


@functools.lru_cache(maxsize=None)
def _jax_apply(module, train):
    if train:
        return jax.jit(lambda v, x: module.apply(v, x,
                                                 mutable=["batch_stats"]))
    return jax.jit(module.apply)


def _run(jmod_eval, jmod_train, variables, port, x, train):
    """(jax outputs, port outputs, jax new batch_stats or None) as numpy
    lists; the port module is left in the mode asked for."""
    if train:
        out, new = _jax_apply(jmod_train, True)(variables, jnp.asarray(x))
        new = orc.np_tree(new["batch_stats"])
    else:
        out, new = _jax_apply(jmod_eval, False)(variables, jnp.asarray(x)), None
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    flat = lambda o: [np.asarray(t) for t in jax.tree.leaves(o)]
    return flat(out), [t.numpy() for t in jax.tree.leaves(
        got, is_leaf=lambda t: isinstance(t, torch.Tensor))], new


def _hold(jax_out, port_out, name):
    assert len(jax_out) == len(port_out)
    return max(orc.assert_close(b, a, OUT_REL, f"{name} output {i}")
               for i, (a, b) in enumerate(zip(jax_out, port_out)))


def _hold_stats(port, jax_vars, new_stats, bridge, name):
    want = bridge({"params": jax_vars["params"], "batch_stats": new_stats})
    return orc.assert_stats_close(port.state_dict(), want, STATS_TOL, name)


@functools.lru_cache(maxsize=3)
def _sd_and_vars(kind, seed):
    """(reference-layout state dict, JAX variables through the JAX
    package's io/zoo_port.py), shared by a case's eval and train runs."""
    if kind == "trunk":
        sd = orc.trunk_sd(seed)
        params, stats = jz.port_irse_backbone(sd)
        return sd, {"params": params, "batch_stats": stats}
    if kind in ARCFACE:
        sd = orc.arcface_sd(seed, *ARCFACE[kind])
        return sd, jz.port_arcface(sd, *ARCFACE[kind])
    if kind == "into_w":
        sd = orc.into_w_sd(seed)
        return sd, jz.port_backbone_encoder_into_w(sd)
    sd = orc.into_wplus_sd(seed)
    return sd, jz.port_backbone_encoder_into_wplus(sd)


def _trunk_case(seed):
    sd, variables = _sd_and_vars("trunk", seed)
    return sd, variables, orc.port_module(ti.IRSEBackbone, sd)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("seed", orc.SEEDS)
def test_trunk_taps_match_jax(seed, train):
    sd, variables, port = _trunk_case(seed)
    x = orc.images(seed)
    jout, pout, new = _run(ji.IRSEBackbone(train=False),
                           ji.IRSEBackbone(train=True), variables, port, x,
                           train)
    assert [o.shape for o in pout] == [(2, 16, 16, 128), (2, 8, 8, 256),
                                       (2, 4, 4, 512), (2, 4, 4, 512)]
    _hold(jout, pout, "trunk")
    if train:
        _hold_stats(port, variables, new, te.irse_state_dict_from_jax,
                    "trunk")
    else:
        # the JAX variables come back through the port's bridge unchanged
        back = te.irse_state_dict_from_jax(variables)
        for k, v in orc.torch_sd(sd).items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(back[k], v), k


def test_plain_torch_batchnorm_parts_from_jax():
    """Trap 1: ``torch.nn.BatchNorm2d`` moves the running variance toward
    the unbiased batch variance, flax toward the biased one; with plain
    torch BNs the train-mode statistics hold above fails (the deepest BNs
    see n = 2 * 4 * 4 = 32 values a channel, a 32/31 step)."""
    sd, variables, port = _trunk_case(0)
    x = orc.images(0)
    _, _, new = _run(ji.IRSEBackbone(train=False), ji.IRSEBackbone(train=True),
                     variables, port, x, True)
    want = te.irse_state_dict_from_jax({"params": variables["params"],
                                        "batch_stats": new})
    assert max(orc.stats_errors(port.state_dict(), want).values()) <= STATS_TOL
    plain = ti.IRSEBackbone()
    for name, m in list(plain.named_modules()):
        if isinstance(m, ti.BatchNorm2d):
            parent = plain.get_submodule(name.rsplit(".", 1)[0]) \
                if "." in name else plain
            setattr(parent, name.rsplit(".", 1)[-1],
                    torch.nn.BatchNorm2d(m.num_features))
    plain.load_state_dict(orc.torch_sd(sd), strict=True)
    plain.train()
    with torch.no_grad():
        plain(torch.from_numpy(x))
    errs = orc.stats_errors(plain.state_dict(), want)
    assert max(errs.values()) > 100 * STATS_TOL
    # the deepest units' variance steps are 32/31 of flax's
    pre = "body.23.res_layer.4."
    v0 = orc.torch_sd(sd)[pre + "running_var"]
    step_plain = plain.state_dict()[pre + "running_var"] - 0.9 * v0
    step_flax = torch.from_numpy(want[pre + "running_var"].numpy()) - 0.9 * v0
    ratio = (step_plain / step_flax).median().item()
    assert abs(ratio - 32 / 31) < 1e-3, ratio


@functools.lru_cache(maxsize=None)
def _arcface_train_fns(num_layers, mode):
    """JAX's train-mode ArcFace returning its trunk's output too, and its
    head alone on a given trunk output (the trunk call intercepted)."""
    module = ji.ArcFaceBackbone(num_layers, mode, train=True)

    def full(v, x):
        return module.apply(
            v, x, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, ji.IRSEBackbone))

    def head(v, trunk_out):
        def pinned(next_fun, args, kwargs, context):
            if isinstance(context.module, ji.IRSEBackbone):
                return [], trunk_out
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(pinned):
            img = jnp.zeros((trunk_out.shape[0], 112, 112, 3), trunk_out.dtype)
            return module.apply(v, img, mutable=["batch_stats"])[0]

    return jax.jit(full), jax.jit(head)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("seed", orc.SEEDS)
@pytest.mark.parametrize("net", sorted(ARCFACE))
def test_arcface_matches_jax(net, seed, train):
    """Eval mode: the embedding.  Train mode: the trunk's output and every
    BN's running statistics in float32, and the head (BN, flatten,
    Linear, BatchNorm1d over the batch, unit norm) on JAX's trunk output
    in float64 on both sides, JAX's head reached by intercepting its
    trunk call.  Pinned because the BatchNorm1d divides each feature's
    deviation from its batch mean by a batch spread far smaller than the
    mean, so in float32 the trunk's rounding (2e-6 of its largest) reaches
    0.5-1.2e-5 of the embedding's largest at batch 8 and 1e-3 at batch 2
    (the head alone, fed the same trunk output); in float64 the head
    agrees within 1e-11."""
    num_layers, use_se = ARCFACE[net]
    mode = "ir_se" if use_se else "ir"
    sd, variables = _sd_and_vars(net, seed)
    port = orc.port_module(lambda: ti.ArcFaceBackbone(num_layers, mode), sd)
    x = orc.images(seed, size=112)
    if not train:
        jout, pout, _ = _run(ji.ArcFaceBackbone(num_layers, mode), None,
                             variables, port, x, False)
        assert pout[0].shape == (2, 512)
        np.testing.assert_allclose(np.linalg.norm(pout[0], axis=1), 1.0,
                                   rtol=1e-5)
        _hold(jout, pout, net)
        return
    full, head = _arcface_train_fns(num_layers, mode)
    _, new = full(variables, jnp.asarray(x))
    trunk_out = np.asarray(new["intermediates"]["trunk"]["__call__"][0][1])
    port.train()
    with torch.no_grad():
        _, got = port.trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
        port.head(got)                          # the head's BN statistics
    orc.assert_close(got.permute(0, 2, 3, 1), trunk_out, OUT_REL,
                     f"{net} trunk")
    _hold_stats(port, variables, orc.np_tree(new["batch_stats"]),
                te.arcface_state_dict_from_jax, net)
    with jax.enable_x64():
        want = head(jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 variables),
                    jnp.asarray(trunk_out, jnp.float64))
    port64 = orc.port_module(lambda: ti.ArcFaceBackbone(num_layers, mode),
                             sd).double().train()
    with torch.no_grad():
        emb = port64.head(torch.from_numpy(
            trunk_out.astype(np.float64)).permute(0, 3, 1, 2))
    orc.assert_close(emb, np.asarray(want), OUT_REL, f"{net} head")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("seed", orc.SEEDS)
def test_into_w_and_wplus_match_jax(seed, train):
    """IntoW at 64px; IntoWPlus at 256px, batch 1, where the trunk's
    16x16 map goes through the true 16 -> 7 adaptive pool."""
    cases = [
        ("into_w", tp.BackboneEncoderIntoW, jp.BackboneEncoderIntoW,
         te.backbone_encoder_into_w_state_dict_from_jax, orc.images(seed)),
        ("into_wplus", tp.BackboneEncoderIntoWPlus,
         jp.BackboneEncoderIntoWPlus,
         te.backbone_encoder_into_wplus_state_dict_from_jax,
         orc.images(seed, b=1, size=256)),
    ]
    for kind, build, jcls, bridge, x in cases:
        sd, variables = _sd_and_vars(kind, seed)
        port = orc.port_module(build, sd)
        jout, pout, new = _run(jcls(train=False), jcls(train=True),
                               variables, port, x, train)
        _hold(jout, pout, jcls.__name__)
        if train:
            _hold_stats(port, variables, new, bridge, jcls.__name__)
        else:
            back = bridge(variables)
            assert set(back) == set(port.state_dict())
    assert pout[0].shape == (1, 18, 512)


def _shapes_through_bridge(monkeypatch, bridge, jax_shapes):
    """The bridge's keys and shapes for a JAX shape tree, on zero-stride
    views (nothing of the tensors' size is allocated)."""
    leaves = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        jax_shapes)
    monkeypatch.setattr(te, "_torch_sd",
                        lambda sd: {k: tuple(v.shape) for k, v in sd.items()})
    return bridge(leaves)


@pytest.mark.parametrize("net", ["encoder", "arcface"])
def test_default_sizes_match_jax_on_meta(monkeypatch, net):
    """Trap 7: the default ``GradualStyleEncoder`` (IR-SE-50, 14 + 16
    heads of 512, 364.7M parameters) and the IR-SE-50 ArcFace, built on
    the meta device, have exactly the keys and shapes of the JAX
    ``init`` after the bridge."""
    if net == "encoder":
        jmod, size = jp.GradualStyleEncoder(), 256
        bridge = te.gradual_style_encoder_state_dict_from_jax
        build = tp.GradualStyleEncoder
    else:
        jmod, size = ji.ArcFaceBackbone(), 112
        bridge = te.arcface_state_dict_from_jax
        build = ti.ArcFaceBackbone
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    want = _shapes_through_bridge(monkeypatch, bridge, shapes)
    with torch.device("meta"):
        port = build()
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    want = {k: v for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    assert got == want
    if net == "encoder":
        n = sum(v.numel() for v in port.parameters())
        assert n == 364_681_136, n
