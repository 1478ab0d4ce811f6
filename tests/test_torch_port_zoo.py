"""The port's perceptual zoo (``transeditor_tpu_torch/zoo/``) against the
JAX package's, on the CPU in float32.

No pretrained weights are in the repository, so random state dicts are
built in each layout the loaders take (He-scaled normal convs, seeded
with numpy): torchvision's ``features.{idx}.*`` / ``classifier.{0,3}.*``,
richzhang's LPIPS (``lin{i}.model.1.weight`` beside ``features.*``),
StarGAN-v2's (``alexnet.layers.*``, ``lpips_weights.{i}.main.1.weight``)
and heads only plus a torchvision ``backbone_sd``.  The same dict goes
through the JAX porters (``port_alexnet``, ``port_vgg``,
``port_vgg16_fc7``, ``load_lpips_params``) into JAX, and loads with
``strict=True`` into the port.

Tolerances: feature maps, fc7 features and the VGG19 loss within 1e-4 of
each tensor's largest magnitude (convolutions sum in another order);
per-sample LPIPS distances within 1e-5 relative.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transeditor_tpu.zoo import backbones as jb
from transeditor_tpu.zoo import lpips as jl

from transeditor_tpu_torch.zoo import backbones as tb
from transeditor_tpu_torch.zoo import lpips as tl
from torch_port_threads import torch_worker_threads  # noqa: F401

FEAT_REL = 1e-4
LPIPS_REL = 1e-5

ALEX_CONVS = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3),
              (256, 256, 3)]
ALEX_IDX = (0, 3, 6, 8, 10)


def _he(rng, o, i, k):
    w = rng.standard_normal((o, i, k, k), dtype=np.float32)
    return w * np.float32(np.sqrt(2.0 / (i * k * k)))


def _alex_sd(seed, prefix="features."):
    rng = np.random.default_rng(seed)
    sd = {}
    for idx, (o, i, k) in zip(ALEX_IDX, ALEX_CONVS):
        sd[f"{prefix}{idx}.weight"] = _he(rng, o, i, k)
        sd[f"{prefix}{idx}.bias"] = 0.1 * rng.standard_normal(
            o, dtype=np.float32)
    return sd


def _vgg_sd(seed, cfg, prefix="features."):
    rng = np.random.default_rng(seed)
    sd, idx, in_ch = {}, 0, 3
    for v in cfg:
        if v == "M":
            idx += 1
            continue
        sd[f"{prefix}{idx}.weight"] = _he(rng, v, in_ch, 3)
        sd[f"{prefix}{idx}.bias"] = 0.1 * rng.standard_normal(
            v, dtype=np.float32)
        idx, in_ch = idx + 2, v
    return sd


def _heads(seed, net, key):
    rng = np.random.default_rng(seed)
    chans = tl.ALEX_CHANNELS if net == "alex" else tl.VGG_CHANNELS
    return {key.format(i=i): np.abs(rng.standard_normal(
        (1, c, 1, 1), dtype=np.float32)) for i, c in enumerate(chans)}


def _images(seed, b=3, size=64):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


def _close_rel(got, want, rel, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * top, f"{name}: {err} > {rel} * {top}"


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def test_alexnet_taps_match_jax():
    sd = _alex_sd(0)
    x = _images(1)
    want = jb.AlexNetFeatures().apply(jb.port_alexnet(sd), jnp.asarray(x))
    with torch.no_grad():
        got = _load(tb.AlexNetFeatures(), sd)(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for i, (a, b) in enumerate(zip(got, want)):
        _close_rel(a, b, FEAT_REL, f"relu{i + 1}")


@pytest.mark.parametrize("depth", [16, 19])
def test_vgg_taps_match_jax(depth):
    cfg, taps = ((jb.VGG16_CFG, jb.VGG16_TAPS) if depth == 16
                 else (jb.VGG19_CFG, jb.VGG19_TAPS))
    sd = _vgg_sd(depth, cfg)
    x = _images(2)
    n_convs = sum(v != "M" for v in cfg)
    want = jb.VGGFeatures(tuple(cfg), taps).apply(jb.port_vgg(sd, n_convs),
                                                  jnp.asarray(x))
    with torch.no_grad():
        got = _load(tb.VGGFeatures(tb.VGG16_CFG if depth == 16
                                   else tb.VGG19_CFG, taps),
                    sd)(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for i, (a, b) in enumerate(zip(got, want)):
        _close_rel(a, b, FEAT_REL, f"tap {i}")


def test_vgg16_fc7_matches_jax_through_the_2x2_to_7x7_pool():
    """64px: the last feature map is 2x2, so the adaptive pool repeats
    cells and the flatten before fc6 must be channel-major."""
    sd = _vgg_sd(3, jb.VGG16_CFG)
    rng = np.random.default_rng(4)
    sd["classifier.0.weight"] = rng.standard_normal(
        (4096, 512 * 49), dtype=np.float32) * np.float32(
        np.sqrt(2.0 / (512 * 49)))
    sd["classifier.0.bias"] = 0.1 * rng.standard_normal(4096,
                                                        dtype=np.float32)
    sd["classifier.3.weight"] = rng.standard_normal(
        (4096, 4096), dtype=np.float32) * np.float32(np.sqrt(2.0 / 4096))
    sd["classifier.3.bias"] = 0.1 * rng.standard_normal(4096,
                                                        dtype=np.float32)
    x = _images(5, b=2)
    want = jb.VGG16Fc7().apply(jb.port_vgg16_fc7(sd), jnp.asarray(x))
    with torch.no_grad():
        got = _load(tb.VGG16Fc7(), sd)(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 4096)
    _close_rel(got, want, FEAT_REL, "fc7")


def test_vgg19_perceptual_loss_matches_jax():
    sd = _vgg_sd(6, jb.VGG19_CFG)
    x, y = _images(7, b=2), _images(8, b=2)
    jfeat = jb.VGGFeatures(tuple(jb.VGG19_CFG), jb.VGG19_TAPS)
    want = float(jb.vgg19_perceptual_loss(
        jfeat.apply, jb.port_vgg(sd, 16), jnp.asarray(x), jnp.asarray(y)))
    feats = _load(tb.VGGFeatures(tb.VGG19_CFG, tb.VGG19_TAPS), sd)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tb.vgg19_perceptual_loss(feats, xt, torch.from_numpy(y))
    np.testing.assert_allclose(float(got.detach()), want, rtol=FEAT_REL)
    # differentiable in x (the reference's training loss)
    grad, = torch.autograd.grad(got, xt)
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0


@pytest.mark.parametrize("stride,padding,bias", [(1, 1, True), (2, 0, False),
                                                 (4, 2, True)])
def test_conv2d_matches_jax(stride, padding, bias):
    """The NHWC conv with a torch-layout weight against JAX's with the
    same weight in HWIO, within 1e-5 of the output's largest magnitude."""
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 13, 11, 6), dtype=np.float32)
    w = rng.standard_normal((5, 6, 3, 3), dtype=np.float32)
    b = rng.standard_normal(5, dtype=np.float32) if bias else None
    want = np.asarray(jb.conv2d(jnp.asarray(x), jnp.asarray(
        w.transpose(2, 3, 1, 0)), None if b is None else jnp.asarray(b),
        stride, padding))
    got = tb.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    None if b is None else torch.from_numpy(b), stride,
                    padding).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n_in,n_out", [(8, 7), (2, 7), (7, 7), (16, 7),
                                        (188, 112)])
def test_adaptive_avg_pool_matches_jax(n_in, n_out):
    x = np.random.RandomState(n_in).randn(2, n_in, n_in, 5).astype(
        np.float32)
    want = jb.adaptive_avg_pool_2d(jnp.asarray(x), (n_out, n_out))
    got = tb.adaptive_avg_pool_2d(torch.from_numpy(x), (n_out, n_out))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("window,stride,n", [(3, 2, 15), (3, 2, 16),
                                             (2, 2, 9)])
def test_max_pool_takes_valid_windows_as_jax(window, stride, n):
    x = np.random.RandomState(n).randn(2, n, n, 4).astype(np.float32)
    want = jb.max_pool(jnp.asarray(x), window, stride)
    got = tb.max_pool(torch.from_numpy(x), window, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lpips_case(net, layout):
    """(checkpoint dict, backbone_sd or None) in ``layout``."""
    if net == "alex":
        backbone = _alex_sd(10, "alexnet.layers." if layout == "stargan"
                            else "features.")
    else:
        backbone = _vgg_sd(11, jb.VGG16_CFG)
    head_key = ("lpips_weights.{i}.main.1.weight" if layout == "stargan"
                else "lin{i}.model.1.weight")
    heads = _heads(12, net, head_key)
    if layout == "heads+backbone_sd":
        return heads, backbone
    return {**backbone, **heads}, None


LPIPS_CASES = [("alex", "richzhang"), ("alex", "stargan"),
               ("alex", "heads+backbone_sd"), ("vgg", "richzhang"),
               ("vgg", "heads+backbone_sd")]


@pytest.mark.parametrize("use_linear", [True, False])
@pytest.mark.parametrize("net,layout", LPIPS_CASES)
def test_lpips_matches_jax(net, layout, use_linear):
    sd, backbone_sd = _lpips_case(net, layout)
    x, y = _images(13), _images(14)
    want = jl.LPIPS(net=net, use_linear=use_linear).apply(
        jl.load_lpips_params(sd, net=net, backbone_sd=backbone_sd),
        jnp.asarray(x), jnp.asarray(y))
    ours = tl.LPIPS(net, use_linear, device="cpu")
    ours.load_state_dict(tl.load_lpips_params(sd, net, backbone_sd),
                         strict=True)
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LPIPS_REL)
    # the same images give 0, other images a positive distance
    with torch.no_grad():
        same = ours(torch.from_numpy(x), torch.from_numpy(x))
    assert float(same.abs().max()) == 0.0 and bool((got > 0).all())


def test_heads_only_checkpoint_warns_and_takes_a_random_backbone():
    heads = _heads(15, "vgg", "lin{i}.model.1.weight")
    with pytest.warns(UserWarning, match="RANDOM"):
        sd = tl.load_lpips_params(heads, "vgg")
    net = tl.LPIPS("vgg", device="cpu")
    net.load_state_dict(sd, strict=True)
    torch.testing.assert_close(net.lin2, torch.from_numpy(
        heads["lin2.model.1.weight"].reshape(-1)))
    with pytest.raises(KeyError, match="linear head 4"):
        tl.load_lpips_params({k: v for k, v in heads.items()
                              if not k.startswith("lin4")}, "vgg",
                             backbone_sd=_vgg_sd(16, jb.VGG16_CFG))


def test_full_torchvision_dicts_load_strict():
    """A torchvision vgg16 / alexnet state dict (features and classifier)
    feeds the LPIPS loader, whose result loads with strict=True."""
    vgg = _vgg_sd(17, jb.VGG16_CFG)
    vgg.update({"classifier.0.weight": np.zeros((8, 8), np.float32),
                "classifier.6.bias": np.zeros(8, np.float32)})
    heads = _heads(18, "vgg", "lin{i}.model.1.weight")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sd = tl.load_lpips_params(heads, "vgg", backbone_sd=vgg)
    tl.LPIPS("vgg", device="cpu").load_state_dict(sd, strict=True)
    _load(tb.AlexNetFeatures(), _alex_sd(19))
    _load(tb.VGGFeatures(tb.VGG19_CFG, tb.VGG19_TAPS),
          _vgg_sd(20, jb.VGG19_CFG))


def test_pairwise_diversity_matches_jax():
    sd, _ = _lpips_case("alex", "stargan")
    groups = [_images(30 + i, b=2) for i in range(3)]
    jnet = jl.LPIPS(net="alex")
    want = jl.lpips_pairwise_diversity(jnet.apply,
                                       jl.load_lpips_params(sd, "alex"),
                                       groups)
    ours = tl.LPIPS("alex", device="cpu")
    ours.load_state_dict(tl.load_lpips_params(sd, "alex"), strict=True)
    got = tl.lpips_pairwise_diversity(ours, groups)
    np.testing.assert_allclose(got, want, rtol=LPIPS_REL)


def test_lpips_runs_on_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.LPIPS("vgg")
