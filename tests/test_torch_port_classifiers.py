"""The port's editing classifiers (``transeditor_tpu_torch/zoo/resnet.py``,
``edit/classifiers.py``, ``edit/celebahq_classifier.py``) and their
weight bridges (``io/torch_export.py``) against the JAX package, on the
CPU in float32.

Each network gets a random reference-layout state dict drawn with numpy
(``torch_port_edit_oracle``): into JAX through the JAX package's
``port_*``, into the port with ``strict=True``; the same numpy images go
through both.  The DEX nets run narrowed (``VGG_PLAN`` swapped in both
packages), except ``test_dex_default_size_matches_jax`` (138M parameters,
batch 1); the CelebA-HQ net runs narrowed (``_nf`` swapped in both).
Tolerances: features, logits and DEX ages within 1e-4 of the largest
magnitude (convolutions sum in another order); probabilities and scores
within 2e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transeditor_tpu.edit import celebahq_classifier as jceleb
from transeditor_tpu.edit import classifiers as jcls
from transeditor_tpu.zoo.resnet import ResNet18Features as JaxResNet

import torch_port_edit_oracle as eo
from transeditor_tpu_torch.edit import celebahq_classifier as tceleb
from transeditor_tpu_torch.edit import classifiers as tcls
from transeditor_tpu_torch.io import torch_export as tx
from transeditor_tpu_torch.zoo.resnet import ResNet18Features
from torch_port_threads import torch_worker_threads  # noqa: F401

REL = 1e-4
PROB_ATOL = 2e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_resnet18_features_match_jax(seed):
    sd = eo.pose_sd(seed)
    jv = jcls.port_pose_classifier(sd)
    img = eo.images(seed, b=2, size=64)
    want = JaxResNet().apply({"params": jv["params"]["backbone"],
                              "batch_stats": jv["batch_stats"]["backbone"]},
                             jnp.asarray(img))
    trunk = eo.port_module(ResNet18Features, {
        k[len("backbone."):]: v for k, v in sd.items()
        if k.startswith("backbone.")})
    got = trunk(torch.from_numpy(img))
    assert got.shape == (2, 512)
    eo.assert_close(got, want, REL, "resnet18 features")


def test_resnet18_batchnorm_reads_running_stats_in_train_mode():
    sd = eo.pose_sd(2)
    net = eo.port_module(tcls.PoseClassifier, sd)
    x = torch.from_numpy(eo.images(2, b=2, size=32))
    want = net.eval()(x)
    got = net.train()(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for k, v in net.state_dict().items():
        if k.endswith("running_mean"):
            np.testing.assert_array_equal(v.numpy(), sd[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_classifier_matches_jax(seed):
    sd = eo.pose_sd(seed)
    jv = jcls.port_pose_classifier(sd)
    img = eo.images(seed, b=2, size=64)
    want = jcls.PoseClassifier().apply(jv, jnp.asarray(img))
    net = eo.port_module(tcls.PoseClassifier, sd)
    np.testing.assert_allclose(_np(net(torch.from_numpy(img))),
                               np.asarray(want), atol=PROB_ATOL, rtol=0)
    # the scorer: [-1, 1] RGB -> rounded BGR 0..255 -> P(class 0)
    want_s = jcls.make_scorer("pose", jv)(jnp.asarray(img))
    got_s = tcls.make_scorer("pose", net, device="cpu")(img)
    assert got_s.dtype == torch.float32 and got_s.shape == (2,)
    np.testing.assert_allclose(_np(got_s), np.asarray(want_s),
                               atol=PROB_ATOL, rtol=0)


def test_pose_bridge_inverts_the_jax_porter():
    sd = eo.pose_sd(3)
    jv = jcls.port_pose_classifier(sd)
    back = tx.pose_classifier_state_dict_from_jax(jv)
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    net = eo.port_module(tcls.PoseClassifier,
                         {k: v.numpy() for k, v in back.items()})
    img = eo.images(3, b=2, size=48)
    np.testing.assert_allclose(
        _np(net(torch.from_numpy(img))),
        np.asarray(jcls.PoseClassifier().apply(jv, jnp.asarray(img))),
        atol=PROB_ATOL, rtol=0)


@pytest.mark.parametrize("attr,classes,seed",
                         [("age", 101, 0), ("age", 101, 1),
                          ("gender", 2, 2)])
def test_dex_narrow_matches_jax(attr, classes, seed):
    with eo.narrow_dex():
        sd = eo.dex_sd(seed, classes)
        jv = jcls.port_dex_vgg(sd)
        img = eo.images(seed, b=2, size=256)
        feed = jcls.dex_preprocess(jnp.asarray(img))
        want = jcls.DexVGG(classes=classes).apply(jv, feed)
        net = eo.port_module(lambda: tcls.DexVGG(classes), sd)
        got = net(torch.from_numpy(np.array(feed)))
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=PROB_ATOL, rtol=0)
        assert float(np.asarray(want).max()) < 0.9     # not saturated
        want_s = np.asarray(jcls.make_scorer(attr, jv)(jnp.asarray(img)))
        got_s = _np(tcls.make_scorer(attr, net, device="cpu")(img))
    if attr == "age":
        eo.assert_close(got_s, want_s, REL, "expected age")
    else:
        np.testing.assert_allclose(got_s, want_s, atol=PROB_ATOL, rtol=0)


def test_dex_bridge_inverts_the_jax_porter():
    with eo.narrow_dex():
        sd = eo.dex_sd(4, 2)
        back = tx.dex_vgg_state_dict_from_jax(jcls.port_dex_vgg(sd))
        assert set(back) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
        # the port's module names are the DEX layout
        net = eo.port_module(lambda: tcls.DexVGG(2), sd)
        assert set(net.state_dict()) == set(sd)


def test_dex_default_size_matches_jax():
    """The one default-size DEX test: VGG16 with 4096-wide heads (138M
    parameters) on one 256px image, age."""
    sd = eo.dex_sd(5, 101)
    jv = jcls.port_dex_vgg(sd)
    img = eo.images(5, b=1, size=256)
    want = np.asarray(jcls.make_scorer("age", jv)(jnp.asarray(img)))
    del jv
    net = tcls.classifier_from_state_dict("age", eo.torch_sd(sd))
    del sd
    got = _np(tcls.make_scorer("age", net, device="cpu")(img))
    assert got.shape == (1,)
    eo.assert_close(got, want, REL, "default-size DEX age")


@pytest.mark.parametrize("size", [32, 64, 128, 224, 256])
def test_dex_preprocess_and_center_crop_match_jax(size):
    img = eo.images(size, b=2, size=size)
    img[0, 0, 0] = [-1.5, 1.5, 0.0]          # clipped
    want = np.asarray(jcls.dex_preprocess(jnp.asarray(img)))
    got = tcls.dex_preprocess(torch.from_numpy(img))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    crop = tcls.center_crop_224(torch.from_numpy(img))
    np.testing.assert_array_equal(
        crop.numpy(), np.asarray(jcls.center_crop_224(jnp.asarray(img))))


def test_expected_age_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 101)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = np.asarray(jcls.expected_age(jnp.asarray(probs)))
    got = tcls.expected_age(torch.from_numpy(probs))
    eo.assert_close(got, want, 1e-6, "expected age")


@pytest.mark.parametrize("seed", [0, 1])
def test_celebahq_logit_matches_jax(seed):
    with eo.narrow_celebahq():
        sd = eo.celebahq_sd(seed)
        jv = jceleb.port_celebahq_classifier(sd)
        img = 0.3 * eo.images(seed, b=2, size=256)
        want = jceleb.CelebAHQAttributeClassifier().apply(
            jv, jnp.asarray(img))
        net = eo.port_module(tceleb.CelebAHQAttributeClassifier, sd)
        got = net(torch.from_numpy(img))
    assert got.shape == (2,)
    eo.assert_close(got, want, REL, "celeba-hq logit")


@pytest.mark.parametrize("size", [64, 256, 512])
def test_celebahq_scorer_up_and_down_matches_jax(size):
    with eo.narrow_celebahq():
        sd = eo.celebahq_sd(7)
        jv = jceleb.port_celebahq_classifier(sd)
        img = eo.images(size, b=2, size=size)
        want = np.asarray(jceleb.make_celebahq_scorer(jv)(jnp.asarray(img)))
        net = eo.port_module(tceleb.CelebAHQAttributeClassifier, sd)
        got = _np(tceleb.make_celebahq_scorer(net, device="cpu")(img))
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
    assert 0.01 < want.min() and want.max() < 0.99     # not saturated


@pytest.mark.parametrize("size", [32, 64, 512])
def test_box_downsample_256_matches_jax(size):
    img = eo.images(size, b=1, size=size)
    want = np.asarray(jceleb.box_downsample_256(jnp.asarray(img)))
    got = tceleb.box_downsample_256(torch.from_numpy(img))
    assert got.shape == (1, 256, 256, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_celebahq_bridge_and_layout():
    with eo.narrow_celebahq():
        sd = eo.celebahq_sd(8)
        back = tx.celebahq_classifier_state_dict_from_jax(
            jceleb.port_celebahq_classifier(sd))
        net = eo.port_module(tceleb.CelebAHQAttributeClassifier, sd)
    assert set(back) == set(sd) == set(net.state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    assert "fromrgb_lod0.conv.conv.weight" in sd and "4x4.dense1.wscale.b" in sd


def test_celebahq_attributes_match_jax():
    assert tceleb.CELEBAHQ_ATTRIBUTES == jceleb.CELEBAHQ_ATTRIBUTES
    assert len(tceleb.CELEBAHQ_ATTRIBUTES) == 40
    assert [tceleb._nf(s) for s in range(9)] == \
        [jceleb._nf(s) for s in range(9)]


@pytest.mark.parametrize("attr", ["pose", "gender", "Smiling"])
def test_load_scorer_from_checkpoint_dispatches_as_jax(attr, tmp_path):
    with eo.narrow_dex(), eo.narrow_celebahq():
        sd = {"pose": eo.pose_sd, "gender": lambda s: eo.dex_sd(s, 2),
              "Smiling": eo.celebahq_sd}[attr](9)
        path = eo.save_sd(tmp_path / f"{attr}.pth", sd)
        img = eo.images(9, b=2, size=224 if attr == "gender" else 64)
        want = np.asarray(jcls.load_scorer_from_checkpoint(attr, path)(
            jnp.asarray(img)))
        got = _np(tcls.load_scorer_from_checkpoint(attr, path,
                                                   device="cpu")(img))
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)


def test_random_classifier_is_seeded():
    a = tcls.random_classifier("pose", torch.Generator().manual_seed(0))
    b = tcls.random_classifier("pose", torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    bn = a.backbone[1]
    assert bool((bn.running_var == 1).all()) and bool((bn.weight == 1).all())
    with eo.narrow_celebahq():
        c = tcls.random_classifier("Male", torch.Generator().manual_seed(0))
    w = c.fromrgb_lod0.conv.conv.weight.detach()
    assert abs(float(w.std()) - 1) < 0.5       # N(0, 1), as the JAX init


def test_scorer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcls.make_scorer("pose", eo.port_module(tcls.PoseClassifier,
                                                eo.pose_sd(0)))
