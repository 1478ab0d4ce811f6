"""The port's FID InceptionV3 (``transeditor_tpu_torch/metrics/inception.py``)
against the JAX package's, on the CPU in float32.

The network has no narrow variant (21.8M parameters at every size), so
it runs at its default width at batch 2.  Both packages load the same
random pytorch-fid-layout state dict (``torch_port_metrics_oracle.
fid_inception_sd``: He-scaled convs, BatchNorms with non-trivial
statistics), the JAX package through ``port_fid_inception_weights``, the
port through ``load_fid_inception``.  Features are held within
``FEAT_REL`` of the largest at 75px without the resize and at 64px
resized to 299.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transeditor_tpu.metrics import inception as ji

import torch_port_metrics_oracle as mo
from transeditor_tpu_torch.io.torch_export import inception_state_dict_from_jax
from transeditor_tpu_torch.metrics import inception as ti
from torch_port_disk import small_tmp_path  # noqa: F401
from torch_port_threads import torch_worker_threads  # noqa: F401

FEAT_REL = 1e-5
POOL_REL = 1e-6


@pytest.fixture(scope="module")
def weights():
    sd = mo.fid_inception_sd(0)
    return sd, ji.port_fid_inception_weights(sd)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(2, 9, 9, 5), (1, 17, 12, 3),
                                   (2, 8, 8, 4)])
@pytest.mark.parametrize("pool", ["max_pool_3x3_s2", "max_pool_3x3_s1_p1",
                                  "avg_pool_3x3_s1_p1_nocountpad"])
def test_pools_match_jax(pool, shape):
    x = np.random.RandomState(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(getattr(ji, pool)(jnp.asarray(x)))
    got = _nhwc(getattr(ti, pool)(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=POOL_REL, atol=POOL_REL)


@pytest.mark.parametrize("size,resize", [(75, False), (64, True)],
                         ids=["75px", "64px-to-299"])
def test_features_match_jax(weights, size, resize):
    sd, jvars = weights
    x = np.random.RandomState(size).uniform(
        -1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(ji.InceptionV3Features(
        resize_input=resize).apply)(jvars, jnp.asarray(x)))
    net = ti.load_fid_inception(mo.torch_sd(sd), resize_input=resize)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 2048) and got.dtype == torch.float32
    assert 0.1 < np.abs(want).max() < 1e3          # O(1) features
    assert mo.rel_err(got, want) <= FEAT_REL


def test_loader_folds_as_the_jax_porter_leaf_by_leaf(weights):
    sd, jvars = weights
    got = ti.load_fid_inception(mo.torch_sd(sd)).state_dict()
    want = inception_state_dict_from_jax(jax.tree.map(np.asarray, jvars))
    assert set(got) == set(want)
    assert len(got) == 3 * len(ti.conv_names(ti.load_fid_inception(
        mo.torch_sd(sd))))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # arrays load as tensors do
    from_np = ti.load_fid_inception(sd).state_dict()
    assert all(torch.equal(from_np[k], got[k]) for k in got)


def test_loader_reads_a_file_and_ignores_fc(weights, small_tmp_path):
    sd, _ = weights
    net = ti.load_fid_inception(mo.save_sd(small_tmp_path / "pt_inception.pth",
                                           sd))
    assert not net.training
    assert not any(k.startswith("fc") for k in net.state_dict())


@pytest.mark.parametrize("drop", ["Mixed_6c.branch7x7dbl_3.conv.weight",
                                  "Conv2d_1a_3x3.bn.running_var"])
def test_a_missing_key_raises_naming_it(weights, drop):
    sd = {k: v for k, v in weights[0].items() if k != drop}
    with pytest.raises(KeyError, match=drop.replace(".", r"\.")):
        ti.load_fid_inception(sd)


def test_random_init_and_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ti.InceptionV3Features()
    a = ti.InceptionV3Features(device="cpu", seed=1).state_dict()
    b = ti.InceptionV3Features(device="cpu", seed=1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["Mixed_7c.branch_pool.scale"].min()) == 1.0
    assert float(a["Mixed_7c.branch_pool.bias"].abs().max()) == 0.0
