"""The port's boundary trainer (``transeditor_tpu_torch/edit/boundary.py``)
and its C-SVC solver (``edit/linear_svc.py``) against the JAX package's
``train_boundary``, which fits ``sklearn.svm.SVC(kernel="linear")``.

On three seeded problems (512, 8,192 and 1,024 wide; a fraction, a count
above 1 and an ``invalid_value``): the rows handed to the fit are
bit-identical (the same ``RandomState`` split on the host), the printed
accuracy lines are identical, and the unit normals agree to a cosine
within ``COS_GAP`` of 1.  The solver stops at a KKT gap of 1e-6; libsvm
at its default 1e-3, whose own normal lies 4e-8 to 2e-7 (1 - cosine) from
a 1e-8 fit on such problems, so ``COS_GAP`` is 1e-6.  Against libsvm run
to 1e-10 the solver at 1e-9 meets its normal to 1e-9 and its intercept to
1e-6, also on a problem with bounded support vectors.
"""

import numpy as np
import pytest
import sklearn.svm
import torch

from transeditor_tpu.edit.boundary import train_boundary as jax_train

from transeditor_tpu_torch.edit import boundary as tb
from transeditor_tpu_torch.edit.linear_svc import fit_linear_svc
from torch_port_threads import torch_worker_threads  # noqa: F401

COS_GAP = 1e-6

# (N, D, chosen_ratio, invalid_value, seed)
PROBLEMS = [(400, 512, 0.25, None, 0),
            (1000, 8192, 150, None, 1),
            (600, 1024, 0.2, -1.0, 2)]


def _problem(n, d, invalid, seed):
    rng = np.random.RandomState(seed)
    latents = rng.randn(n, d).astype(np.float32)
    # scores that depend on a direction, plus noise
    direction = rng.randn(d).astype(np.float32)
    scores = (latents @ direction / np.sqrt(d)
              + 0.5 * rng.randn(n)).astype(np.float32)[:, None]
    if invalid is not None:
        scores[::7] = invalid
    return latents, scores


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


@pytest.mark.parametrize("n,d,ratio,invalid,seed", PROBLEMS)
def test_train_boundary_matches_jax(n, d, ratio, invalid, seed, capsys,
                                    monkeypatch):
    latents, scores = _problem(n, d, invalid, seed)
    fitted = {}
    sk_fit = sklearn.svm.SVC.fit

    def record_sk(self, x, y, *a, **k):
        fitted["jax"] = (np.array(x), np.array(y))
        return sk_fit(self, x, y, *a, **k)

    def record_port(x, y, **k):
        fitted["port"] = (np.array(x), np.array(y))
        return fit_linear_svc(x, y, **k)

    monkeypatch.setattr(sklearn.svm.SVC, "fit", record_sk)
    monkeypatch.setattr(tb, "fit_linear_svc", record_port)
    kw = dict(chosen_ratio=ratio, split_ratio=0.7, invalid_value=invalid,
              seed=seed)
    want = jax_train(latents, scores, **kw)
    want_line = capsys.readouterr().out
    got = tb.train_boundary(latents, scores, device="cpu", **kw)
    got_line = capsys.readouterr().out

    for a, b in zip(fitted["port"], fitted["jax"]):
        np.testing.assert_array_equal(a, b)
    assert got_line == want_line and got_line.startswith("boundary: train")
    assert got.shape == want.shape == (1, d) and got.dtype == np.float32
    assert abs(np.linalg.norm(got) - 1) < 1e-6
    assert 1 - _cos(got, want) < COS_GAP


def test_chosen_ratio_is_a_count_above_one_and_capped(monkeypatch):
    latents, scores = _problem(40, 16, None, 3)
    seen = []

    def record(x, y, **k):
        seen.append(len(x))
        return fit_linear_svc(x, y, **k)

    monkeypatch.setattr(tb, "fit_linear_svc", record)
    tb.train_boundary(latents, scores, chosen_ratio=10, verbose=False,
                      device="cpu")
    tb.train_boundary(latents, scores, chosen_ratio=0.25, verbose=False,
                      device="cpu")
    tb.train_boundary(latents, scores, chosen_ratio=1000, verbose=False,
                      device="cpu")          # capped at N // 2 = 20
    assert seen == [2 * 7, 2 * 7, 2 * 14]


def test_invalid_value_rows_are_dropped(monkeypatch):
    latents, scores = _problem(60, 8, -1.0, 4)
    seen = []
    monkeypatch.setattr(tb, "fit_linear_svc",
                        lambda x, y, **k: seen.append(x) or
                        fit_linear_svc(x, y, **k))
    tb.train_boundary(latents, scores, chosen_ratio=0.5, invalid_value=-1.0,
                      verbose=False, device="cpu")
    invalid = {tuple(r) for r in latents[scores[:, 0] == -1.0]}
    assert not invalid & {tuple(r) for r in seen[0]}


@pytest.mark.parametrize("latents,scores", [
    (np.zeros((4, 3, 2)), np.zeros(4)),
    (np.zeros((4, 3)), np.zeros(5)),
])
def test_bad_shapes_raise_as_jax(latents, scores):
    with pytest.raises(ValueError, match="latents must be"):
        jax_train(latents, scores)
    with pytest.raises(ValueError, match="latents must be"):
        tb.train_boundary(latents, scores, device="cpu")


def test_one_class_raises():
    with pytest.raises(ValueError, match="both classes"):
        fit_linear_svc(np.zeros((3, 2)), np.ones(3), device="cpu")


@pytest.mark.parametrize("n,d,sep", [(200, 64, 0.5), (160, 8, 0.3)])
def test_solver_meets_tight_libsvm(n, d, sep):
    """Against libsvm at 1e-10: the normal, the intercept (the free
    support vectors' mean) and the decision values.  The 8-wide problem
    is not separable: most support vectors sit at the bound C = 1."""
    rng = np.random.RandomState(n)
    y = (np.arange(n) % 2).astype(np.float64)
    x = (rng.randn(n, d) + sep * (2 * y[:, None] - 1)).astype(np.float32)
    ref = sklearn.svm.SVC(kernel="linear", tol=1e-10).fit(x, y)
    fit = fit_linear_svc(x, y, tol=1e-9, device="cpu")
    assert fit.kkt_gap < 1e-9 and fit.iterations > 0
    assert 1 - _cos(fit.coef.numpy(), ref.coef_) < 1e-9
    assert abs(fit.intercept - ref.intercept_[0]) < 1e-6
    np.testing.assert_allclose(fit.decision_function(x).numpy(),
                               ref.decision_function(x), atol=1e-5)
    np.testing.assert_array_equal(fit.predict(x).numpy(), ref.predict(x))
    alpha = fit.alpha.numpy()
    assert alpha.min() >= 0 and alpha.max() <= 1
    assert abs(alpha @ (2 * y - 1)) < 1e-9          # y^T a = 0
    if d == 8:
        assert (alpha == 1).sum() > n // 4          # bounded SVs


def test_train_boundary_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    latents, scores = _problem(40, 16, None, 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.train_boundary(latents, scores, verbose=False)
