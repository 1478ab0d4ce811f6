"""The port's PIL-free face alignment (``utils/face_align.py``,
``cli/align.py``) against the JAX package's (PIL), on the CPU.

Synthetic images (smooth seeded patterns with seeded noise) and
synthetic 68-point landmarks (eyes, mouth corners).  Tolerances: the
crop quad equal (float64, the same arithmetic); the quad warp equal to
PIL's ``QUAD`` / ``BILINEAR`` transform byte for byte; ``align_face``
>= 40 dB PSNR against JAX's in each regime (plain, shrink, padding, a
rotated face, a final LANCZOS resize), where the largest level
difference measured is 0: every step is PIL's arithmetic; the CLI's
file tree equal to JAX's, its images >= 40 dB.
"""

import os

import numpy as np
import pytest
import scipy.ndimage
from PIL import Image

from transeditor_tpu.cli import align as jalign_cli
from transeditor_tpu.utils import face_align as jfa

from transeditor_tpu_torch.cli import align as align_cli
from transeditor_tpu_torch.utils import face_align as fa
from transeditor_tpu_torch.utils.image import load_image


def landmarks(eye_l, eye_r, mouth_l, mouth_r):
    lm = np.zeros((68, 2))
    lm[36:42] = eye_l
    lm[42:48] = eye_r
    lm[48] = mouth_l
    lm[54] = mouth_r
    return lm


def synth_image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    small = rng.rand(12, 12, 3) * 255
    base = scipy.ndimage.zoom(small, (h / 12, w / 12, 1), order=1)
    return np.clip(base + rng.randint(-20, 21, (h, w, 3)), 0,
                   255).astype(np.uint8)


# name: (image, landmarks, output size, transform size)
REGIMES = {
    "plain": (synth_image(256, 256), landmarks((100, 110), (156, 110),
                                               (110, 170), (146, 170)),
              64, 64),
    "shrink": (synth_image(1024, 1024, 1),
               landmarks((400, 450), (624, 452), (430, 640), (600, 642)),
               64, 64),
    "padding": (synth_image(256, 256, 2),
                landmarks((20, 40), (76, 44), (30, 100), (66, 104)), 64, 64),
    "rotated": (synth_image(300, 260, 3),
                landmarks((90, 130), (160, 100), (120, 200), (180, 175)),
                128, 128),
    "resized": (synth_image(256, 256, 4),
                landmarks((100, 110), (156, 110), (110, 170), (146, 170)),
                48, 96),
}


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def test_crop_quad_equals_jax():
    for img, lm, _, _ in REGIMES.values():
        quad, qsize = fa.ffhq_crop_quad(lm)
        jquad, jqsize = jfa.ffhq_crop_quad(lm)
        np.testing.assert_array_equal(quad, jquad)
        assert qsize == jqsize
    with pytest.raises(ValueError):
        fa.ffhq_crop_quad(np.zeros((5, 2)))


@pytest.mark.parametrize("quad", [
    [[3.2, 4.1], [5.5, 33.7], [40.2, 30.3], [38.9, 2.2]],
    [[-5.0, -4.0], [-3.0, 45.0], [60.0, 44.0], [58.0, -6.0]],
    [[10.0, 0.5], [0.5, 30.0], [30.0, 39.5], [49.5, 10.0]]])
def test_quad_warp_equals_pil(quad):
    img = np.random.RandomState(5).randint(0, 256, (40, 50, 3)).astype(
        np.uint8)
    q = np.asarray(quad)
    want = np.asarray(Image.fromarray(img).transform(
        (32, 32), Image.QUAD, q.flatten(), Image.BILINEAR))
    np.testing.assert_array_equal(fa.quad_warp_bilinear(img, q, 32), want)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_align_face_matches_jax(regime):
    img, lm, out, transform = REGIMES[regime]
    _, qsize = fa.ffhq_crop_quad(lm)
    if regime == "shrink":
        assert qsize >= 4 * out            # the LANCZOS shrink runs
    if regime == "padding":
        quad, _ = fa.ffhq_crop_quad(lm)
        assert quad.min() < 0              # the quad leaves the image
    want = jfa.align_face(img, lm, output_size=out, transform_size=transform)
    got = fa.align_face(img, lm, output_size=out, transform_size=transform)
    assert got.dtype == np.uint8 and got.shape == (out, out, 3)
    assert _psnr(got, want) >= 40.0


def test_dlib_provider_raises_import_error():
    with pytest.raises(ImportError, match="landmarks"):
        fa.dlib_landmark_provider("shape_predictor_68.dat")


def _raw_dir(root):
    raw = root / "raw"
    raw.mkdir()
    img, lm, _, _ = REGIMES["plain"]
    Image.fromarray(img).save(raw / "a.png")
    Image.fromarray(img[:, ::-1].copy()).save(raw / "c.png")    # no landmarks
    Image.fromarray(img[::-1].copy()).save(raw / "b.jpg", quality=95)
    lms = {"a.png": lm, "b.jpg": lm}
    np.savez(root / "lm.npz", **lms)
    return raw


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_align_cli_matches_jax(tmp_path, capsys):
    raw = _raw_dir(tmp_path)
    argv = ["--root_path", str(raw), "--landmarks",
            str(tmp_path / "lm.npz"), "--output_size", "32"]
    jalign_cli.main(argv + ["--out_path", str(tmp_path / "jax")])
    align_cli.main(argv + ["--out_path", str(tmp_path / "port")])
    assert "skipped c.png" in capsys.readouterr().out
    want = ["a.png", "b.jpg"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") == want
    for name in want:
        got = load_image(str(tmp_path / "port" / name))
        ref = np.asarray(Image.open(tmp_path / "jax" / name).convert("RGB"))
        assert got.shape == ref.shape == (32, 32, 3)
        assert _psnr(got, ref) >= 40.0


def test_align_cli_refuses_an_unwritable_format_first(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    img, lm, _, _ = REGIMES["plain"]
    Image.fromarray(img).save(raw / "a.png")
    Image.fromarray(img).save(raw / "z.bmp")
    np.savez(tmp_path / "lm.npz", **{"a.png": lm, "z.bmp": lm})
    with pytest.raises(ValueError, match="z.bmp"):
        align_cli.main(["--root_path", str(raw), "--out_path",
                        str(tmp_path / "out"), "--landmarks",
                        str(tmp_path / "lm.npz"), "--output_size", "32"])
    assert not (tmp_path / "out").exists()      # nothing was aligned
