"""FFHQ-style face alignment without PIL (``transeditor_tpu/utils/
face_align.py``; the published NVlabs/ffhq-dataset recipe of the pSp
``align_all_parallel.py``): 68-point landmarks -> oriented crop quad ->
shrink / crop / reflect-pad / quad warp to the output size.

The card's machine has no PIL, so each PIL step is written out in numpy
and scipy: the shrink is the port's PIL-exact LANCZOS resize
(``utils/image.py::resize_lanczos``), the crop a slice, the reflect pad
and blurred-edge blend ``np.pad`` and ``scipy.ndimage.gaussian_filter``
(as the JAX package does), and PIL's ``QUAD`` transform with
``BILINEAR`` resampling is ``quad_warp_bilinear``.  The landmark
provider is pluggable: any [68, 2] array works.  This is host
preprocessing, as in the JAX package: one warp an image, no device.
"""

from __future__ import annotations

import numpy as np

from transeditor_tpu_torch.utils.image import resize_lanczos


def ffhq_crop_quad(landmarks: np.ndarray) -> tuple[np.ndarray, float]:
    """68-point landmarks -> (oriented crop quad [4,2], qsize).

    The FFHQ geometry (align_all_parallel.py:62-87): x-axis along the
    eye line, sized by max(eye distance * 2, eye-to-mouth * 1.8),
    centred at eye_avg + 0.1 * eye_to_mouth; float64 throughout.
    """
    lm = np.asarray(landmarks, np.float64)
    if lm.shape != (68, 2):
        raise ValueError(f"expected [68,2] landmarks, got {lm.shape}")
    eye_left = lm[36:42].mean(axis=0)
    eye_right = lm[42:48].mean(axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    return quad, float(np.hypot(*x) * 2)


def quad_warp_bilinear(img: np.ndarray, quad: np.ndarray,
                       size: int) -> np.ndarray:
    """PIL's ``img.transform((size, size), QUAD, quad.flatten(),
    BILINEAR)`` for an [H, W, C] uint8 image; ``quad`` holds the source
    corners NW, SW, SE, NE.

    Output pixel (x, y) samples the source at its centre's image under
    the bilinear map of the unit square onto the quad, then bilinearly
    between the four nearest source pixel centres (edges clamped, the
    row below dropped past the last row, as PIL does) and truncates to
    uint8; a centre that maps outside the image is 0.
    """
    h, w, _ = img.shape
    nw, sw, se, ne = np.asarray(quad, np.float64).reshape(4, 2)
    x0, y0 = nw
    s = 1.0 / size
    ax = (x0, (ne[0] - x0) * s, (sw[0] - x0) * s,
          (se[0] - sw[0] - ne[0] + x0) * s * s)
    ay = (y0, (ne[1] - y0) * s, (sw[1] - y0) * s,
          (se[1] - sw[1] - ne[1] + y0) * s * s)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) + 0.5
    xin = ax[0] + ax[1] * xx + ax[2] * yy + ax[3] * xx * yy
    yin = ay[0] + ay[1] * xx + ay[2] * yy + ay[3] * xx * yy
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)

    xs, ys = xin - 0.5, yin - 0.5
    xf, yf = np.floor(xs), np.floor(ys)
    dx, dy = (xs - xf)[..., None], (ys - yf)[..., None]
    xi, yi = xf.astype(np.int64), yf.astype(np.int64)
    xa, xb = np.clip(xi, 0, w - 1), np.clip(xi + 1, 0, w - 1)
    ya, yb = np.clip(yi, 0, h - 1), np.clip(yi + 1, 0, h - 1)
    src = img.astype(np.float64)
    top = src[ya, xa] + (src[ya, xb] - src[ya, xa]) * dx
    bottom = src[yb, xa] + (src[yb, xb] - src[yb, xa]) * dx
    bottom = np.where(((yi + 1 >= 0) & (yi + 1 < h))[..., None], bottom, top)
    out = (top + (bottom - top) * dy).astype(np.uint8)
    out[~inside] = 0
    return out


def align_face(
    image: np.ndarray,
    landmarks: np.ndarray,
    output_size: int = 256,
    transform_size: int = 256,
    enable_padding: bool = True,
) -> np.ndarray:
    """Align a face image given its 68-point landmarks.

    Args:
      image: [H, W, 3] uint8 RGB.
      landmarks: [68, 2] (x, y) pixel coordinates.

    Returns:
      [output_size, output_size, 3] uint8 aligned crop: shrink for large
      faces, bordered crop, reflect-pad with a blurred edge blend when
      the quad leaves the image, quad warp (align_all_parallel.py:89-140).
    """
    import scipy.ndimage

    quad, qsize = ffhq_crop_quad(landmarks)
    img = np.asarray(image, np.uint8)

    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        h, w, _ = img.shape
        img = resize_lanczos(img, int(np.rint(w / shrink)),
                             int(np.rint(h / shrink)))
        quad = quad / shrink
        qsize /= shrink

    border = max(int(np.rint(qsize * 0.1)), 3)
    h, w, _ = img.shape
    crop = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
            int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, w), min(crop[3] + border, h))
    if crop[2] - crop[0] < w or crop[3] - crop[1] < h:
        img = img[crop[1]:crop[3], crop[0]:crop[2]]
        quad = quad - crop[0:2]

    h, w, _ = img.shape
    pad = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
           int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - w + border, 0), max(pad[3] - h + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad_arr = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(np.float32(img),
                     ((pad_arr[1], pad_arr[3]), (pad_arr[0], pad_arr[2]),
                      (0, 0)), "reflect")
        h, w, _ = arr.shape
        yy, xx, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(xx) / pad_arr[0],
                             np.float32(w - 1 - xx) / pad_arr[2]),
            1.0 - np.minimum(np.float32(yy) / pad_arr[1],
                             np.float32(h - 1 - yy) / pad_arr[3]))
        sigma = qsize * 0.02
        arr += ((scipy.ndimage.gaussian_filter(arr, [sigma, sigma, 0])
                 - arr) * np.clip(mask * 3.0 + 1.0, 0.0, 1.0))
        arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
        img = np.uint8(np.clip(np.rint(arr), 0, 255))
        quad = quad + pad_arr[:2]

    img = quad_warp_bilinear(img, quad + 0.5, transform_size)
    if output_size < transform_size:
        img = resize_lanczos(img, output_size, output_size)
    return img


def dlib_landmark_provider(predictor_path: str):
    """Build a ``path -> [68,2]`` landmark fn from dlib (optional).

    The returned callable raises ``ValueError`` when no face is found,
    the reference's skip-on-failure (align_all_parallel.py:163-165).
    """
    try:
        import dlib
    except ImportError as e:
        raise ImportError(
            "dlib is not installed; pass precomputed landmarks to "
            "align_face instead (cli.align --landmarks), or install dlib "
            "for auto-detection") from e

    detector = dlib.get_frontal_face_detector()
    predictor = dlib.shape_predictor(predictor_path)

    def get(path: str) -> np.ndarray:
        img = dlib.load_rgb_image(path)
        dets = detector(img, 1)
        if not dets:
            raise ValueError(f"no face detected in {path}")
        shape = predictor(img, dets[0])
        return np.array([[p.x, p.y] for p in shape.parts()], np.float64)

    return get
