"""WebP encoding with settings PIL cannot pass: libwebp's advanced API
(``WebPEncode`` with a ``WebPConfig``) called through ctypes on the
libwebp that Pillow bundles.  Used by ``make_fixtures.py`` only.

``encode(rgba, **settings)`` -> WebP bytes; ``settings`` name
``WebPConfig`` fields (``filter_type``, ``filter_strength``,
``filter_sharpness``, ``partitions``, ``segments``, ``alpha_filtering``,
``alpha_compression``, ``near_lossless``, ...)."""

from __future__ import annotations

import ctypes
import glob
import os

import numpy as np

# libwebp's encode.h (ABI 2.x), field by field
_CONFIG_FIELDS = [
    ("lossless", ctypes.c_int), ("quality", ctypes.c_float),
    ("method", ctypes.c_int), ("image_hint", ctypes.c_int),
    ("target_size", ctypes.c_int), ("target_PSNR", ctypes.c_float),
    ("segments", ctypes.c_int), ("sns_strength", ctypes.c_int),
    ("filter_strength", ctypes.c_int), ("filter_sharpness", ctypes.c_int),
    ("filter_type", ctypes.c_int), ("autofilter", ctypes.c_int),
    ("alpha_compression", ctypes.c_int), ("alpha_filtering", ctypes.c_int),
    ("alpha_quality", ctypes.c_int), ("pass_", ctypes.c_int),
    ("show_compressed", ctypes.c_int), ("preprocessing", ctypes.c_int),
    ("partitions", ctypes.c_int), ("partition_limit", ctypes.c_int),
    ("emulate_jpeg_size", ctypes.c_int), ("thread_level", ctypes.c_int),
    ("low_memory", ctypes.c_int), ("near_lossless", ctypes.c_int),
    ("exact", ctypes.c_int), ("use_delta_palette", ctypes.c_int),
    ("use_sharp_yuv", ctypes.c_int), ("qmin", ctypes.c_int),
    ("qmax", ctypes.c_int), ("_spare", ctypes.c_uint32 * 16)]


class Config(ctypes.Structure):
    _fields_ = _CONFIG_FIELDS


class Picture(ctypes.Structure):
    _fields_ = [
        ("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("y", ctypes.c_void_p), ("u", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int),
        ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p),
        ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
        ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int),
        ("pad2", ctypes.c_uint32 * 3), ("writer", ctypes.c_void_p),
        ("custom_ptr", ctypes.c_void_p), ("extra_info_type", ctypes.c_int),
        ("extra_info", ctypes.c_void_p), ("stats", ctypes.c_void_p),
        ("error_code", ctypes.c_int), ("progress_hook", ctypes.c_void_p),
        ("user_data", ctypes.c_void_p), ("pad3", ctypes.c_uint32 * 3),
        ("pad4", ctypes.c_void_p), ("pad5", ctypes.c_void_p),
        ("pad6", ctypes.c_uint32 * 8), ("memory_", ctypes.c_void_p),
        ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2),
        ("_spare", ctypes.c_uint8 * 256)]


class MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 8)]


_ABI = 0x0200          # any 2.x encoder ABI is accepted


def _lib() -> ctypes.CDLL:
    import PIL
    from PIL import _webp  # noqa: F401  (loads libwebp's dependencies)
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    found = glob.glob(os.path.join(libs, "libwebp-*.so*"))
    if not found:
        raise RuntimeError(f"no bundled libwebp under {libs}")
    lib = ctypes.CDLL(found[0])
    lib.WebPConfigInitInternal.argtypes = [ctypes.POINTER(Config),
                                           ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int]
    lib.WebPValidateConfig.argtypes = [ctypes.POINTER(Config)]
    lib.WebPPictureInitInternal.argtypes = [ctypes.POINTER(Picture),
                                            ctypes.c_int]
    lib.WebPPictureImportRGBA.argtypes = [ctypes.POINTER(Picture),
                                          ctypes.c_void_p, ctypes.c_int]
    lib.WebPEncode.argtypes = [ctypes.POINTER(Config),
                               ctypes.POINTER(Picture)]
    lib.WebPPictureFree.argtypes = [ctypes.POINTER(Picture)]
    lib.WebPMemoryWriterInit.argtypes = [ctypes.POINTER(MemoryWriter)]
    lib.WebPMemoryWriterClear.argtypes = [ctypes.POINTER(MemoryWriter)]
    return lib


def encode(rgba: np.ndarray, quality: float = 75.0, **settings) -> bytes:
    """[H, W, 4] uint8 RGBA -> a simple-format WebP (VP8 / VP8L, with an
    ALPH chunk under VP8X when alpha is not all 255)."""
    lib = _lib()
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, _ = rgba.shape
    cfg = Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, quality, _ABI):
        raise RuntimeError("WebPConfigInit refused the ABI")
    for k, v in settings.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses the settings {settings}")
    pic = Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI):
        raise RuntimeError("WebPPictureInit refused the ABI")
    pic.use_argb = 1 if cfg.lossless else 0
    pic.width, pic.height = w, h
    writer = MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        if not lib.WebPPictureImportRGBA(ctypes.byref(pic),
                                         rgba.ctypes.data, w * 4):
            raise RuntimeError("WebPPictureImportRGBA failed")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
        pic.custom_ptr = ctypes.cast(ctypes.pointer(writer), ctypes.c_void_p)
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed ({pic.error_code})")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))
