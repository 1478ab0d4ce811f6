"""The port's data layer against the JAX package's, on the CPU.

  * the LMDB writer: the same items give the same bytes (the small,
    overflow and multi-level cases of ``tests/test_native_io.py``), and
    each package's reader reads the other's file;
  * the native loader (the port's runtime, ``csrc/teio.cpp``):
    the same LMDB and seed give the same batches bit for bit, with one
    worker, three, and each host of two;
  * ``make_train_iterator`` on an ``ArraySource``: the same batches bit
    for bit, uint8 and float, each host of two;
  * the same on an image folder (read on several threads);
  * images without PIL: PNG folder reads equal the JAX
    ``ImageFolderSource`` (PIL) exactly; the PNG writer's filtered rows
    read back exactly; JPEG reads are within one level of PIL's;
    ``resize_lanczos`` is within one level of PIL's LANCZOS;
    ``encode_jpeg`` gives the JAX binding's bytes.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from transeditor_tpu.data import dataset as jax_dataset
from transeditor_tpu.data import native as jax_native
from transeditor_tpu.data.lmdb_writer import write_lmdb as jax_write_lmdb

from transeditor_tpu_torch.data import dataset, native
from transeditor_tpu_torch.data.lmdb_writer import (write_image_dataset,
                                                    write_lmdb)
from transeditor_tpu_torch.utils.image import (load_image, load_png,
                                               resize_lanczos, save_png)


def _small():
    items = {f"key-{i:04d}".encode(): f"value-{i}".encode() * (i + 1)
             for i in range(200)}
    items[b"length"] = b"200"
    return items


def _overflow():
    rng = np.random.RandomState(0)
    return {f"big-{i}".encode(): rng.bytes(10_000 + i * 5000)
            for i in range(5)}


def _multilevel():
    return {f"{i:06d}".encode(): (b"x" * 100) + str(i).encode()
            for i in range(500)}


ITEMS = {"small": _small, "overflow": _overflow, "multilevel": _multilevel}


def _smooth(n, size, seed=0):
    """Seeded smooth RGB images (JPEG keeps them within a few levels)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(n):
        a, b, c = rng.uniform(0.5, 3.0, 3)
        ph = rng.uniform(0, 6.3, 3)
        img = np.stack([np.sin(a * 6.3 * x + ph[0]),
                        np.cos(b * 6.3 * y + ph[1]),
                        np.sin(c * 6.3 * (x + y) + ph[2])], -1)
        out.append(((img + 1) * 127.5).round().astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def image_lmdb(tmp_path_factory):
    """An LMDB of 12 JPEGs at 16px, written by the port."""
    path = str(tmp_path_factory.mktemp("imgdb") / "db")
    imgs = _smooth(12, 16)
    n = write_image_dataset(path, [native.encode_jpeg(im, 95)
                                   for im in imgs], 16)
    assert n == 12
    return path


@pytest.mark.parametrize("case", sorted(ITEMS))
def test_writer_bytes_equal_the_jax_writer(tmp_path, case):
    items = ITEMS[case]()
    write_lmdb(str(tmp_path / "port"), items)
    jax_write_lmdb(str(tmp_path / "jax"), items)
    port = (tmp_path / "port" / "data.mdb").read_bytes()
    assert port == (tmp_path / "jax" / "data.mdb").read_bytes()


@pytest.mark.parametrize("case", sorted(ITEMS))
def test_each_reader_reads_the_other_writer(tmp_path, case):
    items = ITEMS[case]()
    write_lmdb(str(tmp_path / "port"), items)
    jax_write_lmdb(str(tmp_path / "jax"), items)
    for reader, path in ((native.NativeLMDB, tmp_path / "jax"),
                         (jax_native.NativeLMDB, tmp_path / "port")):
        db = reader(str(path))
        assert db.entries == len(items)
        for k, v in items.items():
            assert db.get(k) == v, (reader, k)
        assert db.get(b"missing") is None
        db.close()


@pytest.mark.parametrize("kw", [
    dict(workers=1, shuffle=True, flip=True),
    dict(workers=3, shuffle=True, flip=True),
    dict(workers=2, host_index=0, host_count=2),
    dict(workers=2, host_index=1, host_count=2, as_uint8=True),
], ids=["one-worker", "three-workers", "host-0-of-2", "host-1-of-2-uint8"])
def test_loader_batches_equal_the_jax_loader(image_lmdb, kw):
    got = native.NativeLMDBLoader(image_lmdb, 4, 16, seed=3, **kw)
    want = jax_native.NativeLMDBLoader(image_lmdb, 4, 16, seed=3, **kw)
    try:
        for _ in range(5):
            a, b = next(got), next(want)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    finally:
        got.close()
        want.close()
    with pytest.raises(StopIteration):
        next(got)                       # closed: ends, never crashes


def test_port_runtime_is_built_under_build_not_native():
    path = native.library_path()
    native.load_library()
    assert path.exists() and path.parent.name == "transeditor_tpu_torch"
    assert path.parent.parent.name == "build"
    assert "native" not in path.parts[-3:]


@pytest.mark.parametrize("host_index", [0, 1])
@pytest.mark.parametrize("normalize", [False, True])
def test_train_iterator_equals_the_jax_iterator(host_index, normalize):
    arr = np.random.RandomState(0).randint(0, 255, (10, 8, 8, 3), np.uint8)
    kw = dict(seed=4, host_index=host_index, host_count=2,
              normalize=normalize)
    got = dataset.make_train_iterator(dataset.ArraySource(arr), 3, 8, **kw)
    want = jax_dataset.make_train_iterator(jax_dataset.ArraySource(arr), 3,
                                           8, **kw)
    try:
        for _ in range(3):
            a, b = next(got), next(want)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    finally:
        got.close()
        want.close()


@pytest.mark.parametrize("host_index", [0, 1])
def test_folder_iterator_equals_the_jax_iterator(tmp_path, host_index):
    """Read on several threads, a folder gives the JAX iterator's
    batches (one thread, PIL)."""
    for i, img in enumerate(_smooth(10, 16, seed=6)):
        if i % 2:
            Image.fromarray(img).save(tmp_path / f"{i:02d}.png")
        else:
            save_png(str(tmp_path / f"{i:02d}.png"), img)
    kw = dict(seed=2, host_index=host_index, host_count=2, normalize=False)
    got = dataset.make_train_iterator(
        dataset.ImageFolderSource(str(tmp_path)), 3, 16, **kw)
    want = jax_dataset.make_train_iterator(
        jax_dataset.ImageFolderSource(str(tmp_path)), 3, 16, **kw)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(next(got), next(want))
    finally:
        got.close()
        want.close()


def test_train_iterator_raises_the_readers_error():
    class Broken:
        def __len__(self):
            return 4

        def get(self, idx, res):
            raise OSError(f"cannot read {idx}")

    it = dataset.make_train_iterator(Broken(), 2, 8)
    with pytest.raises(OSError, match="cannot read"):
        next(it)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_png_folder_reads_equal_pil(tmp_path, mode):
    rng = np.random.RandomState(1)
    for i, size in enumerate((16, 16, 24)):          # the last is resized
        img = rng.randint(0, 256, (size, size, 4)).astype(np.uint8)
        img[..., 0] = np.arange(size)[None, :] * 9 % 256
        Image.fromarray(img, "RGBA").convert(mode).save(
            tmp_path / f"{i:02d}.png", optimize=bool(i % 2))
    got, want = (dataset.ImageFolderSource(str(tmp_path)),
                 jax_dataset.ImageFolderSource(str(tmp_path)))
    assert len(got) == len(want) == 3
    for i in range(2):
        np.testing.assert_array_equal(got.get(i, 16), want.get(i, 16))
    diff = got.get(2, 16).astype(int) - want.get(2, 16).astype(int)
    assert np.abs(diff).max() <= 1


def test_jpeg_reads_within_one_level_of_pil(tmp_path):
    for i, img in enumerate(_smooth(3, 32, seed=2)):
        Image.fromarray(img).save(tmp_path / f"{i}.jpg", quality=90)
    got, want = (dataset.ImageFolderSource(str(tmp_path)),
                 jax_dataset.ImageFolderSource(str(tmp_path)))
    for i in range(3):
        a, b = got.get(i, 32), want.get(i, 32)
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("shape,out", [
    ((64, 64), (16, 16)), ((50, 37), (32, 20)), ((300, 300), (256, 256)),
    ((16, 16), (40, 40)), ((23, 30), (64, 47)), ((1024, 1024), (256, 256))],
    ids=["down4", "down-odd", "down-300-256", "up", "up-odd",
         "down-1024-256"])
def test_resize_lanczos_matches_pil(shape, out):
    img = np.random.RandomState(3).randint(0, 256, (*shape, 3)).astype(
        np.uint8)
    want = np.asarray(Image.fromarray(img).resize((out[1], out[0]),
                                                  Image.LANCZOS))
    got = resize_lanczos(img, out[1], out[0])
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _png_from_rows(rows: np.ndarray, w: int, h: int) -> bytes:
    """An 8-bit RGB PNG of stored rows ([h, 1 + 3w]: filter byte, bytes)."""
    body = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + b"".join(
        struct.pack(">I", len(d)) + k + d
        + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF)
        for k, d in ((b"IHDR", body), (b"IDAT", zlib.compress(rows.tobytes())),
                     (b"IEND", b"")))


def _rows_of(path) -> np.ndarray:
    data = path.read_bytes()
    w, h = struct.unpack(">II", data[16:24])
    return np.frombuffer(zlib.decompress(data[41:-12]), np.uint8).reshape(
        h, 1 + 3 * w)


@pytest.mark.parametrize("kind", ["smooth", "noisy", "flat"])
def test_png_writer_rows_read_back_exactly(tmp_path, kind):
    """The writer's filtered rows, read back by PIL and by the port's
    reader (its native unfilter), equal the image."""
    img = {"smooth": lambda: _smooth(1, 40, seed=7)[0],
           "noisy": lambda: np.random.RandomState(7).randint(
               0, 256, (40, 40, 3)).astype(np.uint8),
           "flat": lambda: np.full((40, 40, 3), 77, np.uint8)}[kind]()
    path = tmp_path / "f.png"
    save_png(str(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(load_png(str(path)), img)


def test_png_writer_filters_rows_as_libpng(tmp_path):
    """As libpng's adaptive writer, no row of a natural image is left
    unfiltered (so a reader must undo the filters), and the rows take
    different filters."""
    save_png(str(tmp_path / "f.png"), _smooth(1, 64, seed=8)[0])
    used = set(_rows_of(tmp_path / "f.png")[:, 0].tolist())
    assert 0 not in used and len(used) > 1


def test_png_reader_reads_unfiltered_rows(tmp_path):
    img = _smooth(1, 8)[0]
    rows = np.concatenate([np.zeros((8, 1), np.uint8), img.reshape(8, 24)],
                          axis=1)
    (tmp_path / "x.png").write_bytes(_png_from_rows(rows, 8, 8))
    np.testing.assert_array_equal(load_png(str(tmp_path / "x.png")), img)


def test_png_reader_refuses_an_unknown_row_filter(tmp_path):
    img = _smooth(1, 8)[0]
    rows = np.concatenate([np.ones((8, 1), np.uint8), img.reshape(8, 24)],
                          axis=1)
    rows[5, 0] = 7
    (tmp_path / "x.png").write_bytes(_png_from_rows(rows, 8, 8))
    with pytest.raises(ValueError, match="filter type 7"):
        load_png(str(tmp_path / "x.png"))


@pytest.mark.parametrize("quality", [75, 95])
def test_encode_jpeg_bytes_equal_the_jax_binding(quality):
    img = _smooth(1, 24, seed=5)[0]
    data = native.encode_jpeg(img, quality)
    assert data == jax_native.encode_jpeg(img, quality)
    back = native.decode_jpeg(data)
    assert back.shape == img.shape
    np.testing.assert_array_equal(back, jax_native.decode_jpeg(data, 24, 24))


@pytest.mark.parametrize("name", ["a.webp", "b.bmp"])
def test_unread_formats_raise_naming_the_file(tmp_path, name):
    """``.webp`` and ``.bmp`` are read now, equal to the JAX source's PIL
    read; a file cut short raises naming it."""
    Image.fromarray(_smooth(1, 8)[0]).save(tmp_path / "ok.png")
    Image.fromarray(_smooth(1, 8, seed=1)[0]).save(tmp_path / name)
    data = (tmp_path / name).read_bytes()
    (tmp_path / "cut" / name).parent.mkdir()
    (tmp_path / "cut" / name).write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match=name):
        load_image(str(tmp_path / "cut" / name))
    src = dataset.ImageFolderSource(str(tmp_path))
    want = jax_dataset.ImageFolderSource(str(tmp_path))
    assert len(src) == len(want) == 2
    for i in range(2):
        np.testing.assert_array_equal(src.get(i, 8), want.get(i, 8))


@pytest.mark.parametrize("kind", ["palette", "16-bit", "interlaced"])
def test_png_reader_refuses_what_it_cannot_read(tmp_path, kind):
    """Palette and 16-bit PNGs are read now, equal to PIL's
    ``convert("RGB")``; a file flagged Adam7-interlaced whose data are
    not is refused, as PIL refuses it (the passes need more bytes)."""
    img = Image.fromarray(_smooth(1, 8)[0])
    path = tmp_path / "x.png"
    if kind == "palette":
        img.convert("P").save(path)
    elif kind == "16-bit":
        Image.fromarray(np.full((8, 8), 1000, np.uint16)).save(path)
    else:                 # PIL writes no interlaced PNG: set the flag
        save_png(str(path), np.asarray(img))
        raw = bytearray(path.read_bytes())
        raw[28] = 1                                  # IHDR interlace
        raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])))
        path.write_bytes(bytes(raw))
        with pytest.raises(OSError):
            Image.open(path).convert("RGB")
        with pytest.raises(ValueError, match="x.png"):
            load_png(str(path))
        with pytest.raises(ValueError):
            load_image(str(path))
        return
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(load_png(str(path)), want)
    np.testing.assert_array_equal(load_image(str(path)), want)


def test_other_files_are_refused(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="only PNG and JPEG"):
        load_image(str(path))
