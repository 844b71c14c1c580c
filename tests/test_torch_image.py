"""PyTorch port, ``mx.image`` (ROADMAP 6.7), twins of
``tests/test_image.py``: the codec chain on each tier (cv2, PIL, the
built-in numpy PNG codec; both packages' ``_BACKEND`` monkeypatched
alike), the geometry, the augmenters and ``CreateAugmenter``,
``ImageIter`` and ``ImageFolderDataset``, each bit for bit against the
JAX package from the same inputs, with the global ``random`` and
``np.random`` streams seeded again before each package's call."""
import os
import random

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as img
from mxnet_tpu_torch import nd

BACKENDS = ["cv2", "pil", "numpy"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu(0):
        yield


def _rand_img(h=24, w=32, c=3, seed=0):
    return np.random.RandomState(seed).randint(
        0, 255, size=(h, w, c)).astype(np.uint8)


def _seeded(fn, seed=0):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def _backend(monkeypatch, name):
    monkeypatch.setattr(img.image, "_BACKEND", name)
    monkeypatch.setattr(jmx.image.image, "_BACKEND", name)


@pytest.mark.parametrize("c", [3, 1, 4])
def test_png_roundtrip_builtin_codec(c):
    arr = _rand_img(c=c)
    data = img.image._png_encode(arr)
    assert data == jmx.image.image._png_encode(arr)
    np.testing.assert_array_equal(img.image._png_decode(data), arr)


@pytest.mark.parametrize("backend", BACKENDS)
def test_imwrite_imread_roundtrip(tmp_path, monkeypatch, backend):
    _backend(monkeypatch, backend)
    arr = _rand_img()
    path = str(tmp_path / "x.png")
    img.imwrite(path, arr)
    back = img.imread(path)
    assert isinstance(back, nd.NDArray) and back.context == mx.cpu(0)
    np.testing.assert_array_equal(back.asnumpy(), arr)
    np.testing.assert_array_equal(back.asnumpy(),
                                  jmx.image.imread(path).asnumpy())
    gray = img.imread(path, flag=0)
    assert gray.shape == (24, 32, 1)
    np.testing.assert_array_equal(gray.asnumpy(),
                                  jmx.image.imread(path, flag=0).asnumpy())


@pytest.mark.parametrize("backend", ["cv2", "pil"])
def test_jpeg_encode_decode_matches_jax(monkeypatch, backend):
    _backend(monkeypatch, backend)
    arr = _rand_img(h=40, w=48, seed=3)
    buf = img.imencode(arr, ext=".jpg", quality=90)
    assert buf == jmx.image.imencode(arr, ext=".jpg", quality=90)
    np.testing.assert_array_equal(img.imdecode(buf).asnumpy(),
                                  jmx.image.imdecode(buf).asnumpy())


def test_imread_missing_raises(monkeypatch):
    with pytest.raises(mx.MXNetError):
        img.imread("/nonexistent/zzz.png")
    monkeypatch.setattr(img.image, "_BACKEND", "numpy")
    with pytest.raises(mx.MXNetError, match="JPEG"):
        img.imdecode(b"\xff\xd8\xff\xe0 not decodable here")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("interp", [0, 1, 2])
def test_imresize_and_resize_short(monkeypatch, backend, interp):
    _backend(monkeypatch, backend)
    src = _rand_img(h=24, w=48)
    out = img.imresize(src, 16, 12, interp)
    assert out.shape == (12, 16, 3)
    np.testing.assert_array_equal(
        out.asnumpy(), jmx.image.imresize(src, 16, 12, interp).asnumpy())
    short = img.resize_short(src, 12, interp)
    assert short.shape == (12, 24, 3)
    np.testing.assert_array_equal(
        short.asnumpy(), jmx.image.resize_short(src, 12, interp).asnumpy())


def test_center_random_and_sized_crop():
    arr = _rand_img(h=30, w=40)
    out, (x0, y0, w, h) = img.center_crop(arr, (20, 16))
    assert out.shape == (16, 20, 3) and (w, h) == (20, 16)
    np.testing.assert_array_equal(
        out.asnumpy(), jmx.image.center_crop(arr, (20, 16))[0].asnumpy())
    for fn in (lambda m: m.random_crop(arr, (20, 16)),
               lambda m: m.random_size_crop(arr, (12, 12), (0.2, 1.0),
                                            (0.75, 1.33))):
        (got, box), (want, jbox) = _seeded(lambda: fn(img), 5), \
            _seeded(lambda: fn(jmx.image), 5)
        assert box == jbox
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_color_normalize():
    arr = np.full((4, 4, 3), 100, np.uint8)
    out = img.color_normalize(arr, mean=(100, 100, 100), std=(2, 2, 2))
    np.testing.assert_allclose(out.asnumpy(), 0.0)
    src = _rand_img()
    np.testing.assert_array_equal(
        img.color_normalize(src, (120, 110, 100), (50, 60, 70)).asnumpy(),
        jmx.image.color_normalize(src, (120, 110, 100),
                                  (50, 60, 70)).asnumpy())


def _run(pkg, augs_kw, src, seed):
    def go():
        augs = pkg.image.CreateAugmenter(**augs_kw)
        x = pkg.nd.array(src, dtype="uint8")
        for a in augs:
            x = a(x)
        return x.asnumpy()
    return _seeded(go, seed)


@pytest.mark.parametrize("kw", [
    dict(data_shape=(3, 16, 16), resize=20, rand_crop=True,
         rand_mirror=True, brightness=0.1, mean=True, std=True),
    dict(data_shape=(3, 16, 16), rand_resize=True, contrast=0.3,
         saturation=0.3, hue=0.2, pca_noise=0.1, rand_gray=0.5),
    dict(data_shape=(3, 20, 20), brightness=0.2, contrast=0.2,
         saturation=0.2, mean=np.array([1.0, 2.0, 3.0]))])
def test_create_augmenter_pipeline(kw):
    src = _rand_img(h=40, w=50)
    for seed in range(3):
        got = _run(mx, kw, src, seed)
        assert got.shape == kw["data_shape"][1:] + (3,)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, _run(jmx, kw, src, seed))


def test_hue_and_gray_augs():
    x = nd.array(_rand_img(), dtype="uint8")
    jx = jmx.nd.array(_rand_img(), dtype="uint8")
    h = _seeded(lambda: img.HueJitterAug(0.5)(x), 2)
    assert h.shape == x.shape
    np.testing.assert_array_equal(
        h.asnumpy(),
        _seeded(lambda: jmx.image.HueJitterAug(0.5)(jx), 2).asnumpy())
    a = img.RandomGrayAug(1.0)(x).asnumpy()
    np.testing.assert_allclose(a[..., 0], a[..., 1], rtol=1e-5)
    np.testing.assert_array_equal(
        a, jmx.image.RandomGrayAug(1.0)(jx).asnumpy())
    assert img.CastAug().dumps() == jmx.image.CastAug().dumps()


def _write_folder(root, n_per_class=4):
    for k, cls in enumerate(("cat", "dog")):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(n_per_class):
            img.imwrite(os.path.join(root, cls, f"{i}.png"),
                        _rand_img(seed=10 * k + i))


def _iter_batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _same(got, want):
    assert len(got) == len(want) > 0
    for (d, lab, pad), (jd, jlab, jpad) in zip(got, want):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(lab, jlab)
        assert pad == jpad


def test_imageiter_from_imglist(tmp_path):
    root = str(tmp_path)
    _write_folder(root)
    imglist = [[0.0, os.path.join("cat", f"{i}.png")] for i in range(4)]
    imglist += [[1.0, os.path.join("dog", f"{i}.png")] for i in range(3)]
    kw = dict(batch_size=4, data_shape=(3, 16, 16), imglist=imglist,
              path_root=root, shuffle=True, rand_crop=True,
              rand_mirror=True, brightness=0.2, mean=True)
    it = _seeded(lambda: img.ImageIter(**kw), 4)
    got = _seeded(lambda: _iter_batches(it), 6)
    jit = _seeded(lambda: jmx.image.ImageIter(**kw), 4)
    _same(got, _seeded(lambda: _iter_batches(jit), 6))
    assert len(got) == 2 and got[1][2] == 1
    it.reset()
    first = next(it)
    assert first.data[0].context == mx.cpu(0)
    assert first.label[0].shape == (4,)


def test_imageiter_from_recordio(tmp_path):
    from mxnet_tpu_torch import recordio
    rec_path = str(tmp_path / "data.rec")
    rec = recordio.MXIndexedRecordIO(str(tmp_path / "data.idx"), rec_path,
                                     "w")
    for i in range(6):
        payload = img.imencode(_rand_img(seed=i), ext=".png")
        rec.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i % 2),
                                                         i, 0), payload))
    rec.close()
    kw = dict(batch_size=3, data_shape=(3, 16, 16), path_imgrec=rec_path,
              rand_crop=True, last_batch_handle="discard")
    got = _seeded(lambda: _iter_batches(img.ImageIter(**kw)), 1)
    _same(got, _seeded(lambda: _iter_batches(jmx.image.ImageIter(**kw)), 1))
    assert set(got[0][1]) <= {0.0, 1.0}


def test_folder_dataset_reads_real_pngs(tmp_path):
    from mxnet_tpu_torch.gluon.data.vision import ImageFolderDataset
    root = str(tmp_path)
    _write_folder(root, n_per_class=3)
    ds = ImageFolderDataset(root)
    jds = jmx.gluon.data.vision.ImageFolderDataset(root)
    assert len(ds) == 6 and sorted(ds.synsets) == ["cat", "dog"]
    for i in range(len(ds)):
        (x, y), (jx, jy) = ds[i], jds[i]
        assert x.shape == (24, 32, 3) and x.context == mx.cpu(0)
        np.testing.assert_array_equal(x.asnumpy(), jx.asnumpy())
        assert y == jy
