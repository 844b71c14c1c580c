"""PyTorch port, ``mx.image.detection`` (ROADMAP 6.7), twins of
``tests/test_image_detection.py``: the ``Det*`` augmenters,
``CreateDetAugmenter`` and ``ImageDetIter`` bit for bit against the JAX
package (images and boxes) from the same inputs, with the global
``random`` and ``np.random`` streams seeded again before each package's
call; ``ImageDetIter``'s batches land on its context."""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as img


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu(0):
        yield


def _pixels(h=32, w=48, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)) \
        .astype(np.uint8)


def _label():
    # one object: class 1 in the left half
    return np.array([[1.0, 0.1, 0.2, 0.4, 0.8]], np.float32)


def _both(make, seed, src=None):
    """``make(pkg)(src, label)`` on the port and on the JAX package from
    the same seed: the two (image, label) pairs as numpy."""
    out = []
    for pkg in (mx, jmx):
        random.seed(seed)
        np.random.seed(seed)
        x = pkg.nd.array(_pixels() if src is None else src, dtype="uint8")
        s, lab = make(pkg)(x, _label())
        out.append((s.asnumpy(), lab))
    (a, la), (b, lb) = out
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    return a, la


def test_flip_mirrors_boxes():
    src, lab = _both(lambda p: p.image.DetHorizontalFlipAug(p=1.0), 0)
    np.testing.assert_allclose(lab[0, [1, 3]], [1.0 - 0.4, 1.0 - 0.1],
                               atol=1e-6)
    np.testing.assert_allclose(lab[0, [2, 4]], [0.2, 0.8])
    np.testing.assert_array_equal(src, _pixels()[:, ::-1])
    _, lab2 = img.DetHorizontalFlipAug(p=1.0)(mx.nd.array(src), lab)
    np.testing.assert_allclose(lab2, _label(), atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_crop_keeps_or_drops_objects(seed):
    _src, lab = _both(lambda p: p.image.DetRandomCropAug(
        min_object_covered=0.5, area_range=(0.5, 0.9)), seed)
    for row in lab[lab[:, 0] >= 0]:
        assert 0.0 <= row[1] <= row[3] <= 1.0
        assert 0.0 <= row[2] <= row[4] <= 1.0


def test_random_pad_shrinks_boxes():
    src, lab = _both(lambda p: p.image.DetRandomPadAug(
        area_range=(2.0, 2.0)), 2)
    assert lab[0, 3] - lab[0, 1] < 0.4 - 0.1
    assert src.shape[0] > 32 and src.shape[1] > 48


def test_borrow_aug_keeps_labels():
    src, lab = _both(lambda p: p.image.DetBorrowAug(
        p.image.CastAug("float32")), 0)
    assert src.dtype == np.float32
    np.testing.assert_allclose(lab, _label())
    with pytest.raises(mx.MXNetError):
        img.DetBorrowAug(lambda x: x)


@pytest.mark.parametrize("seed", [3, 4])
def test_create_det_augmenter_pipeline(seed):
    def chain(p):
        augs = p.image.CreateDetAugmenter(
            (3, 64, 64), rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
            brightness=0.2, contrast=0.2, saturation=0.2, mean=True,
            std=True)

        def run(x, lab):
            for a in augs:
                x, lab = a(x, lab)
            return x, lab
        return run
    src, _lab = _both(chain, seed)
    assert src.shape[:2] == (64, 64) and src.dtype == np.float32


def _batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _same(got, want):
    assert len(got) == len(want) > 0
    for (d, lab, pad), (jd, jlab, jpad) in zip(got, want):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(lab, jlab)
        assert pad == jpad


def test_image_det_iter_batches():
    def make(pkg):
        rng = np.random.RandomState(4)
        samples = [(pkg.nd.array(rng.randint(0, 255, (24, 24, 3))
                                 .astype(np.uint8), dtype="uint8"),
                    [[float(i % 2), 0.1, 0.1, 0.6, 0.6]]) for i in range(5)]
        random.seed(7)
        np.random.seed(7)
        it = pkg.image.ImageDetIter(
            batch_size=2, data_shape=(3, 32, 32), imglist=samples,
            max_objects=4, shuffle=True,
            aug_list=pkg.image.CreateDetAugmenter(
                (3, 32, 32), rand_crop=0.5, rand_mirror=True, mean=True))
        return it, _batches(it)
    it, got = make(mx)
    _same(got, make(jmx)[1])
    assert len(got) == 3 and got[0][0].shape == (2, 3, 32, 32)
    assert got[0][1].shape == (2, 4, 5) and got[-1][2] == 1
    it.reset()
    b = next(it)
    assert b.data[0].context == mx.cpu(0) and b.label[0].context == mx.cpu(0)
    assert len(list(it)) == 2


def test_image_det_iter_recordio_roundtrip(tmp_path):
    from mxnet_tpu_torch import recordio
    rng = np.random.RandomState(5)
    rec_path = str(tmp_path / "det.rec")
    rec = recordio.MXRecordIO(rec_path, "w")
    for i in range(3):
        pixels = rng.randint(0, 255, (20, 20, 3)).astype(np.uint8)
        # upstream det-record layout: flat[0] = header WIDTH, flat[1] =
        # object row width; a 2-field and a 4-field header
        label = np.array([2.0, 5.0, float(i), 0.2, 0.2, 0.8, 0.8]
                         if i % 2 == 0 else
                         [4.0, 5.0, -1.0, -1.0, float(i), 0.2, 0.2, 0.8, 0.8],
                         np.float32)
        rec.write(recordio.pack(recordio.IRHeader(0, label, i, 0),
                                img.imencode(pixels, ".png")))
    rec.close()
    kw = dict(batch_size=3, data_shape=(3, 20, 20), path_imgrec=rec_path,
              aug_list=[], max_objects=2)
    got = _batches(img.ImageDetIter(**kw))
    _same(got, _batches(jmx.image.ImageDetIter(**kw)))
    lab = got[0][1]
    np.testing.assert_allclose(lab[:, 0, 0], [0.0, 1.0, 2.0])
    np.testing.assert_allclose(lab[:, 0, 1:], [[0.2, 0.2, 0.8, 0.8]] * 3,
                               atol=1e-6)
