"""PyTorch port, ``io``'s iterators of ROADMAP 6.7 (``ResizeIter``,
``PrefetchingIter``, ``CSVIter``, ``MNISTIter``, ``ImageRecordIter``),
twins of ``tests/test_io.py``: each batch bit for bit against the JAX
package's from the same files and seed, on the cv2 tier and on the
built-in codec (the port's ``_BACKEND`` set to ``"numpy"``, against the
JAX package's cv2 path without resize and its numpy ``imresize`` with
resize); records from the JAX package's ``tools/im2rec.py``; the
thread-local context (an iterator built under ``mx.cpu(0)`` yields host
tensors from its producer thread); ``close()`` joining its threads."""
import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrecordio

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.base import MXNetError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu(0):
        yield


def _write_image_rec(tmp_path, n=12, hw=(40, 36), fmt=".png", seed=0):
    rng = np.random.RandomState(seed)
    prefix = str(tmp_path / "data")
    writer = jrecordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    labels = []
    for i in range(n):
        img = rng.randint(0, 255, hw + (3,), np.uint8)
        labels.append(float(i % 3))
        writer.write_idx(i, jrecordio.pack_img(
            jrecordio.IRHeader(0, labels[-1], i, 0), img, quality=95,
            img_fmt=fmt))
    writer.close()
    return prefix, labels


def _batches(it, epochs=1):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _twin(prefix, epochs=1, **kw):
    """The port's and the JAX package's batches over the same shard."""
    kw = dict(dict(path_imgrec=prefix + ".rec", data_shape=(3, 32, 32),
                   batch_size=4), **kw)
    it = mx.io.ImageRecordIter(**kw)
    got = _batches(it, epochs)
    it.close()
    jit = jmx.io.ImageRecordIter(**kw)
    want = _batches(jit, epochs)
    jit.close()
    assert len(got) == len(want) > 0
    for (d, lab, pad), (jd, jlab, jpad) in zip(got, want):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(lab, jlab)
        assert pad == jpad
    return got


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_pack_img_unpack_img(fmt):
    img = np.random.RandomState(0).randint(0, 255, (32, 24, 3), np.uint8)
    header = recordio.IRHeader(0, 1.0, 0, 0)
    s = recordio.pack_img(header, img, img_fmt=fmt)
    assert s == jrecordio.pack_img(header, img, img_fmt=fmt)
    h, img2 = recordio.unpack_img(s)
    assert h.label == pytest.approx(1.0)
    np.testing.assert_array_equal(img2, jrecordio.unpack_img(s)[1])
    if fmt == ".png":
        np.testing.assert_array_equal(img2, img)  # png is lossless


def test_pack_img_builtin_codec_writes_png(monkeypatch):
    """With the built-in codec ``.jpg`` writes a PNG (as the JAX numpy
    backend does), in cv2's channel order both ways."""
    monkeypatch.setattr(mx.image.image, "_BACKEND", "numpy")
    img = np.random.RandomState(1).randint(0, 255, (20, 16, 3), np.uint8)
    s = recordio.pack_img(recordio.IRHeader(0, 2.0, 3, 0), img)
    _h, payload = recordio.unpack(s)
    assert payload[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(recordio.unpack_img(s)[1], img)
    np.testing.assert_array_equal(jrecordio.unpack_img(s)[1], img)
    with pytest.raises(MXNetError, match="format"):
        recordio.pack_img(recordio.IRHeader(0, 2.0, 3, 0), img, img_fmt=".bmp")


def test_csv_iter(tmp_path):
    data = np.random.RandomState(0).randn(12, 3).astype(np.float32)
    label = np.arange(12, dtype=np.float32)
    dpath, lpath = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, label, delimiter=",")
    kw = dict(data_csv=dpath, data_shape=(3,), label_csv=lpath, batch_size=5)
    got = [(b.data[0].numpy(), b.label[0].numpy(), b.pad)
           for b in mx.io.CSVIter(**kw)]
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
            for b in jmx.io.CSVIter(**kw)]
    assert len(got) == len(want) == 3 and got[-1][2] == 3
    for (d, lab, pad), (jd, jlab, jpad) in zip(got, want):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(lab, jlab)
        assert pad == jpad
    np.testing.assert_allclose(got[0][0], data[:5], rtol=1e-5)


def test_csv_iter_sharded(tmp_path):
    data = np.arange(20, dtype=np.float32).reshape(10, 2)
    dpath = str(tmp_path / "d.csv")
    np.savetxt(dpath, data, delimiter=",")
    parts = [next(mx.io.CSVIter(data_csv=dpath, data_shape=(2,),
                                batch_size=5, num_parts=2, part_index=p))
             .data[0].numpy() for p in range(2)]
    np.testing.assert_array_equal(np.vstack(parts), data)
    with pytest.raises(MXNetError, match="part_index"):
        mx.io.CSVIter(data_csv=dpath, data_shape=(2,), num_parts=2,
                      part_index=2)


def _write_mnist(tmp_path, n=32, gz=True):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (n, 28, 28), np.uint8)
    labels = rng.randint(0, 10, (n,)).astype(np.uint8)
    ipath = str(tmp_path / ("img.idx3.gz" if gz else "img.idx3"))
    lpath = str(tmp_path / ("lbl.idx1.gz" if gz else "lbl.idx1"))
    opener = gzip.open if gz else open
    with opener(ipath, "wb") as f:
        f.write(struct.pack(">IIII", 0x803, n, 28, 28))
        f.write(images.tobytes())
    with opener(lpath, "wb") as f:
        f.write(struct.pack(">II", 0x801, n))
        f.write(labels.tobytes())
    return ipath, lpath, images, labels


@pytest.mark.parametrize("gz,shuffle,flat", [(True, False, False),
                                             (False, True, True)])
def test_mnist_iter_real_files(tmp_path, gz, shuffle, flat):
    ipath, lpath, images, labels = _write_mnist(tmp_path, gz=gz)
    kw = dict(image=ipath, label=lpath, batch_size=8, shuffle=shuffle,
              flat=flat, seed=3)
    got = [(b.data[0].numpy(), b.label[0].numpy())
           for b in mx.io.MNISTIter(**kw)]
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy())
            for b in jmx.io.MNISTIter(**kw)]
    assert len(got) == len(want) == 4
    for (d, lab), (jd, jlab) in zip(got, want):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(lab, jlab)
    if not shuffle:
        assert got[0][0].shape == (8, 1, 28, 28)
        np.testing.assert_allclose(got[0][0][:, 0] * 255.0, images[:8],
                                   atol=1e-4)


def test_mnist_iter_sharded(tmp_path):
    ipath, lpath, _images, labels = _write_mnist(tmp_path)
    got = np.concatenate([
        next(mx.io.MNISTIter(image=ipath, label=lpath, batch_size=16,
                             shuffle=False, num_parts=2, part_index=i))
        .label[0].numpy() for i in range(2)])
    np.testing.assert_array_equal(got, labels)


def test_image_record_iter(tmp_path):
    prefix, labels = _write_image_rec(tmp_path)
    got = _twin(prefix, epochs=2, path_imgidx=prefix + ".idx")
    assert len(got) == 6 and got[0][0].shape == (4, 3, 32, 32)
    np.testing.assert_array_equal(got[0][1], labels[:4])


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=7),
    dict(shuffle=True, rand_mirror=True, mean_r=123.0, mean_g=117.0,
         mean_b=104.0, scale=1 / 58.0, preprocess_threads=2, seed=1),
    dict(resize=34, rand_crop=True, round_batch=False, batch_size=5)])
def test_image_record_iter_augmentations_match_jax(tmp_path, kw):
    prefix, _ = _write_image_rec(tmp_path, hw=(40, 52))
    _twin(prefix, epochs=2, **kw)


def test_image_record_iter_sharded(tmp_path):
    prefix, labels = _write_image_rec(tmp_path)
    got = []
    for part in range(3):
        got += _twin(prefix, num_parts=3, part_index=part)[0][1].tolist()
    assert got == labels


def test_im2rec_tool_end_to_end(tmp_path):
    """Folder of PNGs -> the JAX package's tools/im2rec.py -> .rec ->
    the port's ImageRecordIter, against the JAX one."""
    import cv2
    root = tmp_path / "imgs"
    for k, cls in enumerate(("cat", "dog")):
        (root / cls).mkdir(parents=True)
        rng = np.random.RandomState(k)
        for i in range(4):
            cv2.imwrite(str(root / cls / f"{i}.png"),
                        rng.randint(0, 255, (34, 30, 3), np.uint8))
    prefix = str(tmp_path / "ds")
    tool = os.path.join(REPO, "tools", "im2rec.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.check_call([sys.executable, tool, "--list", prefix,
                           str(root)], env=env, timeout=120)
    subprocess.check_call([sys.executable, tool, prefix, str(root)],
                          env=env, timeout=120)
    got = _twin(prefix, path_imgidx=prefix + ".idx", data_shape=(3, 28, 28),
                shuffle=True, rand_mirror=True)
    assert set(got[0][1]) <= {0.0, 1.0}


def test_image_record_iter_batch_larger_than_twice_shard(tmp_path):
    prefix, labels = _write_image_rec(tmp_path, n=3)
    got = _twin(prefix, batch_size=8, round_batch=True)
    np.testing.assert_array_equal(got[0][1], [labels[i % 3] for i in range(8)])
    assert got[0][2] == 5


def test_image_record_iter_label_width_mismatch(tmp_path):
    prefix, _ = _write_image_rec(tmp_path, n=2)
    it = mx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                               data_shape=(3, 32, 32), batch_size=2,
                               label_width=3)
    with pytest.raises(MXNetError, match="label"):
        next(it)
    it.close()


@pytest.mark.parametrize("resize", [-1, 30])
def test_builtin_codec_matches_jax(tmp_path, monkeypatch, resize):
    """The card's codec tier: the port's built-in PNG codec (no cv2)
    against the JAX package's cv2 path on PNG records without resize,
    and against the JAX package's numpy-backend ``imresize`` (nearest)
    with resize."""
    prefix, _ = _write_image_rec(tmp_path, n=8, hw=(40, 52))
    monkeypatch.setattr(mx.image.image, "_BACKEND", "numpy")
    kw = dict(path_imgrec=prefix + ".rec", data_shape=(3, 24, 24),
              batch_size=4, mean_r=10.0, scale=0.5, resize=resize)
    if resize < 0:
        _twin(prefix, epochs=2, shuffle=True, rand_crop=True,
              rand_mirror=True, **{k: v for k, v in kw.items()
                                   if k != "path_imgrec"})
        return
    it = mx.io.ImageRecordIter(**kw)
    got = _batches(it)
    it.close()
    monkeypatch.setattr(jmx.image.image, "_BACKEND", "numpy")
    reader = jrecordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "r")
    mean = np.array([10.0, 0, 0], np.float32).reshape(3, 1, 1)
    for b, (data, _lab, _pad) in enumerate(got):
        for i in range(4):
            _h, payload = jrecordio.unpack(reader.read_idx(b * 4 + i))
            img = jmx.image.imdecode(payload).asnumpy()
            h, w = img.shape[:2]
            img = jmx.image.imresize(img, int(w * resize / h), resize,
                                     1).asnumpy()
            y, x = (img.shape[0] - 24) // 2, (img.shape[1] - 24) // 2
            want = (img[y:y + 24, x:x + 24].transpose(2, 0, 1)
                    .astype(np.float32) - mean) * 0.5
            np.testing.assert_array_equal(data[i], want)


def test_jpeg_record_without_a_decoder_names_the_tier(tmp_path,
                                                     monkeypatch):
    from mxnet_tpu_torch.lib import nativelib
    prefix, _ = _write_image_rec(tmp_path, n=4, fmt=".jpg")
    monkeypatch.setattr(mx.image.image, "_BACKEND", "numpy")
    monkeypatch.setattr(nativelib, "jpeg_available", lambda: False)
    it = mx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                               data_shape=(3, 32, 32), batch_size=4)
    with pytest.raises(MXNetError, match="no cv2, no PIL"):
        it.next()
    it.close()


def test_thread_local_context(tmp_path):
    """The default context is thread-local: an iterator built under
    ``mx.cpu(0)`` yields host tensors although its producer thread runs
    outside that scope; without a card, one built on the card's context
    raises on the caller's thread."""
    prefix, _ = _write_image_rec(tmp_path, n=4)
    it = mx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                               data_shape=(3, 32, 32), batch_size=4)
    b = it.next()
    assert b.data[0].context == mx.cpu(0)
    assert b.data[0].data_torch.device.type == "cpu"
    assert b.label[0].context == mx.cpu(0)
    it.close()
    if mx.num_gpus() == 0:
        with mx.gpu(0):
            with pytest.raises(MXNetError, match="no device"):
                mx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                      data_shape=(3, 32, 32), batch_size=4)


def test_close_joins_producer_and_pool(tmp_path):
    prefix, _ = _write_image_rec(tmp_path, n=8)
    it = mx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                               data_shape=(3, 32, 32), batch_size=2,
                               preprocess_threads=2, prefetch_buffer=1)
    it.next()
    producer, pool = it._producer, it._pool
    workers = list(pool._threads)
    it.close()
    assert not producer.is_alive() and it._pool is None
    assert not any(t.is_alive() for t in workers)
    with pytest.raises(StopIteration):
        it.next()


def test_prefetching_iter():
    data = np.arange(24, dtype=np.float32).reshape(12, 2)
    base = mx.io.NDArrayIter(data, np.zeros(12, np.float32), batch_size=4)
    it = mx.io.PrefetchingIter(base)
    batches = []
    try:
        while True:
            batches.append(it.next())
    except StopIteration:
        pass
    assert len(batches) == 3
    np.testing.assert_array_equal(batches[0].data[0].numpy(), data[:4])
    # probing past exhaustion must keep raising, not deadlock
    with pytest.raises(StopIteration):
        it.next()
    it.reset()
    assert tuple(it.next().data[0].shape) == (4, 2)
    it.close()
    two = mx.io.PrefetchingIter(
        [mx.io.NDArrayIter(data, batch_size=4),
         mx.io.NDArrayIter(data * 2, batch_size=4)],
        rename_data=[{"data": "a"}, {"data": "b"}],
        rename_label=[{}, {}])
    assert [d.name for d in two.provide_data] == ["a", "b"]
    b = two.next()
    np.testing.assert_array_equal(b.data[1].numpy(), data[:4] * 2)
    two.close()


def test_resize_iter():
    base = mx.io.NDArrayIter(np.zeros((10, 2), np.float32), batch_size=5)
    it = mx.io.ResizeIter(base, size=7)  # loops the 2-batch inner iter
    assert sum(1 for _ in it) == 7
    jit = jmx.io.ResizeIter(jmx.io.NDArrayIter(np.zeros((10, 2), np.float32),
                                               batch_size=5), size=7)
    assert sum(1 for _ in jit) == 7


def test_pipeline_feeds_training(tmp_path):
    """RecordIO images -> ImageRecordIter -> Gluon train step."""
    from mxnet_tpu_torch import autograd, gluon
    prefix, _ = _write_image_rec(tmp_path, n=16)
    it = mx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                               path_imgidx=prefix + ".idx",
                               data_shape=(3, 32, 32), batch_size=8,
                               shuffle=True, scale=1 / 255.0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(4, 3, activation="relu"),
            gluon.nn.GlobalAvgPool2D(), gluon.nn.Dense(3))
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(2):
        it.reset()
        for batch in it:
            with autograd.record():
                loss = loss_fn(net(batch.data[0]), batch.label[0]).mean()
            loss.backward()
            trainer.step(batch.data[0].shape[0])
            losses.append(float(loss.asscalar()))
    it.close()
    assert len(losses) == 4 and all(np.isfinite(losses))


def test_jpeg_dims_header_scan():
    import cv2
    from mxnet_tpu.io.io import _jpeg_dims as jax_dims
    from mxnet_tpu_torch.io.io import _jpeg_dims
    rng = np.random.RandomState(0)
    for hw in ((540, 720), (37, 61), (256, 256)):
        ok, enc = cv2.imencode(".jpg", rng.randint(0, 255, hw + (3,),
                                                   np.uint8),
                               [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert _jpeg_dims(enc.tobytes()) == jax_dims(enc.tobytes()) == hw
    ok, enc = cv2.imencode(".png", rng.randint(0, 255, (8, 9, 3), np.uint8))
    assert _jpeg_dims(enc.tobytes()) is None


def test_reduced_decode_matches_jax(tmp_path, monkeypatch):
    """The cv2 tier's DCT-reduced decode (source >= 2x the resize
    target), with the native tier off: bit for bit the JAX package's,
    and close to the full-decode + resize reference."""
    import cv2
    from mxnet_tpu.lib import nativelib as jnative
    from mxnet_tpu_torch.lib import nativelib
    monkeypatch.setattr(nativelib, "jpeg_available", lambda: False)
    monkeypatch.setattr(jnative, "jpeg_available", lambda: False)
    rng = np.random.RandomState(1)
    prefix = str(tmp_path / "big")
    writer = jrecordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    raws = []
    for i in range(2):
        img = cv2.resize(rng.randint(0, 255, (68, 90, 3), np.uint8),
                         (360, 270), interpolation=cv2.INTER_CUBIC)
        raws.append(img)
        writer.write_idx(i, jrecordio.pack_img(
            jrecordio.IRHeader(0, float(i), i, 0), img, quality=95,
            img_fmt=".jpg"))
    writer.close()
    got = _twin(prefix, data_shape=(3, 112, 112), batch_size=2, resize=128)
    for i, raw in enumerate(raws):
        h, w = raw.shape[:2]
        ref = cv2.resize(raw, (int(w * 128 / h), 128))
        y, x = (128 - 112) // 2, (ref.shape[1] - 112) // 2
        ref = ref[y:y + 112, x:x + 112, ::-1].transpose(2, 0, 1)
        assert np.abs(got[0][0][i] - ref.astype(np.float32)).mean() < 8.0


def test_sharded_trainer_steps_the_zoo_resnet(tmp_path):
    """``examples/train_imagenet.py``'s step on the port: an
    ``ImageRecordIter`` batch into ``ShardedTrainer`` over the zoo's
    resnet18_v1 (a Gluon block, BatchNorm's statistics as its aux
    state), SGD with momentum and the example's loss, from the port's
    weights loaded into the JAX model: the first loss within rtol 1e-5
    of the JAX trainer's and the weights written back after it within
    1e-4 of their max; the second loss within rtol 1e-3 (this net at
    batch 4 amplifies float32's rounding: 3e-5 in the first
    convolution's weights after one step gives 2.5e-4 in the next loss
    and 6e-2 in the third).  Then the example's AMP cast (``net.cast("bfloat16")``,
    ``dtype=bfloat16``), which the JAX package cannot run (its BatchNorm
    promotes to float32, and its first convolution refuses the float32
    batch): the caller casts the batch, as the example's evaluation does,
    and the port keeps BatchNorm's output in the input's dtype; its first
    loss is the eager bfloat16 forward's (training mode) within rtol
    1e-5 (``tests/test_torch_trainer_amp.py`` holds the bfloat16 step to
    plain PyTorch)."""
    import jax
    import jax.numpy as jnp
    import torch
    from mxnet_tpu_torch import parallel
    prefix, _ = _write_image_rec(tmp_path, n=4, hw=(32, 32))
    it = mx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                               data_shape=(3, 32, 32), batch_size=4,
                               scale=1 / 255.0)
    batch = it.next()
    it.close()
    x, y = batch.data[0], batch.label[0].astype("int32")
    path = str(tmp_path / "r18.npz")
    mx.random.seed(0)
    net = mx.gluon.model_zoo.get_model("resnet18_v1", classes=6)
    net.initialize(mx.init.Xavier())
    net(x)
    net.save_parameters(path)
    opt = dict(optimizer="sgd", n_labels=1,
               optimizer_params={"learning_rate": 0.02, "momentum": 0.9})

    def loss_fn(logits, labels):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(1, labels[:, None].long()).mean()

    def port(dtype):
        m = mx.gluon.model_zoo.get_model("resnet18_v1", classes=6)
        m.load_parameters(path)
        if dtype is not None:
            m.cast("bfloat16")
        xd = x if dtype is None else x.astype("bfloat16")
        tr = parallel.ShardedTrainer(
            m, loss_fn, parallel.make_mesh(dp=1, device="cpu"),
            example_inputs=(mx.nd.zeros((4, 3, 32, 32), dtype=xd.dtype),),
            dtype=dtype, **opt)
        first = float(tr.step(xd, y))
        tr.write_back()
        return m, [first, float(tr.step(xd, y))]

    def jax_loss(logits, labels):
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(logp, labels[:, None], axis=1).mean()

    saved = np.load(path)
    jnet = jmx.gluon.model_zoo.get_model("resnet18_v1", classes=6)
    for key, p in jnet._collect_params_with_prefix().items():
        p.shape = tuple(saved[key].shape)
    jnet.initialize(jmx.init.Zero())
    jnet.load_parameters(path)
    jtr = jmx.parallel.ShardedTrainer(
        jnet, jax_loss,
        jmx.parallel.make_mesh(dp=1, tp=1, sp=1, devices=jax.devices()[:1]),
        example_inputs=(jmx.nd.zeros((4, 3, 32, 32)),), **opt)
    jx = jmx.nd.array(x.asnumpy())
    jy = jmx.nd.array(y.asnumpy(), dtype="int32")
    want = [float(jax.device_get(jtr.step(jx, jy)))]
    jtr.write_back()
    jparams = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
    want.append(float(jax.device_get(jtr.step(jx, jy))))
    m, got = port(None)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
    for key, p in m._collect_params_with_prefix().items():
        w, jw = p.data().asnumpy(), jparams[key]
        assert np.abs(w - jw).max() <= 1e-4 * max(np.abs(jw).max(), 1.0), key
    m16 = mx.gluon.model_zoo.get_model("resnet18_v1", classes=6)
    m16.load_parameters(path)
    m16.cast("bfloat16")
    with mx.autograd.record():
        out = m16(x.astype("bfloat16"))
    assert out.shape == (4, 6) and out.data_torch.dtype == torch.bfloat16
    eager = float(loss_fn(out.data_torch.detach(), y.data_torch))
    _m, got16 = port(torch.bfloat16)
    assert all(np.isfinite(got16))
    np.testing.assert_allclose(got16[0], eager, rtol=1e-5)
