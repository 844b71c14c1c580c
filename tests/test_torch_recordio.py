"""PyTorch port, ``recordio`` (``mxnet_tpu_torch/recordio.py``).

Twins of ``tests/test_io.py::test_recordio_roundtrip``,
``::test_recordio_payload_containing_magic``, ``::test_indexed_recordio``
and ``::test_pack_unpack_header``; files written by each package are read
by the other, byte for byte; ``RecordFileDataset`` over a port-written
file; the image-codec functions raise ``MXNetError``.
"""
import os
import struct

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec

from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.data import RecordFileDataset


def test_recordio_roundtrip(tmp_path):
    path = str(tmp_path / "t.rec")
    payloads = [b"hello", b"", b"x" * 1000, os.urandom(37)]
    w = recordio.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()
    r = recordio.MXRecordIO(path, "r")
    got = []
    while True:
        rec = r.read()
        if rec is None:
            break
        got.append(rec)
    assert got == payloads


def test_recordio_payload_containing_magic(tmp_path):
    path = str(tmp_path / "m.rec")
    magic = struct.pack("<I", 0xced7230a)
    payloads = [magic, b"a" + magic + b"b", magic * 3, b"pre" + magic]
    w = recordio.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()
    r = recordio.MXRecordIO(path, "r")
    for want in payloads:
        assert r.read() == want
    assert r.read() is None


def test_indexed_recordio(tmp_path):
    path = str(tmp_path / "i.rec")
    idx_path = str(tmp_path / "i.idx")
    w = recordio.MXIndexedRecordIO(idx_path, path, "w")
    for i in range(10):
        w.write_idx(i, f"record-{i}".encode())
    w.close()
    r = recordio.MXIndexedRecordIO(idx_path, path, "r")
    assert r.keys == list(range(10))
    for i in (3, 0, 9, 5):
        assert r.read_idx(i) == f"record-{i}".encode()


def test_pack_unpack_header():
    h = recordio.IRHeader(0, 3.5, 7, 0)
    packed = recordio.pack(h, b"payload")
    h2, payload = recordio.unpack(packed)
    assert payload == b"payload"
    assert h2.label == pytest.approx(3.5) and h2.id == 7
    h = recordio.IRHeader(0, [1.0, 2.0, 3.0], 1, 0)
    h2, payload = recordio.unpack(recordio.pack(h, b"x"))
    np.testing.assert_allclose(h2.label, [1.0, 2.0, 3.0])
    assert payload == b"x"


def _records():
    magic = struct.pack("<I", 0xced7230a)
    rs = np.random.RandomState(0)
    return [recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                          rs.bytes(5 + 13 * i) + (magic if i % 3 else b""))
            for i in range(7)] + [
        recordio.pack(recordio.IRHeader(0, [1.0, 2.0], 99, 0), b"multi")]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_cross_both_packages_byte_for_byte(tmp_path, writer):
    recs = _records()
    files = {}
    for name, mod in (("port", recordio), ("jax", jrec)):
        rec = str(tmp_path / f"{name}.rec")
        idx = str(tmp_path / f"{name}.idx")
        w = mod.MXIndexedRecordIO(idx, rec, "w")
        for i, r in enumerate(recs):
            w.write_idx(i, r)
        w.close()
        files[name] = (idx, rec)
    for a, b in zip(files["port"], files["jax"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    reader = jrec if writer == "port" else recordio
    idx, rec = files[writer]
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    for i in reversed(range(len(recs))):
        assert r.read_idx(i) == recs[i]
    h_port = recordio.unpack(recs[-1])
    h_jax = jrec.unpack(recs[-1])
    np.testing.assert_array_equal(h_port[0].label, h_jax[0].label)
    assert h_port[1] == h_jax[1]
    assert recordio.pack(recordio.IRHeader(0, 2.5, 3, 4), b"z") \
        == jrec.pack(jrec.IRHeader(0, 2.5, 3, 4), b"z")


def test_record_file_dataset(tmp_path):
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(5):
        w.write_idx(i, f"item-{i}".encode())
    w.close()
    ds = RecordFileDataset(rec)
    assert len(ds) == 5
    assert [ds[i] for i in range(5)] == [f"item-{i}".encode()
                                         for i in range(5)]


@pytest.mark.parametrize("fn", ["pack_img", "unpack_img"])
def test_image_codec_functions_name_the_missing_item(fn):
    """The image codec is ported (ROADMAP 6.7): ``pack_img`` and
    ``unpack_img`` round-trip an image, and what they cannot encode or
    decode raises :class:`MXNetError` naming what is wrong."""
    img = np.arange(2 * 2 * 3, dtype=np.uint8).reshape(2, 2, 3)
    s = recordio.pack_img(recordio.IRHeader(0, 0.0, 0, 0), img,
                          img_fmt=".png")
    np.testing.assert_array_equal(recordio.unpack_img(s)[1], img)
    args = ((recordio.IRHeader(0, 0.0, 0, 0), img, 95, ".gif")
            if fn == "pack_img" else (b"\0" * 32,))
    with pytest.raises(MXNetError, match="format" if fn == "pack_img"
                       else "decode"):
        getattr(recordio, fn)(*args)
