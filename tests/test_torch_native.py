"""PyTorch port, the native IO library (``mxnet_tpu_torch.lib``), twins
of ``tests/test_native.py``: the record reader and writer byte for byte
against both packages' Python readers and the JAX package's native
library, the CSV parser against ``np.loadtxt`` and the JAX parser, the
threaded JPEG decode bit for bit against the JAX package's native tier
(the same source and flags), the ABI check (a library lacking a symbol
is rebuilt) and the committed JPEG fixture, which cv2 must regenerate."""
import ctypes
import os
import struct
import subprocess

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrecordio
from mxnet_tpu.lib import nativelib as jnative

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.lib import nativelib

_MAGIC = struct.pack("<I", 0xCED7230A)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "jpeg_records.npz")


def _need_jpeg():
    if not nativelib.jpeg_available():
        pytest.skip("no libjpeg on this host: "
                    f"{nativelib.jpeg_build_error()}")


def _read_all(reader):
    got = []
    while True:
        s = reader.read()
        if s is None:
            return got
        got.append(s)


def test_builds_into_build_dir_under_a_source_digest():
    assert nativelib.available()
    path = nativelib.library_path()
    assert os.path.dirname(path) == nativelib.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "mxnet_tpu_torch"
    assert os.path.exists(path) and "-" in os.path.basename(path)
    lib = ctypes.CDLL(path)
    assert lib.mxnative_abi_version() == nativelib.ABI_VERSION == 2
    # nothing is built next to the sources
    assert not [f for f in os.listdir(os.path.dirname(nativelib.__file__))
                if f.endswith(".so")]


@pytest.mark.parametrize("case", ["roundtrip", "native_write_python_read",
                                  "python_write_native_read"])
def test_record_io_against_both_packages(tmp_path, case):
    path = str(tmp_path / "t.rec")
    payloads = [b"hello", b"x" * 1000, _MAGIC + b"lead",
                b"a" + _MAGIC + b"b" + _MAGIC + b"c", b"", _MAGIC * 3]
    if case == "python_write_native_read":
        wr = recordio.MXRecordIO(path, "w")
        for p in payloads:
            wr.write(p)
        wr.close()
    else:
        w = nativelib.NativeRecordWriter(path)
        for p in payloads:
            w.write(p)
        w.close()
        with open(path, "rb") as f:
            mine = f.read()
        jw = jnative.NativeRecordWriter(str(tmp_path / "j.rec"))
        for p in payloads:
            jw.write(p)
        jw.close()
        with open(tmp_path / "j.rec", "rb") as f:
            assert f.read() == mine
    if case == "native_write_python_read":
        assert _read_all(recordio.MXRecordIO(path, "r")) == payloads
        assert _read_all(jrecordio.MXRecordIO(path, "r")) == payloads
    else:
        r = nativelib.NativeRecordReader(path)
        offs = r.index()
        np.testing.assert_array_equal(
            offs, jnative.NativeRecordReader(path).index())
        assert [r.read_at(o) for o in offs] == payloads
        r.close()


def test_corrupt_file_detected(tmp_path):
    path = str(tmp_path / "bad.rec")
    with open(path, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(IOError):
        nativelib.NativeRecordReader(path).index()


def test_csv_parse_matches_numpy_and_jax(tmp_path):
    path = str(tmp_path / "d.csv")
    ref = np.random.RandomState(0).randn(20, 7).astype(np.float32)
    np.savetxt(path, ref, delimiter=",", fmt="%.6g")
    out = nativelib.csv_load(path)
    np.testing.assert_array_equal(
        out, np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2))
    np.testing.assert_array_equal(out, jnative.csv_load(path))


def test_csviter_uses_native(tmp_path):
    path, lpath = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    data = np.arange(24, dtype=np.float32).reshape(6, 4)
    np.savetxt(path, data, delimiter=",", fmt="%g")
    np.savetxt(lpath, np.arange(6, dtype=np.float32), delimiter=",",
               fmt="%g")
    batch = next(mx.io.CSVIter(path, (4,), label_csv=lpath, batch_size=3))
    want = next(jmx.io.CSVIter(path, (4,), label_csv=lpath, batch_size=3))
    np.testing.assert_array_equal(batch.data[0].numpy(), data[:3])
    np.testing.assert_array_equal(batch.data[0].numpy(),
                                  want.data[0].asnumpy())


def test_header_csv_raises(tmp_path):
    path = str(tmp_path / "h.csv")
    with open(path, "w") as f:
        f.write("x,y,z\n1,2,3\n")
    with pytest.raises(ValueError):
        nativelib.csv_load(path)


def test_stale_library_missing_a_symbol_is_rebuilt(tmp_path, monkeypatch):
    """A library at the digest path that lacks an export of ABI 2 (the
    JAX copy's fault: new exports under an unchanged version) is
    unloaded and built again, never called."""
    stale_src = tmp_path / "stale.cc"
    stale_src.write_text('extern "C" int mxnative_abi_version() '
                         '{ return 2; }\n')
    build_dir = tmp_path / "build"
    build_dir.mkdir()
    monkeypatch.setattr(nativelib, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(nativelib, "_lib", None)
    monkeypatch.setattr(nativelib, "_tried", False)
    path = nativelib.library_path()
    subprocess.check_call(["g++", "-shared", "-fPIC", "-o", path,
                           str(stale_src)])
    stale = ctypes.CDLL(path)
    assert not hasattr(stale, "mxrec_open")
    nativelib._close(stale)
    assert nativelib.available()
    lib = ctypes.CDLL(path)
    assert all(hasattr(lib, s) for s in nativelib.SYMBOLS)
    rec = str(tmp_path / "t.rec")
    w = nativelib.NativeRecordWriter(rec)
    w.write(b"after the rebuild")
    w.close()
    r = nativelib.NativeRecordReader(rec)
    assert [r.read_at(o) for o in r.index()] == [b"after the rebuild"]


def test_no_idx_scan_uses_native(tmp_path):
    rec_path = str(tmp_path / "imgs.rec")
    w = recordio.MXRecordIO(rec_path, "w")
    rng = np.random.RandomState(0)
    for i in range(10):
        img = rng.randint(0, 255, (20, 20, 3)).astype(np.uint8)
        header = recordio.IRHeader(0, float(i % 3), i, 0)
        w.write(recordio.pack_img(header, img, img_fmt=".png"))
    w.close()
    with mx.cpu(0):
        it = mx.io.ImageRecordIter(rec_path, (3, 16, 16), batch_size=5)
    assert it._native is not None          # C++ scanner active
    batch = it.next()
    want = jmx.io.ImageRecordIter(rec_path, (3, 16, 16), batch_size=5).next()
    assert batch.data[0].shape == (5, 3, 16, 16)
    np.testing.assert_array_equal(batch.data[0].asnumpy(),
                                  want.data[0].asnumpy())
    np.testing.assert_array_equal(batch.label[0].asnumpy(),
                                  want.label[0].asnumpy())
    it.close()


def _jpeg(rng, hw=(300, 400), quality=92):
    import cv2
    img = rng.randint(0, 255, hw + (3,), dtype=np.uint8)
    return cv2.imencode(".jpg", img[:, :, ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()


def _both(bufs, *args):
    out, status = nativelib.decode_jpeg_batch(bufs, *args)
    jout, jstatus = jnative.decode_jpeg_batch(bufs, *args)
    np.testing.assert_array_equal(status, jstatus)
    # a failed image's rows are left unwritten
    np.testing.assert_array_equal(out[status == 0], jout[status == 0])
    return out, status


def test_decode_batch_matches_cv2_and_jax():
    import cv2
    _need_jpeg()
    rng = np.random.RandomState(0)
    bufs = [_jpeg(rng) for _ in range(4)]
    cy = np.full(4, -1.0, np.float32)      # center-crop sentinel
    out, status = _both(bufs, 256, 224, 224, cy, cy, np.zeros(4, np.uint8), 2)
    assert status.tolist() == [0, 0, 0, 0]
    assert out.shape == (4, 3, 224, 224) and out.dtype == np.uint8
    for i, buf in enumerate(bufs):
        ref = cv2.imdecode(np.frombuffer(buf, np.uint8),
                           cv2.IMREAD_COLOR)[:, :, ::-1]
        h, w = ref.shape[:2]
        s = 256.0 / min(h, w)
        r = cv2.resize(ref, (int(w * s + 0.5), int(h * s + 0.5)))
        y0, x0 = (r.shape[0] - 224) // 2, (r.shape[1] - 224) // 2
        want = r[y0:y0 + 224, x0:x0 + 224].transpose(2, 0, 1)
        assert np.abs(out[i].astype(int) - want.astype(int)).mean() < 6.0


def test_mirror_and_integer_crop():
    _need_jpeg()
    buf = _jpeg(np.random.RandomState(1), hw=(256, 256))
    cy = np.full(1, -1.0, np.float32)
    plain, s1 = _both([buf], 0, 224, 224, cy, cy, np.zeros(1, np.uint8), 1)
    flipped, s2 = _both([buf], 0, 224, 224, cy, cy, np.ones(1, np.uint8), 1)
    assert s1[0] == 0 and s2[0] == 0
    np.testing.assert_array_equal(plain[0], flipped[0][:, :, ::-1])


def test_bad_payload_reports_status_not_crash():
    _need_jpeg()
    good = _jpeg(np.random.RandomState(2))
    cy = np.full(2, -1.0, np.float32)
    _out, status = _both([b"\xff\xd8 not really a jpeg", good], 256, 64, 64,
                         cy, cy, np.zeros(2, np.uint8), 2)
    assert status[0] == 1 and status[1] == 0


def _write_rec(path, n, hw, fmt_of, seed):
    w = jrecordio.MXIndexedRecordIO(path + ".idx", path, "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = rng.randint(0, 255, hw + (3,), np.uint8)
        w.write_idx(i, jrecordio.pack_img(
            jrecordio.IRHeader(0, float(i), i, 0), img, quality=90,
            img_fmt=fmt_of(i)))
    w.close()


def _epoch(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
    return out


@pytest.mark.parametrize("shard", ["mixed", "png"])
def test_iterator_native_tier_matches_jax(tmp_path, shard):
    """Mixed shard: JPEG batches through the native tier, every 3rd
    record (PNG) through the per-image path; all-PNG shard: the first
    batch turns the probe off.  Both bit for bit against the JAX
    package, random crops and mirrors included."""
    _need_jpeg()
    rec = str(tmp_path / f"{shard}.rec")
    hw = (300, 400) if shard == "mixed" else (64, 64)
    _write_rec(rec, 12 if shard == "mixed" else 6, hw,
               (lambda i: ".jpg" if i % 3 else ".png")
               if shard == "mixed" else (lambda i: ".png"), 3)
    kw = dict(data_shape=(3, 224, 224) if shard == "mixed" else (3, 32, 32),
              batch_size=6, shuffle=True, rand_crop=True, rand_mirror=True,
              resize=256 if shard == "mixed" else -1, seed=5,
              preprocess_threads=2)
    with mx.cpu(0):
        it = mx.io.ImageRecordIter(rec, **kw)
    got = _epoch(it)
    want = _epoch(jmx.io.ImageRecordIter(rec, **kw))
    assert len(got) == len(want) > 0
    for (d, lab), (jd, jlab) in zip(got, want):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(lab, jlab)
    assert it._native_jpeg == (shard == "mixed")
    it.close()


def _fixture_arrays():
    """8 seeded smooth 96x72 JPEGs at quality 90 and cv2's RGB pixels."""
    import cv2
    rng = np.random.RandomState(27)
    bufs, pixels = [], []
    for _ in range(8):
        base = rng.randint(0, 255, (4, 5, 3), np.uint8)
        img = cv2.resize(base, (96, 72), interpolation=cv2.INTER_LINEAR)
        buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1]
        bufs.append(buf.reshape(-1))
        pixels.append(cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1])
    return bufs, np.stack(pixels)


def test_jpeg_fixture_is_what_cv2_makes():
    """tests/fixtures/jpeg_records.npz (the card's JPEG check) holds what
    this function makes: regenerate it with ``np.savez_compressed(FIXTURE,
    pixels=pixels, **{f"jpeg_{i}": b for i, b in enumerate(bufs)})``."""
    bufs, pixels = _fixture_arrays()
    assert os.path.getsize(FIXTURE) <= 150 * 1024
    with np.load(FIXTURE) as f:
        np.testing.assert_array_equal(f["pixels"], pixels)
        for i, b in enumerate(bufs):
            np.testing.assert_array_equal(f[f"jpeg_{i}"], b)
    if nativelib.jpeg_available():
        cy = np.full(8, -1.0, np.float32)
        out, status = _both([b.tobytes() for b in bufs], 0, 72, 96, cy, cy,
                            np.zeros(8, np.uint8), 2)
        assert not status.any()
        diff = np.abs(out.transpose(0, 2, 3, 1).astype(int)
                      - pixels.astype(int)).mean()
        assert diff < 6.0, diff
