"""RecordIO of the PyTorch port: the reference's packed binary record
container (reference: ``python/mxnet/recordio.py`` and dmlc-core's
``include/dmlc/recordio.h``; the counterpart of ``mxnet_tpu.recordio``).
Files are byte-compatible both ways with the JAX package's, and with
existing ``.rec`` / ``.idx`` datasets (im2rec output):

- record frame: ``[magic:u32][lrec:u32][payload][pad to 4B]`` where
  ``lrec = cflag<<29 | len``; payloads containing the magic word are split
  into multipart records (cflag 1/2/3) exactly like dmlc::RecordIOWriter.
- image record payload: ``IRHeader`` (flag, label, id, id2) + image bytes;
  ``flag > 0`` carries that many extra label floats.

The reader and writer are Python over buffered file IO (the native
tier is ``lib.nativelib``).  ``pack_img`` / ``unpack_img`` encode and
decode with the ``image`` module's codec chain (cv2, PIL, the built-in
PNG codec).
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1
_MAGIC_BYTES = struct.pack("<I", _MAGIC)


def _pad4(n):
    return (4 - n % 4) % 4


class MXRecordIO:
    """Sequential record reader/writer (reference: MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        if flag not in ("r", "w"):
            raise MXNetError(f"invalid flag {flag!r} (use 'r' or 'w')")
        self.open()

    def open(self):
        self._f = open(self.uri, "rb" if self.flag == "r" else "wb")
        self._is_open = True

    def close(self):
        # mxlint: disable=atomicity (contract: a reader/writer is
        # owned by one thread; close() only races itself when that
        # ownership contract is already broken)
        if self._is_open:
            self._f.close()
            self._is_open = False

    def reset(self):
        self.close()
        self.open()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def tell(self):
        return self._f.tell()

    # ------------------------------------------------------------- write
    def write(self, buf: bytes):
        if self.flag != "w":
            raise MXNetError("record file opened read-only")
        # split payload at embedded magic words (dmlc multipart framing)
        parts = buf.split(_MAGIC_BYTES)
        n = len(parts)
        for i, part in enumerate(parts):
            if n == 1:
                cflag = 0
            elif i == 0:
                cflag = 1
            elif i == n - 1:
                cflag = 3
            else:
                cflag = 2
            lrec = (cflag << 29) | len(part)
            self._f.write(_MAGIC_BYTES)
            self._f.write(struct.pack("<I", lrec))
            self._f.write(part)
            self._f.write(b"\x00" * _pad4(len(part)))

    # -------------------------------------------------------------- read
    def read(self):
        """Next record payload, or None at EOF."""
        if self.flag != "r":
            raise MXNetError("record file opened write-only")
        chunks = []
        while True:
            head = self._f.read(8)
            if len(head) == 0 and not chunks:
                return None
            if len(head) < 8:
                raise MXNetError("truncated record header")
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise MXNetError(
                    f"bad record magic 0x{magic:08x} at "
                    f"{self._f.tell() - 8}")
            cflag = (lrec >> 29) & 7
            length = lrec & _LEN_MASK
            data = self._f.read(length)
            if len(data) < length:
                raise MXNetError("truncated record payload")
            self._f.read(_pad4(length))
            chunks.append(data)
            if cflag in (0, 3):
                if cflag == 0 and len(chunks) > 1:
                    raise MXNetError("dangling multipart record")
                break
        return _MAGIC_BYTES.join(chunks)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records via a ``key\\tpos`` .idx sidecar
    (reference: MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.key_type = key_type
        self.idx = {}
        self.keys = []
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    key, pos = line.strip().split("\t")
                    key = key_type(key)
                    self.idx[key] = int(pos)
                    self.keys.append(key)

    def close(self):
        if getattr(self, "_is_open", False) and self.flag == "w":
            with open(self.idx_path, "w") as f:
                for key in self.keys:
                    f.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def read_idx(self, idx):
        self._f.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


# --------------------------------------------------------------------------
# image record payloads
# --------------------------------------------------------------------------
IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Serialize header + raw payload (reference: recordio.pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, (list, tuple, np.ndarray)):
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s: bytes):
    """-> (IRHeader, payload) (reference: recordio.unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC uint8 image and pack it (reference: ``pack_img``)
    with the ``image`` module's codec chain: ``img`` is in cv2's channel
    order (BGR), as the reference's.  The built-in codec writes PNG
    whatever ``img_fmt`` says, as the JAX package's numpy backend does."""
    from .image import image as _image
    if img_fmt not in (".jpg", ".jpeg", ".png"):
        raise MXNetError(f"unsupported image format {img_fmt!r}")
    arr = np.asarray(img)
    if _image._BACKEND == "cv2":
        import cv2
        params = [cv2.IMWRITE_JPEG_QUALITY, quality] \
            if img_fmt in (".jpg", ".jpeg") \
            else [cv2.IMWRITE_PNG_COMPRESSION, quality // 10]
        ok, buf = cv2.imencode(img_fmt, arr, params)
        if not ok:
            raise MXNetError("image encode failed")
        return pack(header, buf.tobytes())
    rgb = arr[:, :, ::-1] if arr.ndim == 3 and arr.shape[2] == 3 else arr
    return pack(header, _image.imencode(np.ascontiguousarray(rgb), img_fmt,
                                        quality))


def unpack_img(s, iscolor=1):
    """-> (IRHeader, HWC uint8 numpy image in cv2's channel order, BGR)
    (reference: ``unpack_img``), with the ``image`` module's codec
    chain."""
    from .image import image as _image
    header, payload = unpack(s)
    if _image._BACKEND == "cv2":
        import cv2
        img = cv2.imdecode(np.frombuffer(payload, dtype=np.uint8), iscolor)
        if img is None:
            raise MXNetError("image decode failed")
        return header, img
    try:
        img = _image._decode(payload, 1 if iscolor else 0)
    except MXNetError as e:
        raise MXNetError(f"image decode failed: {e}") from e
    if iscolor:
        return header, np.ascontiguousarray(img[:, :, ::-1])
    return header, img[:, :, 0]
