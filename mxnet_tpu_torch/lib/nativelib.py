"""ctypes binding and on-demand build of the native IO library (the
counterpart of ``mxnet_tpu.lib.nativelib``).

Reference: the reference links dmlc-core/src/recordio.cc and the C++
iterator tier into libmxnet.so at build time.  Here the library is one
translation unit, ``src/nativelib.cc``, compiled with ``g++`` at first
use into ``build/mxnet_tpu_torch/`` at the repository root, under a file
name that carries a digest of the source and the flags: an edited source
builds a new library, and a stale one is never loaded.  Nothing is built
next to the sources.

Loading checks the ABI version (:data:`ABI_VERSION`) and every symbol of
:data:`SYMBOLS`; a library that fails either check is unloaded and built
again, never called.  The build tries ``-ljpeg`` first; without libjpeg
it builds the record and CSV tiers alone and keeps the compiler's
message beside the library (:func:`jpeg_build_error`; delete the
library to try the JPEG build again).  Every caller keeps a
pure-Python tier, so a missing
compiler costs speed, not correctness: :func:`available` and
:func:`jpeg_available` say which tier runs.  ``MXNET_TPU_DISABLE_NATIVE``
turns the library off.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..base import env_truthy

__all__ = ["ABI_VERSION", "SYMBOLS", "BUILD_DIR", "library_path",
           "available", "jpeg_available", "jpeg_build_error",
           "NativeRecordReader", "NativeRecordWriter", "decode_jpeg_batch",
           "csv_load"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "nativelib.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "mxnet_tpu_torch")
ABI_VERSION = 2
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# every export of ABI 2; the JPEG entry point only where libjpeg linked
SYMBOLS = ("mxnative_abi_version", "mxnative_has_jpeg", "mxrec_open",
           "mxrec_close", "mxrec_index", "mxrec_read_at", "mxrec_create",
           "mxrec_write", "mxcsv_shape", "mxcsv_parse")
JPEG_SYMBOLS = ("mxjpeg_decode_batch",)

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the library builds to: the name carries a digest of the
    source and the flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmxnet_native-{h.hexdigest()[:16]}.so")


def _nojpeg_note(path):
    return path + ".nojpeg.txt"


def _compile(path, extra):
    """One ``g++`` run into ``path`` (through a temporary file, so a
    concurrent loader never sees half a library); (ok, message)."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *FLAGS, "-o", tmp, _SRC, *extra]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        return False, f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0 or not os.path.exists(tmp):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False, (f"{' '.join(cmd)} (exit {proc.returncode}):\n"
                       f"{proc.stderr.strip()}")
    os.replace(tmp, path)
    return True, ""


def _build(path) -> bool:
    """Build the library: with libjpeg, else without it, keeping the
    JPEG build's message beside the library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    ok, why = _compile(path, ["-ljpeg"])
    if ok:
        if os.path.exists(_nojpeg_note(path)):
            os.remove(_nojpeg_note(path))
        return True
    ok, _ = _compile(path, ["-DMXNATIVE_NO_JPEG"])
    if ok:
        with open(_nojpeg_note(path), "w") as f:
            f.write(why + "\n")
    return ok


def _open(path):
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _close(lib):
    """Unload ``lib``, so that a rebuilt file at the same path is mapped
    anew by the next ``dlopen``."""
    import _ctypes
    try:
        _ctypes.dlclose(lib._handle)
    except OSError:
        pass


def _stale(lib) -> bool:
    """True when ``lib`` is not this source's ABI: a symbol is missing or
    the version differs."""
    if not all(hasattr(lib, s) for s in SYMBOLS):
        return True
    lib.mxnative_abi_version.restype = ctypes.c_int
    if lib.mxnative_abi_version() != ABI_VERSION:
        return True
    return bool(lib.mxnative_has_jpeg()) and not all(
        hasattr(lib, s) for s in JPEG_SYMBOLS)


def _bind(lib):
    lib.mxrec_open.restype = ctypes.c_void_p
    lib.mxrec_open.argtypes = [ctypes.c_char_p]
    lib.mxrec_close.argtypes = [ctypes.c_void_p]
    lib.mxrec_index.restype = ctypes.c_int64
    lib.mxrec_index.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.c_int64]
    lib.mxrec_read_at.restype = ctypes.c_int64
    lib.mxrec_read_at.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_char_p, ctypes.c_int64]
    lib.mxrec_create.restype = ctypes.c_void_p
    lib.mxrec_create.argtypes = [ctypes.c_char_p]
    lib.mxrec_write.restype = ctypes.c_int64
    lib.mxrec_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int64]
    lib.mxcsv_shape.restype = ctypes.c_int64
    lib.mxcsv_shape.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int64)]
    lib.mxcsv_parse.restype = ctypes.c_int64
    lib.mxcsv_parse.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int64]
    if lib.mxnative_has_jpeg():
        lib.mxjpeg_decode_batch.restype = ctypes.c_int64
        lib.mxjpeg_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64]
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        # '0'/'' = off, like every other boolean knob
        if env_truthy("MXNET_TPU_DISABLE_NATIVE"):
            return None
        path = library_path()
        lib = _open(path) if os.path.exists(path) else None
        if lib is not None and _stale(lib):
            _close(lib)
            lib = None
        if lib is None:
            if not _build(path):
                return None
            lib = _open(path)
            if lib is None or _stale(lib):
                return None
        _lib = _bind(lib)
        return _lib


def available() -> bool:
    """True when the native library is built and loaded (the record and
    CSV tiers run natively)."""
    return _load() is not None


def jpeg_available() -> bool:
    """True when the loaded library decodes JPEG (libjpeg was linked)."""
    lib = _load()
    return lib is not None and bool(lib.mxnative_has_jpeg())


def jpeg_build_error():
    """The compiler's message of the failed ``-ljpeg`` build behind a
    library without the JPEG tier, else None."""
    note = _nojpeg_note(library_path())
    if not os.path.exists(note):
        return None
    with open(note) as f:
        return f.read().strip()


# ---------------------------------------------------------------------------
# high-level wrappers (all raise RuntimeError when the lib is unavailable;
# callers gate on available())
# ---------------------------------------------------------------------------

class NativeRecordReader:
    """Random-access record reader over the C++ scanner."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.mxrec_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path!r}")

    def close(self):
        if self._h:
            self._lib.mxrec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def index(self) -> np.ndarray:
        """Byte offsets of every logical record (the .idx-less scan)."""
        count = self._lib.mxrec_index(self._h, None, 0)
        if count < 0:
            raise IOError("corrupt record file")
        offsets = np.zeros(count, np.int64)
        got = self._lib.mxrec_index(
            self._h,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), count)
        if got != count:
            raise IOError("record file changed during scan")
        return offsets

    def read_at(self, offset: int) -> bytes:
        need = self._lib.mxrec_read_at(self._h, offset, None, 0)
        if need < 0:
            raise IOError(f"corrupt record at offset {offset}")
        buf = ctypes.create_string_buffer(need)
        got = self._lib.mxrec_read_at(self._h, offset, buf, need)
        if got != need:
            raise IOError(f"short read at offset {offset}")
        return buf.raw


class NativeRecordWriter:
    """Record writer over the C++ framer (multipart split of embedded
    magic words, as dmlc's)."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.mxrec_create(path.encode())
        if not self._h:
            raise OSError(f"cannot create {path!r}")

    def write(self, payload: bytes) -> int:
        n = self._lib.mxrec_write(self._h, payload, len(payload))
        if n < 0:
            raise IOError("record write failed")
        return n

    def close(self):
        if self._h:
            self._lib.mxrec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_jpeg_batch(bufs, resize_min, out_h, out_w, cy_frac, cx_frac,
                      mirror, n_threads):
    """Decode a batch of JPEG byte strings on native OS threads.

    Returns (batch (n, 3, out_h, out_w) uint8, status (n,) uint8 —
    0 = decoded, nonzero = that image needs the Python fallback).
    Augmentation randomness (crop fractions, mirror flags) is supplied
    by the caller so the seeded-RNG contract is unchanged.
    """
    lib = _load()
    if lib is None or not lib.mxnative_has_jpeg():
        raise RuntimeError("native JPEG tier unavailable")
    n = len(bufs)
    arr = (ctypes.c_char_p * n)(*bufs)
    lens = np.array([len(b) for b in bufs], np.int64)
    out = np.empty((n, 3, out_h, out_w), np.uint8)
    status = np.ones(n, np.uint8)
    lib.mxjpeg_decode_batch(
        ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p)), lens, n,
        int(resize_min or 0), int(out_h), int(out_w),
        np.ascontiguousarray(cy_frac, np.float32),
        np.ascontiguousarray(cx_frac, np.float32),
        np.ascontiguousarray(mirror, np.uint8), out, status,
        int(n_threads))
    return out, status


def csv_load(path: str) -> np.ndarray:
    """Parse a numeric CSV into a (rows, cols) float32 array."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n_vals = ctypes.c_int64()
    rows = lib.mxcsv_shape(path.encode(), ctypes.byref(n_vals))
    if rows < 0:
        raise OSError(f"cannot open {path!r}")
    out = np.empty(n_vals.value, np.float32)
    got = lib.mxcsv_parse(path.encode(), out, n_vals.value)
    if got == -3:
        raise ValueError(
            f"non-numeric field in {path!r} (header line?) — "
            f"CSVIter expects numeric-only files")
    if got != n_vals.value:
        raise IOError(f"csv parse mismatch in {path!r}")
    if rows and n_vals.value % rows:
        raise IOError(f"ragged csv {path!r}")
    return out.reshape(rows, n_vals.value // rows) if rows else \
        out.reshape(0, 0)
