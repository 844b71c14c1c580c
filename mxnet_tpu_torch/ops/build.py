"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  Libraries go to
``build/mxnet_tpu_torch/`` at the repository root, named by a digest of
their source, every ``csrc/*.cuh`` header and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.  Nothing is built at import time: the first
kernel launch builds what it needs, and :func:`build` compiles a list
of sources in parallel (one ``nvcc`` per source, all started together).

With ``MXNET_COMPILE_CACHE_DIR`` set, the persistent compile cache
(:mod:`mxnet_tpu_torch.compile_cache`) is the tier behind
``BUILD_DIR``: :func:`build` looks each missing library up there under
its digest name before it runs ``nvcc``, writes a verified hit to
``BUILD_DIR`` atomically, and stores each library it compiles.  A
corrupt entry is a counted miss and the library is compiled again.
With the variable unset nothing is read or stored outside ``BUILD_DIR``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .. import compile_cache as _cc
from ..base import KernelError

__all__ = ["SOURCES", "BUILD_DIR", "build", "entry", "load",
           "library_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mxnet_tpu_torch")
SOURCES = ("ragged_paged_attention", "ragged_paged_verify",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}
_ENTRIES = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelError(
            "mxnet_tpu_torch kernels: nvcc not found (looked on PATH and "
            "in /usr/local/cuda/bin); the CUDA kernels build only where "
            "the CUDA toolkit is installed")
    return path


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to: the file name carries a
    digest of the source, every header in ``csrc/`` and the flags, so
    an edited header rebuilds every library that may include it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in (f"{name}.cu", *headers):
        h.update(fname.encode())
        with open(os.path.join(CSRC, fname), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _cache_key(path):
    """The compile-cache key of a library: its digest file name (source,
    headers and flags), keyed with the device topology and versions."""
    return _cc.cache_key(os.path.basename(path), 0, ["sm_90a"])


def build(names=SOURCES):
    """Bring every library of ``names`` into ``BUILD_DIR``: from the
    persistent compile cache where it holds a verified copy, else by
    compiling, one ``nvcc`` per source, all started together.  Returns
    ``{name: {"path", "seconds", "ptxas", "cached"}}`` for what was not
    already in ``BUILD_DIR``: ``cached`` is True for a library copied
    from the cache (its ``ptxas`` is None), False for one compiled now
    (``ptxas`` holds the compiler's register and shared-memory report).
    Raises :class:`KernelError` with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cache = _cc.get_default()
    built, procs, nvcc = {}, {}, None
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        t0 = time.perf_counter()
        body = cache.get(_cache_key(out)) if cache.enabled else None
        if body is not None:
            _cc.atomic_write(out, body)
            built[name] = {"path": out, "ptxas": None, "cached": True,
                           "seconds": time.perf_counter() - t0}
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       out, tmp, t0)
    failed = []
    for name, (proc, out, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        if cache.enabled:
            with open(out, "rb") as f:
                cache.put(_cache_key(out), f.read())
        built[name] = {"path": out, "seconds": seconds, "ptxas": log,
                       "cached": False}
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return built


def load(name):
    """The ``ctypes`` handle of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            _LIBS[name] = lib
        return lib


def entry(name, argtypes):
    """The C entry point ``mxtt_<name>`` of ``csrc/<name>.cu`` with its
    ``ctypes`` signature declared (``int`` return: a ``cudaError_t``),
    building the library on first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(load(name), f"mxtt_{name}")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn
