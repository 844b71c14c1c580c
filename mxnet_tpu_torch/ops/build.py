"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  Libraries go to
``build/mxnet_tpu_torch/`` at the repository root, named by a digest of
their sources and flags, so an edited source is rebuilt and a stale
library is never loaded.  Nothing is built at import time: the first
kernel launch builds what it needs, and :func:`build` compiles a list
of sources in parallel (one ``nvcc`` per source, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..base import KernelError

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "library_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mxnet_tpu_torch")
SOURCES = ("ragged_paged_attention", "ragged_paged_verify")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}


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
    digest of the source, the shared header and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (f"{name}.cu", "paged_common.cuh"):
        with open(os.path.join(CSRC, fname), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=SOURCES):
    """Compile every source in ``names`` whose library is missing, one
    ``nvcc`` per source, all started together.  Returns
    ``{name: {"path", "seconds", "ptxas"}}`` for what was compiled
    (``ptxas`` holds the compiler's register and shared-memory report).
    Raises :class:`KernelError` with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       out, tmp, time.perf_counter())
    built, failed = {}, []
    for name, (proc, out, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = {"path": out, "seconds": seconds, "ptxas": log}
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
