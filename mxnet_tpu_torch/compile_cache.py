"""Persistent content-addressed store for what is expensive to rebuild.

The PyTorch port's copy of the framework-free store of
``mxnet_tpu.compile_cache``: the same content key, the same payload
framing (``b"MXAOT1" + sha256(body) + body``), the same atomic writes,
corruption-tolerant loads and LRU bound over ``MXNET_COMPILE_CACHE_DIR``
(``MXNET_COMPILE_CACHE_MAX_BYTES``), so one cache directory serves
either package.

What the port persists differs from the JAX package.  There a payload
is a serialized XLA executable; in the port the per-(family, shape)
programs are CUDA graphs, which cannot outlive their process
(``serving.decode.PagedLMAdapter`` captures them anew in each one).
What is expensive to rebuild across processes is the ``nvcc`` build of
the hand-written kernels, so :mod:`mxnet_tpu_torch.ops.build` keeps
each kernel library here under the digest name it already carries.

Writes are atomic (tmp + rename); a truncated, bit-flipped or foreign
blob is a counted ``corrupt`` miss that is unlinked, never an error;
the directory is bounded by least-recent use (hits refresh recency).
Counters (``hits``/``misses``/``corrupt``/``stores``/``evictions``)
are plain ints, mirrored into ``runtime_metrics`` as
``compile.cache{event=...}`` when the registry is on.
"""
from __future__ import annotations

import hashlib
import logging
import os
import tempfile
import time
from collections.abc import Mapping

from . import engine, faults as _faults, runtime_metrics as _rm
from .base import MXNetError, get_env

__all__ = ["CompileCache", "atomic_write", "cache_key",
           "topology_fingerprint", "get_default", "enable_persistent_cache",
           "load_payload_file", "write_payload_file"]

_LOG = logging.getLogger("mxnet_tpu_torch")

_MAGIC = b"MXAOT1"
_DIGEST_BYTES = 32          # sha256
_SUFFIX = ".bin"


# --------------------------------------------------------------------- keys
def topology_fingerprint():
    """Device and runtime component of every cache key: the devices'
    names and count, and the torch and CUDA versions a payload was
    built against."""
    try:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        kinds = ",".join(sorted({f"cuda:{torch.cuda.get_device_name(i)}"
                                 for i in range(n)})) or "cpu"
        return (f"{kinds}|n={n}|torch={torch.__version__}"
                f"|cuda={torch.version.cuda}")
    except Exception:       # noqa: BLE001 — keyable even without a backend
        return "no-backend"


def cache_key(program_hash, bucket_rows, dtypes, topology=None):
    """Content address of one payload: (program identity, shape bucket,
    input dtypes, device topology + runtime versions) -> hex digest."""
    if topology is None:
        topology = topology_fingerprint()
    parts = "\x1f".join([str(program_hash), f"rows={bucket_rows}",
                         ",".join(str(d) for d in dtypes), topology])
    return hashlib.sha256(parts.encode()).hexdigest()


# ----------------------------------------------------------------- payloads
def _wrap_payload(body: bytes) -> bytes:
    return _MAGIC + hashlib.sha256(body).digest() + body


def _unwrap_payload(raw: bytes):
    """Checksum-verified body, or None for a corrupt/foreign blob."""
    if len(raw) < len(_MAGIC) + _DIGEST_BYTES \
            or not raw.startswith(_MAGIC):
        return None
    digest = raw[len(_MAGIC):len(_MAGIC) + _DIGEST_BYTES]
    body = raw[len(_MAGIC) + _DIGEST_BYTES:]
    if hashlib.sha256(body).digest() != digest:
        return None
    return body


def load_payload_file(path):
    """Read + checksum-verify one payload file.  Returns the body bytes,
    or None when missing/corrupt (never raises on bad data)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    return _unwrap_payload(raw)


def write_payload_file(path, body):
    """Atomically write one payload file, checksum-framed."""
    atomic_write(path, _wrap_payload(body))


def atomic_write(path, data):
    """Write ``data`` to ``path`` atomically (tmp in the same dir +
    ``os.replace``), so a concurrent reader never sees a half-written
    file and a crash never leaves a truncated one under the real name.
    """
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# -------------------------------------------------------------------- cache
class CompileCache:
    """Content-addressed on-disk store of payloads.

    ``cache_dir=None`` (and ``MXNET_COMPILE_CACHE_DIR`` unset) disables
    the cache: every lookup misses cheaply and nothing touches disk.
    All byte-level operations are corruption-tolerant; counters are
    always on (plain ints) and mirrored into ``runtime_metrics`` as
    ``compile.cache{event=...}`` when the registry is enabled.
    """

    def __init__(self, cache_dir=None, max_bytes=None):
        if cache_dir is None:
            cache_dir = get_env("MXNET_COMPILE_CACHE_DIR", typ=str)
        if max_bytes is None:
            max_bytes = get_env("MXNET_COMPILE_CACHE_MAX_BYTES", typ=int)
        self.cache_dir = cache_dir
        self._requested_dir = cache_dir     # identity even when the dir
        self.max_bytes = int(max_bytes) if max_bytes else 0  # is unusable
        self._lock = engine.make_lock("compile_cache.CompileCache._lock")
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        self.stores = 0
        self.evictions = 0
        if self.cache_dir:
            # an uncreatable dir (permission-denied parent, read-only
            # fs) degrades to cache-off with a warning — never an error
            try:
                os.makedirs(self.cache_dir, exist_ok=True)
            except OSError as e:
                _LOG.warning("compile cache: cannot create %s (%s); "
                             "cache disabled", self.cache_dir, e)
                self.cache_dir = None
            else:
                self._sweep_orphan_tmp()

    def _sweep_orphan_tmp(self):
        """Unlink ``*.tmp`` litter left by writers killed between
        mkstemp and the atomic rename.  Age-gated to one minute so a
        concurrent writer's in-flight write is never yanked."""
        try:
            names = os.listdir(self.cache_dir)
        except OSError:
            return
        cutoff = time.time() - 60
        for name in names:
            if not name.endswith(".tmp"):
                continue
            path = os.path.join(self.cache_dir, name)
            try:
                if os.stat(path).st_mtime < cutoff:
                    os.unlink(path)
            except OSError:
                continue

    @property
    def enabled(self):
        return bool(self.cache_dir)

    def _path(self, key):
        return os.path.join(self.cache_dir, key + _SUFFIX)

    def _count(self, event):
        with self._lock:
            setattr(self, _EVENT_ATTR[event],
                    getattr(self, _EVENT_ATTR[event]) + 1)
        if _rm._ENABLED:
            _rm.COMPILE_CACHE.inc(event=event)

    def contains(self, key):
        """Whether an entry exists on disk (no counters, no read)."""
        return self.enabled and os.path.exists(self._path(key))

    def _read_verified(self, key):
        """Checksum-verified body or None.  Counts ``corrupt`` (and
        unlinks the rot) but not hit/miss."""
        if not self.enabled:
            return None
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        try:
            # chaos site: blob rot (corrupt flips a byte -> the checksum
            # below turns it into a counted miss) or a slow/failing
            # cache volume — all modes degrade to a miss
            raw = _faults.inject("compile_cache.load", value=raw)
        except MXNetError:
            return None
        body = _unwrap_payload(raw)
        if body is None:
            self._discard_corrupt(path)
            return None
        try:
            os.utime(path, None)        # LRU recency
        except OSError:
            pass
        return body

    def get(self, key):
        """Checksum-verified payload body for ``key`` or None.  A hit
        refreshes the entry's recency; a corrupt blob is unlinked and
        counted both ``corrupt`` and ``miss`` (misses stay equal to the
        rebuilds that follow)."""
        body = self._read_verified(key)
        self._count("hit" if body is not None else "miss")
        return body

    def put(self, key, body):
        """Atomically persist ``body`` under ``key`` and enforce the LRU
        size bound.  Best-effort: an unwritable cache dir logs and
        returns False instead of failing the build that produced it."""
        if not self.enabled:
            return False
        try:
            write_payload_file(self._path(key), body)
        except OSError as e:
            _LOG.warning("compile cache: cannot write %s: %s",
                         self.cache_dir, e)
            return False
        self._count("store")
        self._enforce_limit()
        return True

    def ingest(self, key, path):
        """Seed the cache from a shipped payload file.  Returns True
        when the entry is (now) present and valid.  An existing entry
        is checksum-verified, not trusted."""
        if not self.enabled:
            return False
        if self.contains(key) \
                and load_payload_file(self._path(key)) is not None:
            return True
        body = load_payload_file(path)
        if body is None:
            return False
        return self.put(key, body)

    def _discard_corrupt(self, path):
        try:
            os.unlink(path)
        except OSError:
            pass
        self._count("corrupt")

    def _entries(self):
        out = []
        try:
            names = os.listdir(self.cache_dir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(_SUFFIX):
                continue
            path = os.path.join(self.cache_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append((path, st.st_mtime, st.st_size))
        return out

    def _enforce_limit(self):
        """Evict least-recently-used entries until the directory fits
        ``max_bytes`` (0 = unbounded).  The newest entry always stays,
        so one oversized payload degrades to a single-entry cache."""
        if not self.enabled or self.max_bytes <= 0:
            return
        entries = sorted(self._entries(), key=lambda e: e[1])
        total = sum(size for _p, _m, size in entries)
        while total > self.max_bytes and len(entries) > 1:
            path, _mtime, size = entries.pop(0)     # oldest first
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            self._count("evict")

    def stats(self):
        """Plain-dict snapshot: dir, entry count, total bytes, and this
        process's counters."""
        entries = self._entries() if self.enabled else []
        with self._lock:
            out = {"enabled": self.enabled, "dir": self.cache_dir,
                   "max_bytes": self.max_bytes,
                   "entries": len(entries),
                   "bytes": sum(s for _p, _m, s in entries),
                   "hits": self.hits, "misses": self.misses,
                   "corrupt": self.corrupt, "stores": self.stores,
                   "evictions": self.evictions}
        return out


_EVENT_ATTR = {"hit": "hits", "miss": "misses", "corrupt": "corrupt",
               "store": "stores", "evict": "evictions"}

# process-default instance, rebuilt whenever the env knobs change
_DEFAULT = None
_DEFAULT_LOCK = engine.make_lock("compile_cache._DEFAULT_LOCK")


def get_default():
    """The env-configured process-wide cache (``MXNET_COMPILE_CACHE_DIR``
    / ``MXNET_COMPILE_CACHE_MAX_BYTES``); disabled when the dir is
    unset."""
    global _DEFAULT
    cache_dir = get_env("MXNET_COMPILE_CACHE_DIR", typ=str)
    max_bytes = get_env("MXNET_COMPILE_CACHE_MAX_BYTES", typ=int)
    with _DEFAULT_LOCK:
        if _DEFAULT is None or _DEFAULT._requested_dir != cache_dir \
                or _DEFAULT.max_bytes != (max_bytes or 0):
            _DEFAULT = CompileCache(cache_dir, max_bytes)
        return _DEFAULT


class _DefaultCounts(Mapping):
    """``{"hits": n, "misses": n}`` of the default store, read from
    :func:`get_default` on every access (so it follows a rebuilt store)."""

    _KEYS = ("hits", "misses")

    def __getitem__(self, key):
        if key not in self._KEYS:
            raise KeyError(key)
        return getattr(get_default(), key)

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)

    def __repr__(self):
        return repr(dict(self))


def enable_persistent_cache(cache_dir):
    """Point the process's default store (:func:`get_default`, the one
    :func:`mxnet_tpu_torch.ops.build.build` uses) at ``cache_dir`` by
    setting ``MXNET_COMPILE_CACHE_DIR``, and return a live read-only
    ``{"hits": n, "misses": n}`` mapping of the default store's lookups.

    The counterpart of the JAX package's ``enable_jax_persistent_cache``.
    There the training step is a ``jax.jit`` program that persists; the
    port's step is a CUDA graph, which dies with its process.  What
    persists is the kernel libraries: a restarted trainer captures its
    graph again on its first step but rebuilds no kernel (``build()``
    copies each library from the cache, a hit, instead of running
    ``nvcc``)."""
    os.makedirs(cache_dir, exist_ok=True)
    os.environ["MXNET_COMPILE_CACHE_DIR"] = str(cache_dir)
    get_default()
    return _DefaultCounts()
