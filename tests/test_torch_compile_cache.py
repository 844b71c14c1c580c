"""PyTorch port, persistent compile cache: twins of the store tests of
tests/test_compile_cache.py (keys, atomic corruption-tolerant storage,
LRU bound, the env-configured default) against
``mxnet_tpu_torch.compile_cache``; the payload framing and the on-disk
entries are the JAX package's byte for byte, so one cache directory
serves both; and ``ops.build`` takes a kernel library from the cache
instead of running ``nvcc`` (a stub compiler here: the CPU has none).
"""
import os
import sys

import pytest
import torch

from mxnet_tpu import compile_cache as jcc
from mxnet_tpu_torch import compile_cache as cc, runtime_metrics as rm
from mxnet_tpu_torch.ops import build


@pytest.fixture(autouse=True)
def _metrics_on():
    rm.reset()
    rm.enable()
    yield
    rm.disable()
    rm.reset()


@pytest.fixture()
def cache(tmp_path):
    return cc.CompileCache(str(tmp_path / "cache"), max_bytes=0)


class TestCacheKey:
    def test_deterministic(self):
        a = cc.cache_key("abc", 4, ["float32"], topology="t")
        b = cc.cache_key("abc", 4, ["float32"], topology="t")
        assert a == b and len(a) == 64

    def test_sensitive_to_every_component(self):
        base = cc.cache_key("abc", 4, ["float32"], topology="t")
        assert cc.cache_key("abd", 4, ["float32"], topology="t") != base
        assert cc.cache_key("abc", 8, ["float32"], topology="t") != base
        assert cc.cache_key("abc", 4, ["float16"], topology="t") != base
        assert cc.cache_key("abc", 4, ["float32"], topology="u") != base

    def test_default_topology_carries_versions(self):
        fp = cc.topology_fingerprint()
        assert torch.__version__ in fp
        assert f"cuda={torch.version.cuda}" in fp
        # the default key uses the live topology
        assert cc.cache_key("x", 1, []) == cc.cache_key(
            "x", 1, [], topology=fp)


class TestBytesTier:
    def test_put_get_roundtrip_and_counters(self, cache):
        key = "k" * 64
        assert cache.get(key) is None
        assert cache.misses == 1
        assert cache.put(key, b"payload")
        assert cache.get(key) == b"payload"
        assert cache.hits == 1 and cache.stores == 1
        assert rm.COMPILE_CACHE.value(event="hit") == 1
        assert rm.COMPILE_CACHE.value(event="miss") == 1
        assert rm.COMPILE_CACHE.value(event="store") == 1

    def test_atomic_write_leaves_no_temp_files(self, cache):
        for i in range(4):
            cache.put(f"{i:064d}", b"x" * 100)
        names = os.listdir(cache.cache_dir)
        assert len(names) == 4
        assert all(n.endswith(".bin") for n in names)

    def test_uncreatable_dir_degrades_to_cache_off(self, tmp_path,
                                                   monkeypatch):
        blocker = tmp_path / "file"             # a FILE as parent dir
        blocker.write_text("x")
        bad = str(blocker / "cache")
        c = cc.CompileCache(bad)
        assert not c.enabled
        assert c.get("k" * 64) is None          # inert, no error
        monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", bad)
        d1 = cc.get_default()
        assert not d1.enabled
        assert cc.get_default() is d1           # no rebuild-warn loop

    def test_disabled_cache_is_inert(self, monkeypatch):
        monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
        c = cc.CompileCache(None)
        assert not c.enabled
        assert not c.put("k" * 64, b"data")
        assert c.get("k" * 64) is None
        assert c.stats()["entries"] == 0

    def test_bitflip_is_a_counted_corrupt_miss(self, cache):
        key = "a" * 64
        cache.put(key, b"hello world payload")
        path = cache._path(key)
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(raw))
        assert cache.get(key) is None           # never an error
        assert cache.corrupt == 1
        assert not os.path.exists(path)         # rot is cleared
        assert rm.COMPILE_CACHE.value(event="corrupt") == 1
        cache.put(key, b"fresh")
        assert cache.get(key) == b"fresh"

    def test_truncated_and_foreign_blobs_are_corrupt(self, cache):
        for i, raw in enumerate([b"", b"MXAOT1short", b"not-our-format"]):
            key = f"{i:064d}"
            with open(cache._path(key), "wb") as f:
                f.write(raw)
            assert cache.get(key) is None
        assert cache.corrupt == 3

    def test_lru_eviction_oldest_first(self, tmp_path):
        c = cc.CompileCache(str(tmp_path / "c"), max_bytes=3000)
        body = b"x" * 900                       # ~938B per entry on disk
        now = 1_700_000_000
        for i in range(3):
            c.put(f"{i:064d}", body)
            os.utime(c._path(f"{i:064d}"), (now + i, now + i))
        # a hit refreshes entry 0's recency, so entry 1 is now oldest
        os.utime(c._path("0" * 64), (now + 10, now + 10))
        c.put(f"{3:064d}", body)                # overflows the bound
        assert c.evictions >= 1
        assert c.get(f"{1:064d}") is None       # oldest evicted
        assert c.get("0" * 64) == body          # refreshed one survives

    def test_single_oversized_entry_survives(self, tmp_path):
        c = cc.CompileCache(str(tmp_path / "c"), max_bytes=10)
        c.put("f" * 64, b"y" * 1000)
        assert c.get("f" * 64) is not None      # never evicts itself

    def test_ingest_seeds_from_shipped_file(self, cache, tmp_path):
        shipped = tmp_path / "shipped.bin"
        cc.write_payload_file(str(shipped), b"exported-executable")
        key = "e" * 64
        assert cache.ingest(key, str(shipped))
        assert cache.get(key) == b"exported-executable"
        with open(shipped, "wb") as f:
            f.write(b"garbage")
        assert not cache.ingest("d" * 64, str(shipped))

    def test_orphan_tmp_swept_at_construction(self, cache):
        old = os.path.join(cache.cache_dir, "dead1234.tmp")
        fresh = os.path.join(cache.cache_dir, "live5678.tmp")
        for p in (old, fresh):
            with open(p, "wb") as f:
                f.write(b"partial write")
        os.utime(old, (1, 1))                   # ancient
        cc.CompileCache(cache.cache_dir, max_bytes=0)
        assert not os.path.exists(old)
        assert os.path.exists(fresh)

    def test_stats_shape(self, cache):
        cache.put("a" * 64, b"12345")
        st = cache.stats()
        assert st["enabled"] and st["entries"] == 1
        assert st["bytes"] > 5                  # header + body
        assert st["dir"] == cache.cache_dir


class TestDefaultInstance:
    def test_env_driven_rebuild(self, tmp_path, monkeypatch):
        monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
        assert not cc.get_default().enabled
        monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR",
                           str(tmp_path / "d1"))
        c1 = cc.get_default()
        assert c1.enabled and c1.cache_dir == str(tmp_path / "d1")
        assert cc.get_default() is c1           # stable while env stable
        monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR",
                           str(tmp_path / "d2"))
        assert cc.get_default() is not c1


class TestSameStoreAsTheJaxPackage:
    @pytest.mark.parametrize("body", [b"", b"x", bytes(range(256)) * 9])
    def test_wrap_payload_is_byte_identical(self, body):
        assert cc._wrap_payload(body) == jcc._wrap_payload(body)
        assert cc._unwrap_payload(jcc._wrap_payload(body)) == body

    def test_jax_put_reads_back_through_the_port(self, tmp_path):
        d = str(tmp_path / "shared")
        jcc.CompileCache(d, max_bytes=0).put("b" * 64, b"from-jax")
        assert cc.CompileCache(d, max_bytes=0).get("b" * 64) == b"from-jax"

    def test_port_put_reads_back_through_jax(self, tmp_path):
        d = str(tmp_path / "shared")
        cc.CompileCache(d, max_bytes=0).put("c" * 64, b"from-port")
        assert jcc.CompileCache(d, max_bytes=0).get("c" * 64) \
            == b"from-port"


def _stub_nvcc(tmp_path):
    """A stand-in ``nvcc``: writes a fake library to its ``-o`` path,
    prints a ptxas-like line and counts its runs in a file."""
    calls = tmp_path / "nvcc_calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "out = args[args.index('-o') + 1]\n"
        "open(out, 'wb').write(b'stub-library:' + args[-1].encode())\n"
        f"open({str(calls)!r}, 'a').write('x')\n"
        "print('ptxas info    : Used 1 registers')\n")
    nvcc.chmod(0o755)
    return str(nvcc), lambda: len(calls.read_text()) if calls.exists() \
        else 0


def test_build_takes_libraries_from_the_cache(tmp_path, monkeypatch):
    """One nvcc run, then the library comes from the cache; a bit-flipped
    entry is a corrupt miss and the library is compiled again; with the
    variable unset nothing is read or stored."""
    nvcc, calls = _stub_nvcc(tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    name = "ragged_paged_verify"
    lib = build.library_path(name)

    first = build.build([name])[name]
    assert calls() == 1 and first["cached"] is False
    assert "Used 1 registers" in first["ptxas"]
    body = open(lib, "rb").read()
    cache = cc.get_default()
    assert cache.stores == 1
    assert build.build([name]) == {}            # already in BUILD_DIR

    os.unlink(lib)
    second = build.build([name])[name]
    assert calls() == 1, "nvcc ran on a cache hit"
    assert second["cached"] is True and second["ptxas"] is None
    assert open(lib, "rb").read() == body and cache.hits == 1

    path = cache._path(build._cache_key(lib))
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(raw))
    os.unlink(lib)
    third = build.build([name])[name]
    assert calls() == 2 and third["cached"] is False
    assert cache.corrupt == 1 and cache.stores == 2
    assert cache.get(build._cache_key(lib)) == body

    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR")
    os.unlink(lib)
    assert build.build([name])[name]["cached"] is False
    assert calls() == 3 and cache.stores == 2
    assert not [n for n in os.listdir(str(tmp_path / "build"))
                if n.endswith(".tmp")]
