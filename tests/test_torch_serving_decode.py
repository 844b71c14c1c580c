"""PyTorch port, decode engine: twins of the JAX package's scheduler
tests (tests/test_serving_decode.py) on the port's ``DecodeEngine``,
``PageAllocator`` and ``PrefixCache``, with copies of the same numpy
fake models — plus end-to-end runs of the port's ``PagedLMAdapter`` on
the CPU against the JAX package's full forward on the same weights.
"""
import threading

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models import transformer_blocks as jtb
from mxnet_tpu_torch import runtime_metrics as rm, serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.transformer_blocks import TransformerDecoderLM
from mxnet_tpu_torch.serving.batcher import bucket_set
from mxnet_tpu_torch.serving.decode import DecodeEngine, PagedLMAdapter
from mxnet_tpu_torch.serving.kv_cache import PageAllocator, PageGeometry


@pytest.fixture(autouse=True)
def _metrics_on():
    rm.reset()
    rm.enable()
    yield
    rm.disable()
    rm.reset()


def _cfg(**kw):
    kw.setdefault("decode_page_size", 4)
    kw.setdefault("decode_pool_pages", 9)      # 8 usable
    kw.setdefault("decode_max_batch", 2)
    kw.setdefault("decode_max_new_tokens", 4)
    return serving.ServingConfig(**kw)


class FakeModel:
    """Decode-model protocol in plain numpy: next token = (last + 1)
    mod vocab; prefill proposes the prompt's last token.  Asserts the
    engine's inactive-slot contract on every step."""

    vocab_size = 16
    max_context = 32

    def __init__(self, eos_id=None):
        self.prefills = 0
        self.steps = 0
        self.step_batches = []          # active slot count per step
        if eos_id is not None:
            self.eos_id = eos_id

    def prefill(self, tokens, length, block_table):
        self.prefills += 1
        assert tokens.ndim == 2 and tokens.shape[0] == 1
        assert tokens.shape[1] >= int(length)
        logits = np.zeros((self.vocab_size,), np.float32)
        logits[int(tokens[0, int(length) - 1]) % self.vocab_size] = 1.0
        return logits

    def decode_step(self, tokens, positions, block_tables):
        self.steps += 1
        active = positions > 0
        # inactive slots carry zeros and an all-null block table
        assert np.all(tokens[~active] == 0)
        assert np.all(block_tables[~active] == 0)
        self.step_batches.append(int(active.sum()))
        logits = np.zeros((tokens.shape[0], self.vocab_size), np.float32)
        logits[np.arange(tokens.shape[0]),
               (tokens + 1) % self.vocab_size] = 1.0
        return logits


class ChainModel:
    """Self-consistent decode-model protocol in plain numpy: next
    token = (last + 1) mod vocab EVERYWHERE — prefill, decode_step,
    and the multi-token verify window agree, so the prefix-cache and
    speculative paths must reproduce the plain path byte-for-byte."""

    vocab_size = 32
    max_context = 64

    def __init__(self):
        self.prefills = 0
        self.steps = 0
        self.verifies = 0
        self.copies = []

    def _row(self, t):
        row = np.zeros((self.vocab_size,), np.float32)
        row[(int(t) + 1) % self.vocab_size] = 1.0
        return row

    def prefill(self, tokens, length, block_table):
        self.prefills += 1
        return self._row(tokens[0, int(length) - 1])

    def decode_step(self, tokens, positions, block_tables):
        self.steps += 1
        return np.stack([self._row(t) for t in tokens])

    def verify(self, tokens, start, length, block_table):
        self.verifies += 1
        return np.stack([self._row(t) for t in tokens[0]])

    def copy_page(self, src, dst):
        self.copies.append((int(src), int(dst)))


class SkewDraft(ChainModel):
    """Draft that proposes (t + skew) — skew=1 agrees with ChainModel
    (full acceptance), skew=2 never agrees (zero acceptance)."""

    def __init__(self, skew=1):
        super().__init__()
        self.skew = skew

    def _row(self, t):
        row = np.zeros((self.vocab_size,), np.float32)
        row[(int(t) + self.skew) % self.vocab_size] = 1.0
        return row


def _drive(eng, seqs, limit=64):
    """Step until every sequence finished (bounded)."""
    n = 0
    while not all(s.event.is_set() for s in seqs):
        eng.step()
        n += 1
        assert n < limit, "scheduler did not converge"
    return n


def _engine(model=None, draft=None, **cfg_kw):
    eng = DecodeEngine(model or FakeModel(), _cfg(**cfg_kw),
                       model_name="fake", draft=draft)
    eng._started = True                 # manual stepping, no loop thread
    return eng


# --------------------------------------------------------------- allocator
class TestPageAllocator:
    def _geom(self, **kw):
        kw.setdefault("page_size", 4)
        kw.setdefault("pool_pages", 9)
        kw.setdefault("max_context", 32)
        return PageGeometry(num_layers=1, num_heads=1, head_dim=1, **kw)

    def test_alloc_release_roundtrip(self):
        a = PageAllocator(self._geom())
        assert a.allocate("s1", 3)
        assert a.used_pages == 3 and a.free_pages == 5
        assert 0 not in a.pages_of("s1")            # null page reserved
        assert a.release("s1") == 3
        assert a.used_pages == 0
        a.check_leaks()

    def test_all_or_nothing(self):
        a = PageAllocator(self._geom(max_context=64))   # 16-slot tables
        assert not a.allocate("big", 9)             # > 8 usable
        assert a.used_pages == 0                    # nothing stranded
        assert a.allocate("s1", 8)
        assert not a.allocate("s2", 1)
        a.check_leaks()

    def test_double_release_raises(self):
        a = PageAllocator(self._geom())
        a.allocate("s1", 2)
        a.release("s1")
        with pytest.raises(MXNetError, match="unknown sequence"):
            a.release("s1")

    def test_corrupted_state_detected(self):
        a = PageAllocator(self._geom())
        a.allocate("s1", 2)
        a._free.append(a.pages_of("s1")[0])         # simulate corruption
        with pytest.raises(MXNetError, match="already free"):
            a.release("s1")

    def test_block_table_width_enforced(self):
        g = self._geom(max_context=8)               # 2 slots of 4
        a = PageAllocator(PageGeometry(4, 9, 8, 1, 1, 1))
        assert g.pages_per_seq == 2
        with pytest.raises(MXNetError, match="exceed the block table"):
            a.allocate("s1", 3)

    def test_block_table_null_fill_and_reuse_after_eviction(self):
        a = PageAllocator(self._geom())
        a.allocate("s1", 2)
        first = a.pages_of("s1")
        table = a.block_table("s1")
        assert list(table[:2]) == first and np.all(table[2:] == 0)
        a.release("s1")
        a.allocate("s2", 2)
        # LIFO free list: the evicted pages back the new sequence
        assert set(a.pages_of("s2")) == set(first)
        a.check_leaks()

    def test_random_arrival_finish_orders_never_leak(self):
        rng = np.random.RandomState(0)
        a = PageAllocator(self._geom(pool_pages=17, max_context=64))
        live, next_id = {}, 0
        for _ in range(300):
            if live and rng.rand() < 0.45:
                sid = rng.choice(sorted(live))
                a.release(sid)
                del live[sid]
            else:
                n = int(rng.randint(1, 5))
                sid = next_id = next_id + 1
                if a.allocate(sid, n):
                    live[sid] = n
            a.check_leaks()
            assert a.used_pages == sum(live.values())
        for sid in sorted(live):
            a.release(sid)
        a.check_leaks()
        assert a.free_pages == a.geometry.usable_pages

    def test_geometry_validation(self):
        with pytest.raises(MXNetError, match="null page"):
            PageGeometry(4, 1, 32, 1, 1, 1)
        with pytest.raises(MXNetError, match="page_size"):
            PageGeometry(0, 8, 32, 1, 1, 1)
        g = self._geom()
        assert g.pages_for(0) == 0
        assert g.pages_for(1) == 1
        assert g.pages_for(4) == 1
        assert g.pages_for(5) == 2


# ----------------------------------------------------- refcounted sharing
class TestRefcountedAllocator:
    def _geom(self, **kw):
        kw.setdefault("page_size", 4)
        kw.setdefault("pool_pages", 17)
        kw.setdefault("max_context", 64)
        return PageGeometry(num_layers=1, num_heads=1, head_dim=1, **kw)

    def test_share_refcounts_and_release_order(self):
        a = PageAllocator(self._geom())
        a.allocate("s1", 3)
        pages = a.pages_of("s1")
        a.share("s2", pages[:2])
        assert a.refcount(pages[0]) == 2 and a.refcount(pages[2]) == 1
        assert a.shared_pages == 2
        a.check_leaks()
        a.release("s1")                 # shared pages survive
        assert a.refcount(pages[0]) == 1
        assert a.used_pages == 2        # page[2] freed
        a.check_leaks()
        a.release("s2")
        assert a.used_pages == 0
        a.check_leaks()

    def test_share_guards(self):
        a = PageAllocator(self._geom())
        a.allocate("s1", 1)
        page = a.pages_of("s1")[0]
        with pytest.raises(MXNetError, match="free or out of range"):
            a.share("s2", [page + 1])       # never allocated
        with pytest.raises(MXNetError, match="already in this"):
            a.share("s1", [page])           # self re-alias
        a.release("s1")
        with pytest.raises(MXNetError, match="free or out of range"):
            a.share("s2", [page])           # freed page cannot alias
        a.check_leaks()

    def test_cache_retain_outlives_writer_and_double_free_guards(self):
        a = PageAllocator(self._geom())
        a.allocate("s1", 2)
        p0, p1 = a.pages_of("s1")
        a.retain_cached(p0)
        a.release("s1")
        assert a.cached_pages == 1 and a.used_pages == 1
        assert a.cache_only(p0)
        a.check_leaks()
        with pytest.raises(MXNetError, match="not cache-held"):
            a.release_cached(p1)
        a.release_cached(p0)
        assert a.used_pages == 0
        with pytest.raises(MXNetError, match="not cache-held"):
            a.release_cached(p0)            # double eviction
        a.check_leaks()

    def test_admit_all_or_nothing_with_shared(self):
        a = PageAllocator(self._geom(pool_pages=5))     # 4 usable
        a.allocate("w", 3)
        shared = a.pages_of("w")[:2]
        for p in shared:
            a.retain_cached(p)
        a.release("w")                  # 2 cached + 1 freed -> 2 free
        assert not a.admit("s", shared, 3)      # fresh 3 > 2 free
        assert a.pages_of("s") == []            # nothing stranded
        a.check_leaks()
        assert a.admit("s", shared, 2)
        assert a.pages_of("s")[:2] == shared
        assert a.refcount(shared[0]) == 2
        a.release("s")
        a.check_leaks()

    def test_random_shared_orders_never_leak(self):
        """The ISSUE-12 satellite: check_leaks stays EXACT across ~300
        random admit/finish/cancel/quarantine orders with shared pages
        and cache retains in the mix."""
        rng = np.random.RandomState(7)
        a = PageAllocator(self._geom(pool_pages=33))
        live, cached, next_id = {}, [], 0
        for _ in range(300):
            r = rng.rand()
            if live and r < 0.30:       # finish/cancel/quarantine:
                sid = rng.choice(sorted(live))      # all are release()
                a.release(sid)
                del live[sid]
            elif cached and r < 0.40:   # cache eviction
                idx = rng.randint(len(cached))
                a.release_cached(cached.pop(idx))
            elif live and cached and r < 0.55:      # shared admission
                sid = next_id = next_id + 1
                share = [p for p in cached if a.refcount(p)][:2]
                share = [p for p in share
                         if all(p not in a.pages_of(s) or s == sid
                                for s in live)]
                fresh = int(rng.randint(0, 3))
                if a.admit(sid, share, fresh):
                    live[sid] = len(share) + fresh
            else:                       # plain admission (+ retain)
                sid = next_id = next_id + 1
                n = int(rng.randint(1, 5))
                if a.allocate(sid, n):
                    live[sid] = n
                    if rng.rand() < 0.5:
                        page = a.pages_of(sid)[0]
                        if page not in cached:
                            a.retain_cached(page)
                            cached.append(page)
            a.check_leaks()
        for sid in sorted(live):
            a.release(sid)
        for page in cached:
            a.release_cached(page)
        a.check_leaks()
        assert a.used_pages == 0


# ------------------------------------------------------------- radix tree
class TestPrefixCacheTree:
    def _cache(self, pool_pages=33, max_pages=None, page_size=4):
        geom = PageGeometry(page_size, pool_pages, 64, 1, 1, 1)
        alloc = PageAllocator(geom)
        from mxnet_tpu_torch.serving.kv_cache import PrefixCache
        return alloc, PrefixCache(alloc, max_pages=max_pages)

    def _seed(self, alloc, cache, sid, prompt):
        """Simulate one admission+prefill+insert for ``prompt``."""
        n = alloc.geometry.pages_for(len(prompt))
        assert alloc.allocate(sid, n)
        cache.insert(np.asarray(prompt, np.int32), alloc.pages_of(sid))
        return alloc.pages_of(sid)

    def test_insert_lookup_roundtrip_and_partial(self):
        alloc, cache = self._cache()
        pages = self._seed(alloc, cache, "s1", list(range(1, 13)))
        # 12 tokens = 3 full pages cached
        assert cache.pages == 3
        hit = cache.lookup(np.arange(1, 13, dtype=np.int32))
        assert hit == pages[:3]
        # longest-prefix semantics: shared 2 pages, then divergence
        hit = cache.lookup(np.asarray(list(range(1, 9)) + [99] * 4,
                                      np.int32))
        assert hit == pages[:2]
        # sub-page prompts and mismatches miss
        assert cache.lookup(np.asarray([1, 2], np.int32)) == []
        assert cache.lookup(np.asarray([9, 9, 9, 9], np.int32)) == []
        alloc.check_leaks()

    def test_branching_prefixes_share_the_trunk(self):
        alloc, cache = self._cache()
        a = self._seed(alloc, cache, "a", [1, 2, 3, 4, 5, 6, 7, 8])
        b_pages = [1, 2, 3, 4, 9, 9, 9, 9]
        n = alloc.geometry.pages_for(len(b_pages))
        alloc.allocate("b", n)
        cache.insert(np.asarray(b_pages, np.int32), alloc.pages_of("b"))
        # trunk chunk [1,2,3,4] cached ONCE (first writer wins)
        assert cache.pages == 3
        assert cache.lookup(np.asarray(b_pages, np.int32)) \
            == [a[0], alloc.pages_of("b")[1]]
        alloc.check_leaks()

    def test_refcount_aware_lru_eviction(self):
        alloc, cache = self._cache()
        live = self._seed(alloc, cache, "live", [1, 2, 3, 4])
        dead = self._seed(alloc, cache, "dead", [5, 6, 7, 8])
        alloc.release("dead")           # its page is now cache-only
        cache.lookup(np.asarray([5, 6, 7, 8], np.int32))  # touch: MRU
        # the LRU candidate [1,2,3,4] is pinned by the live sequence,
        # so eviction must take the MRU-but-evictable page instead
        assert cache.evict(1) == 1
        assert cache.lookup(np.asarray([5, 6, 7, 8], np.int32)) == []
        assert cache.lookup(np.asarray([1, 2, 3, 4], np.int32)) == live
        alloc.check_leaks()
        alloc.release("live")
        assert cache.evict(1) == 1      # now free to go
        assert alloc.used_pages == 0
        alloc.check_leaks()

    def test_leaf_first_eviction_keeps_inner_prefixes_sound(self):
        alloc, cache = self._cache()
        self._seed(alloc, cache, "s", list(range(1, 13)))
        alloc.release("s")
        assert cache.pages == 3
        # evicting one page must take the DEEPEST chunk: the remaining
        # tree still answers its prefix correctly
        assert cache.evict(1) == 1
        assert len(cache.lookup(np.arange(1, 13, dtype=np.int32))) == 2
        cache.clear()
        assert alloc.used_pages == 0
        alloc.check_leaks()

    def test_max_pages_cap(self):
        alloc, cache = self._cache(max_pages=2)
        self._seed(alloc, cache, "a", [1, 2, 3, 4, 5, 6, 7, 8])
        assert cache.pages == 2
        alloc.release("a")
        self._seed(alloc, cache, "b", [9, 9, 9, 9])
        # cap held: inserting b evicted an LRU page first
        assert cache.pages == 2
        alloc.check_leaks()

    def test_random_tree_ops_property(self):
        """Radix property test: lookups always equal the longest
        cached chunk-prefix, never stale pages, never leaks."""
        rng = np.random.RandomState(3)
        alloc, cache = self._cache(pool_pages=65)
        model = {}                      # tuple(chunks) path -> page
        sid = 0
        for _ in range(120):
            prompt = list(rng.randint(0, 3, size=rng.randint(4, 17)))
            chunks = [tuple(prompt[i * 4:(i + 1) * 4])
                      for i in range(len(prompt) // 4)]
            expect = []
            for i in range(len(chunks)):
                page = model.get(tuple(chunks[:i + 1]))
                if page is None:
                    break
                expect.append(page)
            got = cache.lookup(np.asarray(prompt, np.int32))
            assert got == expect, (prompt, got, expect)
            if rng.rand() < 0.6:
                sid += 1
                n = alloc.geometry.pages_for(len(prompt))
                if alloc.allocate(sid, n):
                    pages = alloc.pages_of(sid)
                    cache.insert(np.asarray(prompt, np.int32), pages)
                    for i in range(len(chunks)):
                        model.setdefault(tuple(chunks[:i + 1]),
                                         pages[i])
                    alloc.release(sid)
            alloc.check_leaks()
        cache.clear()
        alloc.check_leaks()
        assert alloc.used_pages == 0


# --------------------------------------------------------------- scheduler
class TestSchedulerInvariants:
    def test_greedy_chain_and_prefill_token(self):
        eng = _engine()
        s = eng.submit([1, 2, 3], max_new_tokens=3)
        _drive(eng, [s])
        # prefill proposes last prompt token, then +1 per decode step
        assert s.tokens == [3, 4, 5]
        assert s.finish_reason == "length"
        eng.allocator.check_leaks()

    def test_admit_and_evict_every_step(self):
        """Slot freed by an eviction is refilled on the NEXT step, not
        after the whole batch drains (token-level, not request-level).
        A step is admit -> prefill -> one decode step, so a 2-token
        request finishes WITHIN its admission step."""
        eng = _engine()                 # 2 slots
        long = eng.submit([1], max_new_tokens=6)
        short = eng.submit([2], max_new_tokens=2)
        third = eng.submit([3], max_new_tokens=4)
        eng.step()                      # admits long+short; third waits
        # short got prefill token + one decode token = done this step
        assert short.event.is_set()
        st = eng.stats()
        assert st["running"] == 1 and st["waiting"] == 1
        eng.step()                      # third admitted into freed slot
        st = eng.stats()
        assert st["running"] == 2 and st["waiting"] == 0
        assert not long.event.is_set()
        _drive(eng, [long, short, third])
        eng.allocator.check_leaks()
        assert eng.allocator.used_pages == 0

    def test_short_request_admitted_mid_flight_finishes_first(self):
        """The ISSUE-7 interleave criterion at engine level."""
        eng = _engine()
        long = eng.submit([1], max_new_tokens=8,
                          on_token=lambda t: None)
        eng.step()                      # long is mid-flight
        short = eng.submit([2], max_new_tokens=2)
        _drive(eng, [short])
        assert short.event.is_set() and not long.event.is_set()
        _drive(eng, [long])
        eng.allocator.check_leaks()

    def test_admission_gates_on_page_reservation(self):
        # 8 usable pages; each request needs ceil((1+15)/4) = 4 pages
        model = FakeModel()
        model.max_context = 16
        eng = _engine(model, decode_max_batch=4, decode_pool_pages=9)
        a = eng.submit([1], max_new_tokens=15)
        b = eng.submit([2], max_new_tokens=15)
        c = eng.submit([3], max_new_tokens=15)
        eng.step()
        st = eng.stats()
        # only two reservations fit even though a slot is free
        assert st["running"] == 2 and st["waiting"] == 1
        assert st["free_pages"] == 0
        _drive(eng, [a, b, c], limit=64)
        eng.allocator.check_leaks()
        assert eng.allocator.free_pages == 8

    def test_eos_evicts(self):
        eng = _engine()
        # chain 5 -> 6 -> 7(eos)
        s = eng.submit([5], max_new_tokens=8, eos_id=7)
        _drive(eng, [s])
        assert s.tokens[-1] == 7 and s.finish_reason == "eos"
        assert len(s.tokens) == 3
        eng.allocator.check_leaks()

    def test_streaming_callbacks_in_order(self):
        eng = _engine()
        got = []
        s = eng.submit([1, 2], max_new_tokens=3, on_token=got.append)
        _drive(eng, [s])
        assert got == s.tokens == [2, 3, 4]

    def test_callback_exception_does_not_kill_sequence(self):
        eng = _engine()

        def boom(tok):
            raise RuntimeError("client went away")

        s = eng.submit([1], max_new_tokens=2, on_token=boom)
        _drive(eng, [s])
        assert s.error is None and len(s.tokens) == 2

    def test_submit_validation(self):
        eng = _engine()
        with pytest.raises(MXNetError, match=">= 1 token"):
            eng.submit([], max_new_tokens=2)
        with pytest.raises(MXNetError, match="max_context"):
            eng.submit([1] * 30, max_new_tokens=10)
        with pytest.raises(MXNetError, match="max_new_tokens"):
            eng.submit([1], max_new_tokens=0)

    def test_waiting_queue_sheds_past_queue_depth(self):
        eng = _engine(queue_depth=2)
        eng.submit([1], max_new_tokens=4)
        eng.submit([2], max_new_tokens=4)
        with pytest.raises(serving.ServerOverloadedError,
                           match="queue_depth"):
            eng.submit([3], max_new_tokens=4)
        assert eng.stats()["shed"] == 1

    def test_cancelled_waiting_pruned_even_with_full_batch(self):
        """A timed-out waiting request is dropped on the next step even
        when no slot frees — it must not occupy bounded queue space."""
        eng = _engine(decode_max_batch=1)
        running = eng.submit([1], max_new_tokens=8)
        eng.step()                      # occupies the only slot
        waiting = eng.submit([2], max_new_tokens=8)
        with pytest.raises(MXNetError):
            eng.result(waiting, timeout=0.01)   # cancels it
        before = rm.SERVING_DECODE_EVICTIONS.value(model="fake")
        eng.step()                      # batch still full, yet pruned
        assert waiting.event.is_set()
        assert waiting.finish_reason == "cancelled"
        assert eng.stats()["waiting"] == 0
        # never admitted -> not an eviction (pages were never held)
        assert rm.SERVING_DECODE_EVICTIONS.value(model="fake") == before
        _drive(eng, [running])
        eng.allocator.check_leaks()

    def test_result_timeout_cancels_and_reclaims(self):
        eng = _engine()
        s = eng.submit([1], max_new_tokens=8)
        eng.step()
        assert eng.allocator.used_pages > 0
        with pytest.raises(MXNetError, match="cancelled"):
            eng.result(s, timeout=0.01)
        eng.step()                      # eviction happens on the step
        assert s.finish_reason == "cancelled"
        eng.allocator.check_leaks()
        assert eng.allocator.used_pages == 0

    def test_metrics_published(self):
        eng = _engine()
        s = eng.submit([1, 2], max_new_tokens=3)
        _drive(eng, [s])
        assert rm.SERVING_DECODE_TOKENS.value(model="fake") == 3
        assert rm.SERVING_DECODE_EVICTIONS.value(model="fake") == 1
        assert rm.SERVING_DECODE_TTFT_SECONDS.count(model="fake") == 1
        assert rm.SERVING_DECODE_TOKEN_SECONDS.count(model="fake") == 2
        assert "serving_decode_steps" in rm.dump_prometheus()

    def test_threaded_engine_lifecycle(self):
        """autostart path: background loop, concurrent submitters,
        clean stop failing a straggler."""
        model = FakeModel()
        eng = DecodeEngine(model, _cfg(decode_max_batch=2),
                           model_name="fake", autostart=True)
        try:
            outs = {}

            def gen(i):
                outs[i] = eng.generate([i + 1], max_new_tokens=2,
                                       timeout=60)

            ts = [threading.Thread(target=gen, args=(i,), daemon=True)
                  for i in range(5)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
            assert len(outs) == 5
            for i, toks in outs.items():
                assert toks.tolist() == [(i + 1) % 16, (i + 2) % 16]
            eng.allocator.check_leaks()
            assert eng.allocator.used_pages == 0
        finally:
            assert eng.stop(timeout=30)
        with pytest.raises(MXNetError, match="not accepting"):
            eng.submit([1])

    def test_stop_fails_outstanding(self):
        eng = DecodeEngine(FakeModel(), _cfg(), model_name="fake",
                           autostart=True)
        # saturate so one request stays waiting, then stop immediately
        seqs = [eng.submit([1], max_new_tokens=4) for _ in range(3)]
        assert eng.stop(timeout=30)
        for s in seqs:
            assert s.event.is_set()
            # each either finished legitimately or was failed by stop
            assert s.finish_reason in ("length", "stopped")
        eng.allocator.check_leaks()


# ----------------------------------------------------- prefix-cache engine
class TestPrefixCacheEngine:
    def _chain(self, prompt, n):
        out, t = [], prompt[-1]
        for _ in range(n):
            t = (t + 1) % ChainModel.vocab_size
            out.append(t)
        return out

    def test_full_hit_skips_prefill_and_cow_copies(self):
        model = ChainModel()
        eng = _engine(model, prefix_cache=True, decode_pool_pages=33)
        prompt = list(range(1, 9))              # 2 full pages
        a = eng.submit(prompt, max_new_tokens=3)
        _drive(eng, [a])
        assert a.tokens == self._chain(prompt, 3)
        assert eng.stats()["prefix_misses"] == 1
        prefills = model.prefills
        b = eng.submit(prompt, max_new_tokens=3)
        _drive(eng, [b])
        assert b.tokens == a.tokens             # byte-identical
        assert model.prefills == prefills       # prefill SKIPPED
        assert model.copies, "full hit must COW its append page"
        st = eng.stats()
        assert st["prefix_hits"] == 1
        assert st["prefix_tokens_saved"] == 7   # 8 matched - 1 re-run
        eng.allocator.check_leaks()

    def test_partial_hit_prefills_only_the_tail(self):
        model = ChainModel()
        eng = _engine(model, prefix_cache=True, decode_pool_pages=33)
        a = eng.submit(list(range(1, 9)), max_new_tokens=2)
        _drive(eng, [a])
        prefills = model.prefills
        prompt = list(range(1, 9)) + [20, 21]   # shared trunk + tail
        b = eng.submit(prompt, max_new_tokens=2)
        _drive(eng, [b])
        assert b.tokens == self._chain(prompt, 2)
        assert model.prefills == prefills       # tail via verify family
        st = eng.stats()
        assert st["prefix_hits"] == 1 and st["prefix_tokens_saved"] == 8
        eng.allocator.check_leaks()

    def test_shared_pages_counted_and_freed_exactly(self):
        model = ChainModel()
        eng = _engine(model, prefix_cache=True, decode_max_batch=2,
                      decode_pool_pages=33)
        prompt = list(range(1, 9))
        a = eng.submit(prompt, max_new_tokens=8)
        eng.step()                              # a running, 2 pages cached
        b = eng.submit(prompt, max_new_tokens=8)
        eng.step()                              # b aliases the trunk
        assert eng.allocator.shared_pages >= 1
        eng.allocator.check_leaks()
        _drive(eng, [a, b])
        eng.allocator.check_leaks()
        # all sequence pages returned; only cache-held pages remain
        st = eng.stats()
        assert st["sequences"] == 0
        assert st["used_pages"] == st["cached_pages"] > 0

    def test_cache_eviction_unblocks_admission(self):
        """A pool full of cache-only pages must yield to admissions
        (refcount-aware LRU eviction on demand)."""
        model = ChainModel()
        eng = _engine(model, prefix_cache=True, decode_pool_pages=9)
        # fill the cache: two distinct 2-page prompts = 4 cached pages
        for base in (0, 8):
            s = eng.submit([base + i for i in range(8)],
                           max_new_tokens=1)
            _drive(eng, [s])
        assert eng.stats()["cached_pages"] == 4
        eng.allocator.check_leaks()
        # 8 usable pages, 4 cache-held: this request needs 5 fresh
        s = eng.submit([20 + i for i in range(16)], max_new_tokens=3)
        _drive(eng, [s])
        assert s.finish_reason == "length"
        assert eng.stats()["prefix_evicted_pages"] >= 1
        eng.allocator.check_leaks()

    def test_eviction_never_frees_the_planned_hit_pages(self):
        """On-demand eviction under a pending HIT must take OTHER
        cache-only pages, never the ones the admission planned to
        alias/COW — freeing those would strand a half-shared sequence
        and storm-fail the step."""
        model = ChainModel()
        eng = _engine(model, prefix_cache=True, decode_pool_pages=9)
        a = eng.submit(list(range(1, 9)), max_new_tokens=1)   # 2 pages
        _drive(eng, [a])
        b = eng.submit([40, 41, 42, 43], max_new_tokens=1)    # 1 page
        _drive(eng, [b])
        assert eng.stats()["cached_pages"] == 3
        # full hit on A needing fresh=6 of 5 free: eviction must take
        # B's page (unprotected), keep A's two, and serve the hit
        s = eng.submit(list(range(1, 9)), max_new_tokens=20)
        _drive(eng, [s], limit=128)
        assert s.finish_reason == "length" and s.error is None
        assert list(s.tokens)[:3] == [9, 10, 11]
        st = eng.stats()
        assert st["prefix_hits"] == 1, st
        assert st["prefix_evicted_pages"] >= 1
        # B evicted, A still cached
        assert eng.prefix_cache.lookup(
            np.asarray([40, 41, 42, 43], np.int32)) == []
        assert len(eng.prefix_cache.lookup(
            np.asarray(list(range(1, 9)), np.int32))) == 2
        eng.allocator.check_leaks()

    def test_unservable_hit_plan_degrades_to_miss(self):
        """When the ONLY evictable pages are the planned hit's own,
        the plan is dropped (degrade to a miss, evict freely, plain
        prefill) instead of blocking the line forever."""
        model = ChainModel()
        eng = _engine(model, prefix_cache=True, decode_pool_pages=9)
        a = eng.submit(list(range(1, 9)), max_new_tokens=1)
        _drive(eng, [a])
        assert eng.stats()["cached_pages"] == 2
        # full hit would alias/COW both cached pages, but the request
        # needs all 8 usable pages fresh-or-shared: total=8, fresh=7 >
        # 6 free with both candidates protected -> degrade
        s = eng.submit(list(range(1, 9)), max_new_tokens=24)
        _drive(eng, [s], limit=128)
        assert s.finish_reason == "length" and s.error is None
        assert list(s.tokens)[:3] == [9, 10, 11]
        st = eng.stats()
        assert st["prefix_hits"] == 0 and st["prefix_misses"] == 2, st
        # the planned pages WERE freed for the degrade (the plain
        # prefill then legitimately re-seeded the cache with its own)
        assert st["prefix_evicted_pages"] == 2, st
        eng.allocator.check_leaks()

    def test_corrupt_lookup_degrades_to_plain_prefill(self):
        """The §9 degrade contract: a failed/corrupted radix lookup is
        a MISS — same tokens, prefill paid, nothing poisoned."""
        from mxnet_tpu_torch import faults
        model = ChainModel()
        eng = _engine(model, prefix_cache=True, decode_pool_pages=33)
        prompt = list(range(1, 9))
        a = eng.submit(prompt, max_new_tokens=3)
        _drive(eng, [a])
        prefills = model.prefills
        with faults.plan("decode.prefix_lookup=corrupt,times=1"):
            b = eng.submit(prompt, max_new_tokens=3)
            _drive(eng, [b])
        assert b.tokens == a.tokens             # never wrong tokens
        assert model.prefills == prefills + 1   # degraded = plain path
        st = eng.stats()
        assert st["prefix_degraded"] == 1
        eng.allocator.check_leaks()

    def test_cached_path_failure_demotes_to_plain(self):
        """A failing verify program on the cached-prefill path releases
        the aliased pages and re-queues the request down the plain
        path — degradation, not quarantine, and leak-free."""
        from mxnet_tpu_torch import faults
        model = ChainModel()
        eng = _engine(model, prefix_cache=True, decode_pool_pages=33,
                      retry_max=0)
        prompt = list(range(1, 9))
        a = eng.submit(prompt, max_new_tokens=3)
        _drive(eng, [a])
        # the next decode.prefill injection fires inside the CACHED
        # prefill (verify family) — after=0 hits the hit-path call
        with faults.plan("decode.prefill=fail,times=1"):
            b = eng.submit(prompt, max_new_tokens=3)
            _drive(eng, [b])
        assert b.tokens == a.tokens
        assert b.finish_reason == "length"
        st = eng.stats()
        assert st["prefix_degraded"] == 1
        assert st["quarantined"] == 0           # degrade, not quarantine
        assert st["admitted"] == st["evicted"] == 2
        # a demoted hit served NO cached work: it must not count as a
        # hit nor keep phantom tokens_saved (hit ratio stays honest)
        assert st["prefix_hits"] == 0
        assert st["prefix_tokens_saved"] == 0
        eng.allocator.check_leaks()

    def test_cached_path_kernel_failure_quarantines(self):
        """A verify KERNEL that cannot run is not a cache problem: the
        hit is quarantined and fails with the KernelError — it is not
        demoted to a plain prefill that would serve it without the
        kernel."""
        from mxnet_tpu_torch.base import KernelError

        class NoVerifyKernel(ChainModel):
            def verify(self, tokens, start, length, block_table):
                raise KernelError("ragged_paged_verify: kernel launch "
                                  "failed with CUDA error 209")

        model = NoVerifyKernel()
        eng = _engine(model, prefix_cache=True, decode_pool_pages=33)
        prompt = list(range(1, 9))
        a = eng.submit(prompt, max_new_tokens=3)
        _drive(eng, [a])
        prefills = model.prefills
        b = eng.submit(prompt, max_new_tokens=3)
        _drive(eng, [b])
        assert b.finish_reason == "quarantined"
        assert isinstance(b.error, KernelError) and b.tokens == []
        assert model.prefills == prefills       # never served around
        st = eng.stats()
        assert st["quarantined"] == 1 and st["prefix_degraded"] == 0
        assert st["prefix_hits"] == 0
        eng.allocator.check_leaks()

    def test_random_cached_orders_never_leak(self):
        """Engine-level half of the ISSUE-12 satellite: ~300 random
        submit/step/cancel orders over a small shared-prompt pool with
        the cache on — check_leaks() exact at every step."""
        rng = np.random.RandomState(11)
        model = ChainModel()
        eng = _engine(model, prefix_cache=True, decode_max_batch=4,
                      decode_pool_pages=33, queue_depth=256)
        prompts = [list(range(1, 9)), list(range(1, 13)),
                   list(range(1, 9)) + [9, 9], [5, 6, 7, 8]]
        live = []
        for _ in range(300):
            r = rng.rand()
            if r < 0.45:
                s = eng.submit(prompts[rng.randint(len(prompts))],
                               max_new_tokens=int(rng.randint(1, 5)))
                live.append(s)
            elif live and r < 0.6:
                live[rng.randint(len(live))].cancelled = True
            else:
                eng.step()
            eng.allocator.check_leaks()
            live = [s for s in live if not s.event.is_set()]
        _drive(eng, live, limit=256)
        eng.allocator.check_leaks()
        st = eng.stats()
        assert st["sequences"] == 0
        assert st["used_pages"] == st["cached_pages"]


# ----------------------------------------------------- speculative engine
class TestSpeculativeEngine:
    def test_full_acceptance_compresses_steps(self):
        """An agreeing draft emits k+1 tokens per round: 8 tokens land
        in ~2 engine steps instead of 8."""
        model = ChainModel()
        eng = _engine(model, draft=SkewDraft(1), spec_k=3,
                      decode_max_new_tokens=8, decode_pool_pages=33)
        s = eng.submit([5], max_new_tokens=8)
        n = _drive(eng, [s])
        assert s.tokens == [(5 + i) % 32 for i in range(1, 9)]
        assert n <= 4, n
        st = eng.stats()
        assert st["spec_accepted"] == st["spec_proposed"] > 0
        assert st["spec_acceptance"] == 1.0
        eng.allocator.check_leaks()

    def test_zero_acceptance_is_byte_identical_to_plain(self):
        """Rejection sampling in greedy mode is exact: even a draft
        that never agrees yields the plain path's exact tokens."""
        plain = _engine(ChainModel(), decode_max_new_tokens=8)
        want = plain.submit([5], max_new_tokens=8)
        _drive(plain, [want])
        model = ChainModel()
        eng = _engine(model, draft=SkewDraft(2), spec_k=3,
                      decode_max_new_tokens=8, decode_pool_pages=33)
        s = eng.submit([5], max_new_tokens=8)
        _drive(eng, [s])
        assert s.tokens == want.tokens
        st = eng.stats()
        assert st["spec_proposed"] > 0 and st["spec_accepted"] == 0
        eng.allocator.check_leaks()

    def test_eos_mid_window_stops_exactly(self):
        model = ChainModel()
        eng = _engine(model, draft=SkewDraft(1), spec_k=3,
                      decode_max_new_tokens=16, decode_pool_pages=33)
        # chain 5 -> 6 -> 7(eos): eos lands inside the first window
        s = eng.submit([5], max_new_tokens=16, eos_id=7)
        _drive(eng, [s])
        assert s.tokens == [6, 7] and s.finish_reason == "eos"
        eng.allocator.check_leaks()

    def test_length_cap_never_overshoots(self):
        model = ChainModel()
        eng = _engine(model, draft=SkewDraft(1), spec_k=3,
                      decode_max_new_tokens=16, decode_pool_pages=33)
        for n in (1, 2, 3, 4, 5):
            s = eng.submit([1], max_new_tokens=n)
            _drive(eng, [s])
            assert len(s.tokens) == n and s.finish_reason == "length"
            eng.allocator.check_leaks()

    def test_draft_failure_degrades_round_to_plain(self):
        class FlakyDraft(SkewDraft):
            def decode_step(self, tokens, positions, block_tables):
                self.steps += 1
                if self.steps == 1:
                    raise ValueError("draft died")
                return super().decode_step(tokens, positions,
                                           block_tables)

        model = ChainModel()
        eng = _engine(model, draft=FlakyDraft(1), spec_k=2,
                      decode_max_new_tokens=6, decode_pool_pages=33)
        s = eng.submit([5], max_new_tokens=6)
        _drive(eng, [s])
        assert s.tokens == [(5 + i) % 32 for i in range(1, 7)]
        assert eng.stats()["spec_fallbacks"] >= 1
        eng.allocator.check_leaks()

    def test_verify_failure_quarantines_leak_free(self):
        """A persistent verify failure is a TARGET failure: the §8
        quarantine path fires for that sequence alone; batchmates keep
        decoding and every page comes back."""
        from mxnet_tpu_torch import faults
        model = ChainModel()
        eng = _engine(model, draft=SkewDraft(1), spec_k=2,
                      decode_max_batch=2, decode_max_new_tokens=6,
                      decode_pool_pages=33, retry_max=0)
        a = eng.submit([5], max_new_tokens=6)
        b = eng.submit([9], max_new_tokens=6)
        with faults.plan("decode.verify=fail,times=1"):
            _drive(eng, [a, b])
        done = {s.finish_reason for s in (a, b)}
        assert done == {"quarantined", "length"}, done
        ok = a if a.finish_reason == "length" else b
        assert ok.tokens == [(ok.prompt[0] + i) % 32
                             for i in range(1, 7)]
        assert eng.stats()["quarantined"] == 1
        eng.allocator.check_leaks()
        assert eng.stats()["used_pages"] == 0

    def test_spec_composes_with_prefix_cache(self):
        model = ChainModel()
        eng = _engine(model, draft=SkewDraft(1), spec_k=3,
                      prefix_cache=True, decode_max_new_tokens=8,
                      decode_pool_pages=33)
        prompt = list(range(1, 9))
        a = eng.submit(prompt, max_new_tokens=8)
        _drive(eng, [a])
        prefills = model.prefills
        b = eng.submit(prompt, max_new_tokens=8)
        _drive(eng, [b])
        assert b.tokens == a.tokens
        assert model.prefills == prefills       # hit skipped prefill
        st = eng.stats()
        assert st["prefix_hits"] == 1
        assert st["spec_accepted"] == st["spec_proposed"] > 0
        eng.allocator.check_leaks()

    def test_spec_without_draft_disabled_not_fatal(self):
        eng = _engine(ChainModel(), spec_k=3)
        assert eng.spec_k == 0
        s = eng.submit([5], max_new_tokens=2)
        _drive(eng, [s])
        assert s.tokens == [6, 7]


# ---------------------------------------------------------- device pool
class TestDeviceKVPool:
    def test_pool_layout_and_in_place_copy_on_write(self):
        from mxnet_tpu_torch.serving.kv_cache import DeviceKVPool
        geom = PageGeometry(4, 6, 16, 2, 3, 8)
        pool = DeviceKVPool(geom, device="cpu")
        assert tuple(pool.k_pages.shape) == (2, 6, 4, 3, 8)
        assert pool.k_pages.dtype == torch.float32
        assert not pool.k_pages.any() and not pool.v_pages.any()
        assert pool.nbytes == 2 * geom.kv_bytes(4)
        k_ptr, v_ptr = pool.k_pages.data_ptr(), pool.v_pages.data_ptr()
        pool.k_pages[:, 2] = torch.randn(2, 4, 3, 8)
        pool.v_pages[:, 2] = torch.randn(2, 4, 3, 8)
        pool.copy_page(2, 5)
        # the port writes through the same storage (no swap, no realloc)
        assert pool.k_pages.data_ptr() == k_ptr
        assert pool.v_pages.data_ptr() == v_ptr
        assert torch.equal(pool.k_pages[:, 5], pool.k_pages[:, 2])
        assert torch.equal(pool.v_pages[:, 5], pool.v_pages[:, 2])
        assert not pool.k_pages[:, 1].any()     # other pages untouched


# ------------------------------------------------- end to end (real LM)
VOCAB = 13


def _jax_lm(seed, max_length=32):
    mx.random.seed(seed)
    lm = jtb.TransformerDecoderLM(VOCAB, units=8, hidden_size=16,
                                  num_layers=2, num_heads=2,
                                  max_length=max_length)
    lm.initialize(mx.init.Xavier())
    return lm


def _port_lm(jax_lm, max_length=32):
    np_params = jax.tree_util.tree_map(np.asarray,
                                       jtb.paged_lm_params(jax_lm))
    return TransformerDecoderLM(
        VOCAB, units=8, hidden_size=16, num_layers=2, num_heads=2,
        max_length=max_length, device="cpu").load_numpy_params(np_params)


@pytest.fixture(scope="module")
def lm_pair():
    """One tiny JAX target, its weights in a port LM, and a port draft
    with other weights (acceptance is incidental, parity is the point).
    """
    target = _jax_lm(7)
    return target, _port_lm(target), _port_lm(_jax_lm(29))


def _jax_greedy(lm, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        lg = lm(nd.NDArray(np.asarray([toks], np.int32))).asnumpy()
        toks.append(int(np.argmax(lg[0, -1])))
    return toks[len(prompt):]


def _serve(port_lm, draft=None, **cfg_kw):
    cfg = serving.ServingConfig(decode_page_size=4, decode_pool_pages=33,
                                decode_max_batch=2, **cfg_kw)
    adapter = PagedLMAdapter(port_lm, device="cpu")
    draft_adapter = None if draft is None \
        else PagedLMAdapter(draft, device="cpu")
    return DecodeEngine(adapter, cfg, model_name="lm", autostart=True,
                        draft=draft_adapter)


class TestGenerateEndToEnd:
    def test_concurrent_generate_matches_jax_greedy(self, lm_pair):
        """Mixed prompt/length requests from several threads: the port's
        engine emits exactly the JAX full forward's greedy tokens, every
        page comes back, and the launched shapes stay in the bound."""
        jax_lm, port_lm, _ = lm_pair
        eng = _serve(port_lm)
        outs = {}
        try:
            def gen(i):
                prompt = list(range(1, 2 + i % 4))
                outs[i] = (prompt, eng.generate(prompt,
                                                max_new_tokens=2 + i % 3,
                                                timeout=300))

            ts = [threading.Thread(target=gen, args=(i,), daemon=True)
                  for i in range(6)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)
            assert not any(t.is_alive() for t in ts)
            assert len(outs) == 6
            for i, (prompt, toks) in outs.items():
                assert toks.tolist() == _jax_greedy(jax_lm, prompt,
                                                    2 + i % 3)
            st = eng.stats()
            assert st["programs"] <= st["program_bound"], st
            assert st["used_pages"] == 0
            adapter = eng.model
            assert len([s for s in adapter._signatures
                        if s[0] == "prefill"]) \
                <= len(bucket_set(adapter.max_context))
        finally:
            assert eng.stop(timeout=60)
        eng.allocator.check_leaks()

    def test_prefix_cache_hits_match_jax_greedy(self, lm_pair):
        jax_lm, port_lm, _ = lm_pair
        eng = _serve(port_lm, prefix_cache=True)
        try:
            prompt = [1, 2, 3, 4, 5, 6, 7, 8]
            want = _jax_greedy(jax_lm, prompt, 4)
            a = eng.generate(prompt, max_new_tokens=4, timeout=300)
            b = eng.generate(prompt, max_new_tokens=4, timeout=300)
            tail = prompt + [2, 9]
            c = eng.generate(tail, max_new_tokens=4, timeout=300)
            assert a.tolist() == want and b.tolist() == want
            assert c.tolist() == _jax_greedy(jax_lm, tail, 4)
            st = eng.stats()
            assert st["prefix_hits"] == 2 and st["prefix_misses"] == 1
            assert st["prefix_tokens_saved"] == 7 + 8
            assert st["programs"] <= st["program_bound"], st
            sigs = eng.model._signatures
            assert {("verify", 1), ("verify", 2), ("cow",)} <= sigs
        finally:
            assert eng.stop(timeout=60)
        assert eng.allocator.used_pages == 0
        eng.allocator.check_leaks()

    def test_speculative_matches_jax_greedy(self, lm_pair):
        jax_lm, port_lm, draft = lm_pair
        eng = _serve(port_lm, draft=draft, spec_k=2,
                     decode_max_new_tokens=6)
        try:
            for prompt in ([1, 2, 3], [5], [2, 4, 6, 8]):
                got = eng.generate(prompt, max_new_tokens=6, timeout=300)
                assert got.tolist() == _jax_greedy(jax_lm, prompt, 6)
            st = eng.stats()
            assert st["spec_proposed"] > 0
            assert st["programs"] <= st["program_bound"], st
            assert [s for s in eng.model._signatures
                    if s[0] == "verify_batch"] == [("verify_batch", 2, 4)]
        finally:
            assert eng.stop(timeout=60)
        eng.allocator.check_leaks()

    def test_verify_kernel_failure_fails_the_prefix_hit(self, lm_pair,
                                                        monkeypatch):
        """The real adapter: when ragged_paged_verify raises, the
        prefix-hit request fails with that error instead of being
        served by a plain prefill, and every page comes back."""
        from mxnet_tpu_torch.base import KernelError
        from mxnet_tpu_torch.models import transformer_blocks as ptb
        jax_lm, port_lm, _ = lm_pair
        eng = _serve(port_lm, prefix_cache=True)
        try:
            prompt = [1, 2, 3, 4, 5, 6, 7, 8]
            assert eng.generate(prompt, max_new_tokens=4,
                                timeout=300).tolist() \
                == _jax_greedy(jax_lm, prompt, 4)

            def broken(*_a, **_k):
                raise KernelError("ragged_paged_verify: nvcc failed")

            monkeypatch.setattr(ptb, "ragged_paged_verify", broken)
            with pytest.raises(KernelError, match="nvcc failed"):
                eng.generate(prompt, max_new_tokens=4, timeout=300)
            st = eng.stats()
            assert st["quarantined"] == 1 and st["prefix_degraded"] == 0
            assert st["prefix_hits"] == 0
        finally:
            assert eng.stop(timeout=60)
        assert eng.allocator.used_pages == 0
        eng.allocator.check_leaks()

    def test_draft_kernel_failure_fails_loudly(self, lm_pair, monkeypatch):
        """A draft-side KernelError is not a speculation fallback: the
        step fails and the request raises it."""
        from mxnet_tpu_torch.base import KernelError
        from mxnet_tpu_torch.models import transformer_blocks as ptb
        _, port_lm, draft = lm_pair
        eng = _serve(port_lm, draft=draft, spec_k=2,
                     decode_max_new_tokens=6)
        try:
            def broken(*_a, **_k):
                raise KernelError("ragged_paged_attention: launch failed")

            monkeypatch.setattr(ptb, "ragged_paged_attention", broken)
            with pytest.raises(KernelError, match="launch failed"):
                eng.generate([1, 2, 3], max_new_tokens=6, timeout=300)
            assert eng.stats()["spec_fallbacks"] == 0
        finally:
            assert eng.stop(timeout=60)
        assert eng.allocator.used_pages == 0
        eng.allocator.check_leaks()

    def test_adapter_binds_one_live_engine(self, lm_pair):
        _, port_lm, _ = lm_pair
        eng = _serve(port_lm)
        adapter = eng.model
        try:
            with pytest.raises(MXNetError, match="one adapter serves"):
                DecodeEngine(adapter, eng.config, model_name="dup")
            eng.generate([1], max_new_tokens=2, timeout=300)
        finally:
            assert eng.stop(timeout=60)
        assert adapter.pool is None             # pool released
        eng.start()                             # rebind
        try:
            assert adapter.pool is not None
            assert len(eng.generate([1], max_new_tokens=2,
                                    timeout=300)) == 2
        finally:
            assert eng.stop(timeout=60)
