"""Paged KV cache for the decode engine (docs/serving.md §6, §9).

The PyTorch port of ``mxnet_tpu.serving.kv_cache``: the host-side
allocator and prefix cache are copies; the device pool is torch.

The KV cache of an autoregressive batch is ragged — every sequence has
a different length, and lengths grow every step.  A contiguous
per-sequence (max_len) slab wastes HBM on short sequences and
fragments on long ones; the paged layout ("Ragged Paged Attention",
PAPERS.md / vLLM's PagedAttention) instead preallocates ONE device
pool of fixed-size pages and gives each sequence a *block table* of
page indices, so long and short sequences share the pool with zero
fragmentation and page granularity waste only.

Four pieces, split by where the state lives:

- :class:`PageGeometry` — the shared layout constants (page size, pool
  pages, per-sequence table width, model dims).  Everything that must
  agree between the allocator, the device pool, and the paged
  forwards derives from here, so it cannot drift.
- :class:`PageAllocator` — HOST-side free-list bookkeeping: page
  alloc/free per sequence, block-table materialization, occupancy.
  Page 0 is reserved as the *null page*: block-table entries past a
  sequence's allocation point at it, and padded/inactive batch slots
  write their garbage K/V into it — so the paged forwards never need a
  "valid" mask on the write path.  Pages are REFCOUNTED: the null-page
  aliasing trick generalized — a full, immutable prefix page can back
  many block tables at once (prefix caching, docs/serving.md §9), and
  a page returns to the free list only when its last reference drops.
- :class:`PrefixCache` — a radix tree over page-size token-id chunks
  mapping cached prompt prefixes to the (refcounted, immutable) pages
  that hold their K/V, with refcount-aware LRU eviction.  A request
  whose prefix is cached aliases those pages instead of re-running
  prefill.
- :class:`DeviceKVPool` — the preallocated DEVICE tensors, one K and
  one V pool of shape (layers, pool_pages, page_size, heads, head_dim).
  The port's decode forwards write them IN PLACE (where the JAX package
  threaded new arrays through donated programs and rebound them with
  ``swap``), so a pool is allocated once and never reallocated.
  :meth:`DeviceKVPool.copy_page` is the copy-on-write primitive: the
  one shared page a new sequence must append into is duplicated into a
  private page.

The allocator is deliberately strict: freeing a page twice, freeing a
page that is not allocated, or releasing an unknown sequence raises
``MXNetError`` — the decode scheduler's invariants (admit/evict every
step) are enforced here rather than trusted.
"""
from __future__ import annotations

import itertools

from .. import engine
from .. import faults as _faults
from ..base import MXNetError

__all__ = ["PageGeometry", "PageAllocator", "PrefixCache",
           "DeviceKVPool"]


class PageGeometry:
    """Layout constants shared by the allocator, the device pool, and
    the paged decode forwards.

    - ``page_size``: tokens per KV page.
    - ``pool_pages``: TOTAL pages in the device pool, including the
      reserved null page 0 (``usable_pages`` = pool_pages - 1).
    - ``max_context``: longest context a sequence may reach (prompt +
      generated); ``pages_per_seq`` block-table slots cover it.
    - ``num_layers`` / ``num_heads`` / ``head_dim``: the model dims the
      pool arrays are shaped with.
    """

    def __init__(self, page_size, pool_pages, max_context, num_layers,
                 num_heads, head_dim):
        if page_size < 1:
            raise MXNetError("PageGeometry: page_size must be >= 1")
        if pool_pages < 2:
            raise MXNetError(
                "PageGeometry: pool_pages must be >= 2 (page 0 is the "
                "reserved null page)")
        if max_context < 1:
            raise MXNetError("PageGeometry: max_context must be >= 1")
        self.page_size = int(page_size)
        self.pool_pages = int(pool_pages)
        self.max_context = int(max_context)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.pages_per_seq = -(-self.max_context // self.page_size)

    @property
    def usable_pages(self):
        return self.pool_pages - 1

    def pages_for(self, tokens):
        """Pages needed to hold ``tokens`` tokens of context."""
        if tokens < 0:
            raise MXNetError(f"pages_for: negative token count {tokens}")
        return -(-tokens // self.page_size)

    def kv_bytes(self, dtype_size=4):
        """Device bytes of ONE pool array (K or V)."""
        return (self.num_layers * self.pool_pages * self.page_size
                * self.num_heads * self.head_dim * dtype_size)

    def __repr__(self):
        return (f"PageGeometry(page_size={self.page_size}, "
                f"pool_pages={self.pool_pages}, "
                f"max_context={self.max_context}, "
                f"pages_per_seq={self.pages_per_seq}, "
                f"layers={self.num_layers}, heads={self.num_heads}, "
                f"head_dim={self.head_dim})")


class PageAllocator:
    """Refcounted free-list page allocator with per-sequence block
    tables.

    Thread-safe: every mutator and :meth:`stats` holds the internal
    ``_lock``, so a server thread releasing a cancelled sequence cannot
    tear the free list under the decode loop's admission.  The lock
    nests INSIDE the decode engine's condition (``_cond`` ->
    ``PageAllocator._lock``, never the reverse), and it is
    non-reentrant — nested work goes through ``_locked``-suffixed
    helpers.  All-or-nothing
    semantics: an allocation that cannot be fully satisfied changes
    nothing and returns False, so a half-admitted sequence can never
    strand pages.

    Every in-use page carries a reference count: 1 for a privately
    owned page, +1 per additional sequence aliasing it (:meth:`share` /
    :meth:`admit`), +1 when the :class:`PrefixCache` holds it
    (:meth:`retain_cached`).  :meth:`release` decrements; a page
    returns to the free list only at refcount zero, so a cached prefix
    page survives its writer's eviction and a shared page survives all
    but its last reader.
    """

    def __init__(self, geometry):
        self.geometry = geometry
        # LIFO free list: a just-freed page is reused first, which keeps
        # the working set of hot pages small and makes block-table reuse
        # after eviction directly observable (tests assert it)
        self._free = list(range(geometry.pool_pages - 1, 0, -1))
        self._pages = {}                # seq_id -> [page, ...]
        self._refs = {}                 # page -> reference count (>= 1)
        self._cached = {}               # page -> PrefixCache-held refs
        self.peak_used = 0
        # guards every mutator (and stats()); acquired AFTER the decode
        # engine's condition when both are held.  engine.make_lock is a
        # plain non-reentrant Lock, hence the _locked helper split.
        self._lock = engine.make_lock("serving.PageAllocator._lock")
        engine.watch_races(self)

    # ------------------------------------------------------------ queries
    @property
    def free_pages(self):
        return len(self._free)

    @property
    def used_pages(self):
        return self.geometry.usable_pages - len(self._free)

    @property
    def occupancy(self):
        """Used fraction of the usable pool (0.0 - 1.0)."""
        return self.used_pages / max(1, self.geometry.usable_pages)

    @property
    def shared_pages(self):
        """Pages referenced more than once (actively shared between
        sequences, or between a sequence and the prefix cache)."""
        return sum(1 for n in self._refs.values() if n > 1)

    @property
    def cached_pages(self):
        """Pages the prefix cache holds a reference on."""
        return len(self._cached)

    def refcount(self, page):
        return self._refs.get(page, 0)

    def cache_only(self, page):
        """True when the prefix cache holds the ONLY references to
        ``page`` — the refcount-aware LRU eviction predicate."""
        return self._refs.get(page, 0) == self._cached.get(page, 0) > 0

    def pages_of(self, seq_id):
        return list(self._pages.get(seq_id, ()))

    def can_allocate(self, n_pages):
        return n_pages <= len(self._free)

    # ---------------------------------------------------------- mutation
    def allocate(self, seq_id, n_pages):
        """Grow ``seq_id``'s allocation by ``n_pages`` pages (first call
        creates it).  Returns True, or False (state unchanged) when the
        free list cannot cover the request."""
        if n_pages < 0:
            raise MXNetError(f"allocate({seq_id!r}): negative page "
                             f"count {n_pages}")
        # chaos site: injected pool exhaustion — reported the way real
        # exhaustion is (refusal, state unchanged), so the admission/
        # deadline path downstream is what gets proven
        if n_pages and _faults.check("kv_cache.allocate"):
            return False
        with self._lock:
            owned = self._pages.setdefault(seq_id, [])
            if len(owned) + n_pages > self.geometry.pages_per_seq:
                raise MXNetError(
                    f"allocate({seq_id!r}): {len(owned)} + {n_pages} "
                    f"pages exceed the block table "
                    f"({self.geometry.pages_per_seq} slots = "
                    f"max_context {self.geometry.max_context} / "
                    f"page_size {self.geometry.page_size})")
            if n_pages > len(self._free):
                if not owned:
                    del self._pages[seq_id]
                return False
            for _ in range(n_pages):
                page = self._free.pop()
                owned.append(page)
                self._refs[page] = 1
            self.peak_used = max(self.peak_used, self.used_pages)
            return True

    def share(self, seq_id, pages):
        """Alias already-referenced ``pages`` into ``seq_id``'s block
        table (in logical order, BEFORE any privately allocated pages).
        The sequence must not re-alias a page it already references.
        Raises on an unreferenced or out-of-range page — sharing hands
        out read-only views, never resurrects a freed page."""
        with self._lock:
            return self._share_locked(seq_id, pages)

    def _share_locked(self, seq_id, pages):
        # mxlint: disable=lock-discipline (contract: callers hold
        # self._lock — share() and admit() both acquire it; the lock
        # is non-reentrant, hence this unlocked helper)
        owned = self._pages.setdefault(seq_id, [])
        if len(owned) + len(pages) > self.geometry.pages_per_seq:
            raise MXNetError(
                f"share({seq_id!r}): {len(owned)} + {len(pages)} pages "
                f"exceed the block table "
                f"({self.geometry.pages_per_seq} slots)")
        for p in pages:
            if self._refs.get(p, 0) < 1 \
                    or not 1 <= p < self.geometry.pool_pages:
                raise MXNetError(
                    f"share({seq_id!r}): page {p} is free or out of "
                    f"range — only live pages can be aliased")
            if p in owned:
                raise MXNetError(
                    f"share({seq_id!r}): page {p} already in this "
                    f"sequence's block table")
            owned.append(p)
            # mxlint: disable=lock-discipline (caller holds self._lock)
            self._refs[p] += 1
        return True

    def admit(self, seq_id, shared_pages, fresh_pages):
        """All-or-nothing admission of one sequence: alias
        ``shared_pages`` (prefix-cache hit) then allocate
        ``fresh_pages`` private pages behind them.  Returns True, or
        False (state unchanged) when the free list cannot cover the
        private part — the same refusal contract as :meth:`allocate`,
        so the scheduler's FIFO head-blocking logic needs no new case.
        """
        with self._lock:
            if seq_id in self._pages:
                raise MXNetError(
                    f"admit({seq_id!r}): sequence already admitted")
            # mirror allocate()'s chaos site BEFORE any mutation so an
            # injected exhaustion is indistinguishable from a real one
            # (faults.check never raises or blocks, so holding _lock
            # across it is safe)
            if fresh_pages and _faults.check("kv_cache.allocate"):
                return False
            if fresh_pages > len(self._free):
                return False
            if len(shared_pages) + fresh_pages \
                    > self.geometry.pages_per_seq:
                raise MXNetError(
                    f"admit({seq_id!r}): {len(shared_pages)} shared + "
                    f"{fresh_pages} fresh pages exceed the block table "
                    f"({self.geometry.pages_per_seq} slots)")
            if shared_pages:
                self._share_locked(seq_id, shared_pages)
            owned = self._pages.setdefault(seq_id, [])
            for _ in range(fresh_pages):
                page = self._free.pop()
                owned.append(page)
                self._refs[page] = 1
            self.peak_used = max(self.peak_used, self.used_pages)
            return True

    def retain_cached(self, page):
        """The prefix cache takes one reference on a live page (the
        page outlives the sequence that wrote it)."""
        with self._lock:
            if self._refs.get(page, 0) < 1 \
                    or not 1 <= page < self.geometry.pool_pages:
                raise MXNetError(
                    f"retain_cached: page {page} is free or out of "
                    f"range — only live pages can be cached")
            self._refs[page] += 1
            self._cached[page] = self._cached.get(page, 0) + 1

    def release_cached(self, page):
        """The prefix cache drops its reference on ``page`` (eviction);
        the page returns to the free list when nothing else holds it."""
        with self._lock:
            if self._cached.get(page, 0) < 1:
                raise MXNetError(
                    f"release_cached: page {page} is not cache-held — "
                    f"double eviction, or never retained")
            self._cached[page] -= 1
            if not self._cached[page]:
                del self._cached[page]
            self._decref(page, f"release_cached({page})")

    def _decref(self, page, where):
        # caller holds self._lock (non-reentrant, so no lock here):
        # release(), release_cached() both acquire it lexically
        refs = self._refs.get(page, 0)
        if refs < 1 or not 1 <= page < self.geometry.pool_pages:
            raise MXNetError(
                f"{where}: page {page} is already free or out of "
                f"range — allocator state corrupted")
        if refs == 1:
            # mxlint: disable=lock-discipline (caller holds self._lock)
            del self._refs[page]
            # mxlint: disable=lock-discipline (caller holds self._lock)
            self._free.append(page)
        else:
            # mxlint: disable=lock-discipline (caller holds self._lock)
            self._refs[page] = refs - 1

    def release(self, seq_id):
        """Drop every reference ``seq_id`` holds; a page returns to the
        free list when its LAST reference drops.  Raises on an unknown
        sequence or a corrupted (double-freed / duplicated) page — the
        leak/double-free guard the scheduler tests lean on."""
        with self._lock:
            pages = self._pages.pop(seq_id, None)
            if pages is None:
                raise MXNetError(
                    f"release({seq_id!r}): unknown sequence (double "
                    f"release, or never admitted)")
            free = set(self._free)
            for p in pages:
                if p in free:
                    raise MXNetError(
                        f"release({seq_id!r}): page {p} is already "
                        f"free — allocator state corrupted")
                self._decref(p, f"release({seq_id!r})")
            return len(pages)

    def block_table(self, seq_id):
        """The (pages_per_seq,) int32 block table of ``seq_id`` —
        allocated pages first, null page 0 in every unused slot (what
        the paged forwards and the attention kernels consume)."""
        import numpy as np
        table = np.zeros((self.geometry.pages_per_seq,), np.int32)
        pages = self._pages.get(seq_id, ())
        table[:len(pages)] = pages
        return table

    def check_leaks(self):
        """Assert the pool is fully accounted for — EXACT under shared
        pages: every usable page is either in the free list or carries
        a refcount equal to the number of block-table slots plus
        cache-held references that point at it, with the free list and
        the referenced set disjoint.  Cheap enough to run every test
        step; returns the live (distinct referenced) page count."""
        owners = {}                     # page -> reference count seen
        for pages in self._pages.values():
            for p in pages:
                owners[p] = owners.get(p, 0) + 1
        for p, n in self._cached.items():
            owners[p] = owners.get(p, 0) + n
        free = set(self._free)
        if len(free) != len(self._free):
            raise MXNetError("free list holds duplicate pages")
        overlap = free.intersection(owners)
        if overlap:
            raise MXNetError(
                f"pages {sorted(overlap)} are both free and referenced")
        if owners != self._refs:
            drift = {p: (owners.get(p), self._refs.get(p))
                     for p in set(owners) | set(self._refs)
                     if owners.get(p) != self._refs.get(p)}
            raise MXNetError(
                f"refcount drift (page: owners vs refs): {drift}")
        total = len(free) + len(owners)
        if total != self.geometry.usable_pages:
            raise MXNetError(
                f"page leak: {len(owners)} referenced + {len(free)} "
                f"free != {self.geometry.usable_pages} usable pages")
        return len(owners)

    def stats(self):
        with self._lock:        # one consistent snapshot
            return {"used_pages": self.used_pages,
                    "free_pages": self.free_pages,
                    "peak_used_pages": self.peak_used,
                    "occupancy": self.occupancy,
                    "shared_pages": self.shared_pages,
                    "cached_pages": self.cached_pages,
                    "sequences": len(self._pages)}


class _PrefixNode:
    """One full-page chunk of a cached prefix: the radix-tree edge is
    the chunk's token-id content (exact content hash — the raw bytes of
    the page's token ids key the child map), the node owns one
    cache-held reference on the physical page holding that chunk's
    K/V."""

    __slots__ = ("key", "page", "children", "parent", "tick")

    def __init__(self, key, page, parent):
        self.key = key                  # bytes of the chunk's token ids
        self.page = page                # physical page id
        self.children = {}              # chunk bytes -> _PrefixNode
        self.parent = parent            # _PrefixNode or the root dict
        self.tick = 0                   # LRU clock at last touch


class PrefixCache:
    """Radix tree over page-size token-id chunks -> immutable KV pages
    (docs/serving.md §9).

    Sharing granularity is one FULL page: a prompt's full-page chunks
    are content-addressed (the chunk's token ids, byte-exact) down the
    tree, and a hit hands back the pages whose K/V a previous sequence
    already wrote — the admitting request aliases them (refcounted in
    the :class:`PageAllocator`) instead of re-running prefill.  Cached
    pages are IMMUTABLE by construction: a full prompt page is never
    rewritten after prefill (generated tokens land in later pages), and
    the one page a full-length hit must append into is copy-on-write
    duplicated first (:meth:`DeviceKVPool.copy_page`).

    Eviction is refcount-aware LRU over LEAF nodes only (an inner
    node's page is part of every descendant's prefix): a leaf whose
    page has live sequence references is skipped, everything else frees
    in least-recently-touched order.  ``max_pages`` caps cache-held
    pages; the decode engine additionally evicts on demand when the
    free list cannot cover an admission.

    Single-writer like the allocator: only the engine's step loop
    mutates it.
    """

    def __init__(self, allocator, max_pages=None):
        self.allocator = allocator
        self.page_size = allocator.geometry.page_size
        self.max_pages = int(max_pages) if max_pages else None
        self._root = {}                 # chunk bytes -> _PrefixNode
        self._ticks = itertools.count(1)
        self._nodes = 0
        self.evicted_pages = 0

    # ------------------------------------------------------------ queries
    @property
    def pages(self):
        return self._nodes              # one page per node, by invariant

    def _chunks(self, prompt):
        """The full page-size chunks of ``prompt`` as content keys."""
        import numpy as np
        ids = np.asarray(prompt, np.int32).reshape(-1)
        ps = self.page_size
        return [ids[i * ps:(i + 1) * ps].tobytes()
                for i in range(ids.size // ps)]

    def lookup(self, prompt):
        """Longest cached prefix of ``prompt``: the physical pages of
        every matched full-page chunk, in logical order (empty = miss).
        Touches the matched path's LRU clocks."""
        pages, children = [], self._root
        tick = next(self._ticks)
        for key in self._chunks(prompt):
            node = children.get(key)
            if node is None:
                break
            node.tick = tick
            pages.append(node.page)
            children = node.children
        return pages

    def insert(self, prompt, seq_pages):
        """Admit ``prompt``'s full-page chunks, backed by the admitting
        sequence's pages (``seq_pages`` in logical order — the cache
        takes one reference per newly inserted page).  Chunks already
        cached are skipped (the sequence aliased those very pages at
        admission, or wrote a duplicate it keeps privately).  Returns
        the number of pages newly cached."""
        added, children, parent = 0, self._root, None
        tick = next(self._ticks)
        for i, key in enumerate(self._chunks(prompt)):
            node = children.get(key)
            if node is None:
                if self.max_pages is not None \
                        and self._nodes >= self.max_pages \
                        and not self.evict(1, protect=parent):
                    break               # full of live pages — stop here
                page = seq_pages[i]
                self.allocator.retain_cached(page)
                node = _PrefixNode(key, page, parent)
                children[key] = node
                self._nodes += 1
                added += 1
            node.tick = tick
            children, parent = node.children, node
        return added

    def _leaves(self):
        out, stack = [], list(self._root.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out

    def evict(self, n_pages, protect=None, protect_pages=None):
        """Free at least ``n_pages`` cache-held pages (refcount-aware
        LRU, leaves first — evicting a leaf may expose its parent as
        the next candidate).  Nodes on the path ending at ``protect``
        are exempt (an in-progress insert must not evict its own
        ancestors), as are nodes holding any page in ``protect_pages``
        (a pending admission must not have the very pages it planned
        to alias freed under it).  Returns the number of pages
        actually freed."""
        keep = set()
        node = protect
        while isinstance(node, _PrefixNode):
            keep.add(id(node))
            node = node.parent
        pinned = set(protect_pages or ())
        freed = 0
        while freed < n_pages:
            candidates = [
                leaf for leaf in self._leaves()
                if id(leaf) not in keep
                and leaf.page not in pinned
                and self.allocator.cache_only(leaf.page)]
            if not candidates:
                break
            leaf = min(candidates, key=lambda n: n.tick)
            siblings = leaf.parent.children \
                if isinstance(leaf.parent, _PrefixNode) else self._root
            del siblings[leaf.key]
            self.allocator.release_cached(leaf.page)
            self._nodes -= 1
            freed += 1
            self.evicted_pages += 1
        return freed

    def clear(self):
        """Drop every cached page (engine stop: the cache must not pin
        pool pages past its engine's life)."""
        stack = list(self._root.values())
        self._root = {}
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.allocator.release_cached(node.page)
            self._nodes -= 1

    def stats(self):
        # hit/miss/tokens-saved counters live with the decode engine
        # (its step loop is the only lookup caller); these are the
        # tree-structure numbers only
        return {"prefix_nodes": self._nodes,
                "prefix_pages": self.pages,
                "prefix_evicted_pages": self.evicted_pages}


class DeviceKVPool:
    """The preallocated device-side page pools.

    One K and one V tensor of shape
    ``(num_layers, pool_pages, page_size, num_heads, head_dim)``,
    allocated ONCE at engine start on ``device`` (float32 by default,
    as in the JAX package).  The paged forwards update both tensors in
    place — there is no ``swap``: the JAX package's donated programs
    returned successor arrays, the port writes through the same
    storage.  Page 0 is the null page — writes routed there (padded
    prefill tail, inactive decode slots) land in memory nothing ever
    attends to.
    """

    def __init__(self, geometry, dtype=None, device="cuda"):
        import torch
        self.geometry = geometry
        self.dtype = dtype or torch.float32
        g = geometry
        shape = (g.num_layers, g.pool_pages, g.page_size, g.num_heads,
                 g.head_dim)
        self.k_pages = torch.zeros(shape, dtype=self.dtype, device=device)
        self.v_pages = torch.zeros(shape, dtype=self.dtype, device=device)

    def copy_page(self, src, dst):
        """Copy-on-write: duplicate page ``src`` into ``dst`` across
        all layers of both pools (the one shared prefix page a new
        sequence must append into becomes private), in place."""
        copy_page_arrays(self.k_pages, self.v_pages, int(src), int(dst))

    @property
    def nbytes(self):
        return (self.k_pages.numel() * self.k_pages.element_size()
                + self.v_pages.numel() * self.v_pages.element_size())


def copy_page_arrays(k_pages, v_pages, src, dst):
    """In-place page duplication across all layers of both pools."""
    k_pages[:, dst].copy_(k_pages[:, src])
    v_pages[:, dst].copy_(v_pages[:, src])
