"""The port's block-paged KV allocator (``repro_torch.serve.kv_pages``):
twins of ``tests/test_kv_pages.py`` against the port's module, plus the
page digests byte for byte against the reference's.

Pure host-side: ref-counting, copy-on-write suffix extension,
digest-chain semantics, LRU eviction under pool pressure, and the
no-leak invariant after mixed retire/refill waves.
"""
import numpy as np
import pytest

from repro.serve import kv_pages as JK
from repro_torch.serve.kv_pages import (BlockTable, PagePool,
                                        PagedPrefixCache, PoolExhausted,
                                        page_digests)


# ---------------------------------------------------------------------------
# page digests
# ---------------------------------------------------------------------------

def test_page_digests_full_pages_only_and_history_chained():
    toks = np.arange(10, dtype=np.int32)
    digs = page_digests("default", toks, 4)
    assert len(digs) == 2                     # 10 tokens → 2 full pages
    # digest i hashes the WHOLE history 0..(i+1)*p-1: same page-1 tokens
    # after a different page 0 must produce a different digest
    other = np.concatenate([np.array([9, 9, 9, 9], np.int32), toks[4:]])
    assert page_digests("default", other, 4)[1] != digs[1]
    # shared history → shared digests, regardless of later divergence
    longer = np.concatenate([toks[:8], np.array([7, 7], np.int32)])
    assert page_digests("default", longer, 4) == digs
    # the format-set tag is folded in (different weights → different KV)
    assert page_digests("alt", toks, 4) != digs
    # limit caps the covered tokens (engine passes L−1)
    assert len(page_digests("default", toks, 4, limit=7)) == 1
    assert page_digests("default", toks, 4, limit=8) == digs


# ---------------------------------------------------------------------------
# PagePool
# ---------------------------------------------------------------------------

def test_pool_alloc_free_refcount_and_capacity():
    pool = PagePool(4, max_pages=2)
    a = pool.alloc("A")
    b = pool.alloc("B")
    assert pool.payload(a) == "A" and pool.refcount(a) == 1
    with pytest.raises(PoolExhausted):
        pool.alloc("C")
    pool.retain(a)
    assert pool.refcount(a) == 2
    assert pool.release(a) is False           # still referenced
    assert pool.release(a) is True            # last ref → freed
    c = pool.alloc("C")                       # capacity freed up
    assert pool.payload(c) == "C"
    with pytest.raises(KeyError):
        pool.release(a)                       # over-release: page is gone
    st = pool.stats()
    assert st["in_use"] == 2 and st["free"] == 0
    assert st["allocs"] == 3 and st["frees"] == 1
    assert st["high_water"] == 2
    pool.release(b), pool.release(c)
    assert pool.stats()["in_use"] == 0        # no leak


def test_pool_validates_construction():
    with pytest.raises(ValueError):
        PagePool(0, 4)
    with pytest.raises(ValueError):
        PagePool(4, 0)


# ---------------------------------------------------------------------------
# BlockTable: fork + copy-on-write
# ---------------------------------------------------------------------------

def test_block_table_append_and_release():
    pool = PagePool(4, max_pages=8)
    t = BlockTable(pool)
    touched = t.append_tokens(6)              # 1.5 pages
    assert len(t) == 6 and len(t.pages) == 2
    assert touched == t.pages
    # growing within the tail page touches only the tail, allocs nothing
    assert t.append_tokens(2) == [t.pages[-1]]
    assert pool.stats()["allocs"] == 2
    t.release()
    assert len(t) == 0 and pool.stats()["in_use"] == 0


def test_block_table_links_cached_pages_and_rejects_partial_link():
    pool = PagePool(4, max_pages=8)
    pid = pool.alloc("cached")
    t = BlockTable(pool)
    t.append_page(pid)                        # retains by default
    assert pool.refcount(pid) == 2 and len(t) == 4
    t.append_tokens(2)                        # partial tail page
    with pytest.raises(ValueError):
        t.append_page(pool.alloc())           # link after partial page
    t.release()
    assert pool.refcount(pid) == 1            # cache's own ref survives


def test_fork_shares_pages_and_cow_protects_parent():
    pool = PagePool(4, max_pages=8)
    parent = BlockTable(pool)
    parent.append_tokens(6)                   # full page + half page
    pool.set_payload(parent.pages[0], "p0")
    pool.set_payload(parent.pages[1], "p1")
    child = parent.fork()
    assert child.pages == parent.pages and len(child) == 6
    assert all(pool.refcount(p) == 2 for p in parent.pages)
    assert pool.stats()["cow_copies"] == 0
    # child writes through the SHARED partial tail → copy-on-write
    touched = child.append_tokens(1, copy_payload=lambda p: p + "-copy")
    assert child.pages[0] == parent.pages[0]      # full page still shared
    assert child.pages[1] != parent.pages[1]      # tail was copied
    assert touched == [child.pages[1]]
    assert pool.payload(child.pages[1]) == "p1-copy"
    assert pool.payload(parent.pages[1]) == "p1"  # parent untouched
    assert pool.refcount(parent.pages[1]) == 1
    assert pool.stats()["cow_copies"] == 1
    # a NON-shared partial tail is written in place, no copy
    child.append_tokens(1)
    assert pool.stats()["cow_copies"] == 1
    parent.release(), child.release()
    assert pool.stats()["in_use"] == 0


# ---------------------------------------------------------------------------
# PagedPrefixCache
# ---------------------------------------------------------------------------

def _digs(tokens, p=4, fset="default"):
    return page_digests(fset, np.asarray(tokens, np.int32), p)


def test_cache_chain_lookup_and_insert():
    pool = PagePool(4, max_pages=8)
    cache = PagedPrefixCache(pool)
    digs = _digs(range(12))                   # 3 pages
    assert cache.chain(digs) == [] and not cache.covers(digs)
    assert cache.insert_chain(digs, lambda i: f"pg{i}") == 3
    assert cache.inserts == 1
    assert cache.covers(digs)
    pids = cache.lookup(digs)
    assert [pool.payload(p) for p in pids] == ["pg0", "pg1", "pg2"]
    # shared-prefix prompt reuses the leading run
    digs2 = _digs(list(range(8)) + [9, 9, 9, 9])
    assert cache.chain(digs2) == pids[:2]
    # re-inserting a resident chain allocates nothing
    assert cache.insert_chain(digs, lambda i: "dup") == 0
    assert cache.inserts == 1 and pool.stats()["allocs"] == 3


def test_cache_lru_eviction_under_pool_pressure():
    pool = PagePool(4, max_pages=2)
    cache = PagedPrefixCache(pool)
    a, b = _digs(range(4)), _digs(range(10, 14))
    cache.insert_chain(a, lambda i: "A")
    cache.insert_chain(b, lambda i: "B")
    cache.lookup(a)                           # bump A → B becomes LRU
    c = _digs(range(20, 24))
    cache.insert_chain(c, lambda i: "C")      # evicts B, not A
    assert cache.evictions == 1
    assert cache.covers(a) and cache.covers(c) and not cache.covers(b)
    assert pool.stats()["in_use"] == 2        # evicted page truly freed


def test_eviction_never_frees_pinned_pages_and_skips_when_starved():
    pool = PagePool(4, max_pages=2)
    cache = PagedPrefixCache(pool)
    a = _digs(range(4))
    cache.insert_chain(a, lambda i: "A")
    # an in-flight row pins the cached page through its block table
    row = BlockTable(pool)
    row.append_page(cache.lookup(a)[0])
    pool.alloc("scratch")                     # pool now full
    b = _digs(range(10, 14))
    cache.insert_chain(b, lambda i: "B")      # evicts A's ENTRY...
    assert cache.evictions == 1 and not cache.covers(a)
    assert len(row) == 4                      # ...but the page survives
    # nothing evictable left and the pool is still full → skip, count it
    assert cache.insert_skips >= 1 or cache.covers(b)
    row.release()
    assert pool.stats()["in_use"] >= 1        # scratch + any B insert


def test_no_leak_after_mixed_retire_refill_waves():
    # simulate the engine's steady state: waves of rows pin cached chains,
    # extend private suffixes (some COW), then retire in mixed order
    pool = PagePool(4, max_pages=16)
    cache = PagedPrefixCache(pool)
    sys_digs = _digs(range(8))                # shared 2-page system prefix
    cache.insert_chain(sys_digs, lambda i: f"sys{i}")
    live = []
    for wave in range(3):
        for r in range(4):
            t = BlockTable(pool)
            for pid in cache.lookup(sys_digs):
                t.append_page(pid)
            t.append_tokens(3 + r)            # private suffix, may COW
            live.append(t)
        # retire interleaved: odd rows first, then evens of older waves
        for t in [x for i, x in enumerate(live) if i % 2]:
            t.release()
        live = [x for i, x in enumerate(live) if i % 2 == 0]
    for t in live:
        t.release()
    # only the cache's own references remain
    assert pool.stats()["in_use"] == len(cache)
    assert pool.stats()["allocs"] - pool.stats()["frees"] == len(cache)
    # and the shared prefix pages were never duplicated by suffix COW
    assert cache.covers(sys_digs)


# ---------------------------------------------------------------------------
# digests equal the reference's
# ---------------------------------------------------------------------------

def test_page_digests_equal_reference_bytes():
    """Over a seeded sweep of lengths, page sizes, limits, tags and
    token dtypes the port's chain is the reference's, byte for byte."""
    rng = np.random.default_rng(0)
    cases = 0
    for _ in range(200):
        n = int(rng.integers(0, 80))
        toks = rng.integers(0, 92544, n)
        toks = toks.astype(rng.choice([np.int32, np.int64]))
        pt = int(rng.choice([1, 2, 3, 4, 8, 16]))
        limit = None if rng.random() < 0.3 else int(rng.integers(0, n + 3))
        tag = str(rng.choice(["default", "fp8_e4m3+bf16+fp32", "int8_pt:d"]))
        want = JK.page_digests(tag, toks, pt, limit=limit)
        got = page_digests(tag, toks, pt, limit=limit)
        assert got == want
        assert all(isinstance(d, bytes) and len(d) == 16 for d in got)
        cases += bool(got)
    assert cases > 100            # most draws have at least one page
