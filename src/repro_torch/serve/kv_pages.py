"""Block-paged KV cache: page pool, per-request block tables, and the
paged prefix cache of the serve engine (twin of ``repro.serve.kv_pages``;
host-side bookkeeping only, no torch).

* :class:`PagePool` — a fixed-capacity allocator of *pages*, each
  covering ``page_tokens`` KV positions for every layer of the model.
  Pages are ref-counted: a page may simultaneously back a cached prefix
  chain, several in-flight request rows, and a forked block table; it is
  freed only when the last reference drops.  The pool is pure host-side
  bookkeeping — payloads (the engine's KV tensors on its device, numpy
  arrays or strings in tests) are opaque objects.
* :class:`BlockTable` — one request's ordered page chain plus a token
  cursor.  ``fork()`` shares every page with the parent (ref-count
  bumps, zero copies); appending tokens through a *shared* partially
  filled tail page triggers **copy-on-write**: the tail is copied into a
  fresh page first, so the parent's chain is never mutated.
* :class:`PagedPrefixCache` — digest-chained LRU over pages.  Token
  positions ``[i*page_tokens, (i+1)*page_tokens)`` of a prompt are keyed
  by a digest of tokens ``0 .. (i+1)*page_tokens-1`` (the whole history,
  because causal KV depends on every earlier token), so two prompts
  sharing a prefix share the *same* pages no matter which shape bucket —
  or which prompt length — they serve through.  Eviction is per-digest
  LRU; a page evicted from the cache survives until in-flight rows
  release it.

Correctness: under causal attention the KV of page ``i`` depends only on
tokens ``0 .. (i+1)*page_tokens-1``, so a cached page holds the bits a
fresh prefill of the same tokens would write — paging keeps the engine's
batched == unbatched guarantee.  The digests are byte-equal to the
reference's, so both packages key the same prompts the same way.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional

import numpy as np

__all__ = [
    "BlockTable", "PagePool", "PagedPrefixCache", "PoolExhausted",
    "page_digests",
]


class PoolExhausted(RuntimeError):
    """No free page and nothing evictable — the caller must skip caching
    (serving never fails on cache pressure)."""


def page_digests(fset: str, tokens, page_tokens: int,
                 limit: Optional[int] = None) -> list[bytes]:
    """Chain digests for every *full* page of ``tokens``.

    ``digests[i]`` keys KV positions ``[i*p, (i+1)*p)`` and hashes tokens
    ``0 .. (i+1)*p - 1`` — the full history, because causal KV at a
    position depends on every earlier token.  The format-set tag is
    folded in because different weight variants produce different KV.
    ``limit`` caps the covered token count (the engine passes ``L - 1``
    so a request's last real token is always computed fresh)."""
    toks = np.ascontiguousarray(tokens, dtype=np.int32)
    n_tok = len(toks) if limit is None else min(len(toks), limit)
    out = []
    h = hashlib.blake2b(digest_size=16)
    h.update(fset.encode())
    for i in range(n_tok // page_tokens):
        h.update(toks[i * page_tokens:(i + 1) * page_tokens].tobytes())
        out.append(h.copy().digest())
    return out


@dataclasses.dataclass
class _Page:
    refs: int = 1
    payload: object = None


class PagePool:
    """Ref-counted fixed-capacity page allocator (host-side only).

    ``alloc`` returns an integer page id with ref-count 1; ``retain`` /
    ``release`` adjust the count, and the page (and its payload) is
    dropped when the count reaches zero.  ``stats()`` exposes the
    counters the no-leak invariant tests assert on."""

    def __init__(self, page_tokens: int, max_pages: int):
        if page_tokens < 1:
            raise ValueError(f"page_tokens {page_tokens} < 1")
        if max_pages < 1:
            raise ValueError(f"max_pages {max_pages} < 1")
        self.page_tokens = page_tokens
        self.max_pages = max_pages
        self._pages: dict[int, _Page] = {}
        self._next_id = 0
        self.allocs = 0
        self.frees = 0
        self.cow_copies = 0
        self.high_water = 0

    def __len__(self) -> int:
        return len(self._pages)

    @property
    def free(self) -> int:
        return self.max_pages - len(self._pages)

    def alloc(self, payload: object = None) -> int:
        if len(self._pages) >= self.max_pages:
            raise PoolExhausted(
                f"page pool at capacity ({self.max_pages} pages)")
        pid = self._next_id
        self._next_id += 1
        self._pages[pid] = _Page(refs=1, payload=payload)
        self.allocs += 1
        self.high_water = max(self.high_water, len(self._pages))
        return pid

    def retain(self, pid: int) -> None:
        self._pages[pid].refs += 1

    def release(self, pid: int) -> bool:
        """Drop one reference; True when this freed the page."""
        page = self._pages[pid]
        page.refs -= 1
        if page.refs < 0:
            raise ValueError(f"page {pid} over-released")
        if page.refs == 0:
            del self._pages[pid]
            self.frees += 1
            return True
        return False

    def refcount(self, pid: int) -> int:
        return self._pages[pid].refs

    def payload(self, pid: int) -> object:
        return self._pages[pid].payload

    def set_payload(self, pid: int, payload: object) -> None:
        self._pages[pid].payload = payload

    def stats(self) -> dict:
        return {
            "page_tokens": self.page_tokens,
            "max_pages": self.max_pages,
            "in_use": len(self._pages),
            "free": self.free,
            "allocs": self.allocs,
            "frees": self.frees,
            "cow_copies": self.cow_copies,
            "high_water": self.high_water,
        }


class BlockTable:
    """One request's ordered page chain + token cursor.

    The engine gives every in-flight row a table referencing the cached
    pages scattered into its KV row (so eviction can never free a page a
    live row still depends on) and releases it at retirement.  ``fork``
    and copy-on-write ``append_tokens`` implement shared-prefix suffix
    extension: fork shares every page; writing *through* a shared partial
    tail page copies it first."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.pages: list[int] = []
        self.tokens = 0               # cursor: tokens covered so far

    def __len__(self) -> int:
        return self.tokens

    def append_page(self, pid: int, *, retain: bool = True,
                    tokens: Optional[int] = None) -> None:
        """Link an existing (e.g. cached) page; ``tokens`` defaults to a
        full page and must only be short for the final page."""
        if self.tokens % self.pool.page_tokens:
            raise ValueError("cannot link a page after a partial page")
        if retain:
            self.pool.retain(pid)
        self.pages.append(pid)
        self.tokens += (self.pool.page_tokens if tokens is None
                        else tokens)

    def append_tokens(self, n: int,
                      copy_payload: Callable = lambda p: p) -> list[int]:
        """Advance the cursor by ``n`` tokens, allocating pages as needed.
        Writing into a *shared* partially filled tail page copies it
        first (copy-on-write) so sibling tables are never mutated.
        Returns the page ids whose contents the caller must (re)write."""
        p = self.pool.page_tokens
        touched: list[int] = []
        while n > 0:
            fill = self.tokens % p
            if fill == 0:
                self.pages.append(self.pool.alloc())
                touched.append(self.pages[-1])
            else:
                tail = self.pages[-1]
                if self.pool.refcount(tail) > 1:
                    # copy-on-write: private copy of the shared tail
                    new = self.pool.alloc(copy_payload(
                        self.pool.payload(tail)))
                    self.pool.release(tail)
                    self.pages[-1] = new
                    self.pool.cow_copies += 1
                if self.pages[-1] not in touched:
                    touched.append(self.pages[-1])
            step = min(n, p - (self.tokens % p))
            self.tokens += step
            n -= step
        return touched

    def fork(self) -> "BlockTable":
        """Share every page with a new table (ref-count bumps only)."""
        child = BlockTable(self.pool)
        child.pages = list(self.pages)
        child.tokens = self.tokens
        for pid in child.pages:
            self.pool.retain(pid)
        return child

    def release(self) -> None:
        for pid in self.pages:
            self.pool.release(pid)
        self.pages, self.tokens = [], 0


class PagedPrefixCache:
    """LRU map ``digest -> page id`` with chain lookup and hit/miss
    accounting uniform with the scheduler's counters.

    Entries are insertion-ordered (LRU); each digest owns one pool
    reference on its page.  ``match`` walks a prompt's digest chain and
    returns the longest cached run of full pages; ``insert`` adds the
    missing tail of a chain, evicting least-recently-used digests when
    the pool is at capacity (pages still referenced by in-flight block
    tables survive until those release)."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._entries: dict[bytes, int] = {}      # digest -> pid (LRU)
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.insert_skips = 0

    def __len__(self) -> int:
        return len(self._entries)

    # -- lookup -----------------------------------------------------------

    def chain(self, digests: list[bytes]) -> list[int]:
        """Page ids for the longest cached leading run of ``digests``
        (recency-neutral — counters belong to committed decisions)."""
        pids = []
        for d in digests:
            pid = self._entries.get(d)
            if pid is None:
                break
            pids.append(pid)
        return pids

    def covers(self, digests: list[bytes]) -> bool:
        return len(self.chain(digests)) == len(digests)

    def lookup(self, digests: list[bytes]) -> list[int]:
        """Committed chain lookup: refreshes LRU recency of every page
        in the returned run."""
        pids = self.chain(digests)
        for d in digests[:len(pids)]:
            self._entries[d] = self._entries.pop(d)     # LRU bump
        return pids

    # -- insertion --------------------------------------------------------

    def insert_chain(self, digests: list[bytes],
                     make_payload: Callable[[int], object]) -> int:
        """Ensure every digest of the chain is cached; build payloads for
        the missing ones via ``make_payload(page_index)``.  Returns the
        number of NEW pages inserted (0 → chain already resident)."""
        new = 0
        for i, d in enumerate(digests):
            if d in self._entries:
                self._entries[d] = self._entries.pop(d)  # LRU bump
                continue
            pid = self._alloc_evicting()
            if pid is None:
                self.insert_skips += 1
                break                 # later pages depend on earlier ones
            self.pool.set_payload(pid, make_payload(i))
            self._entries[d] = pid
            new += 1
        if new:
            self.inserts += 1
        return new

    def _alloc_evicting(self) -> Optional[int]:
        """Allocate a page, LRU-evicting cache entries as needed; None if
        the pool stays exhausted (every page pinned by in-flight rows)."""
        while True:
            try:
                return self.pool.alloc()
            except PoolExhausted:
                if not self._entries:
                    return None
                lru = next(iter(self._entries))
                self.pool.release(self._entries.pop(lru))
                self.evictions += 1
                # released page may still be pinned by an in-flight row:
                # keep evicting until an alloc succeeds or nothing's left

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "insert_skips": self.insert_skips,
            "hit_rate": self.hits / total if total else 0.0,
            "pages": self.pool.stats(),
        }
