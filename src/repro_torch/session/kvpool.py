"""Block-paged KV-cache pool with copy-on-write prefix sharing: a copy of
``repro.session.kvpool`` (host-side numpy; ``TRASH_PAGE`` and ``_HASH_SEED``
unchanged, so page hashes and hit counts agree with the reference's).

The fixed-slot scheduler strands memory two ways: a 32-token reply in a
4k-token slot wastes the slot's tail, and identical system prompts are
re-prefilled (and re-stored) per request.  This module is the vLLM-style
answer, host-side only — device pool arrays and page copies stay in the
scheduler/session:

``PagePool``
    Free-list allocator over ``n_pages`` physical pages of ``page_size``
    tokens each, with per-page refcounts.  Page 0 is the reserved TRASH
    page: unmapped page-table rows clamp their writes to it and it is never
    allocated or read unmasked.

``PrefixCache``
    Prompt-token-hash keyed page reuse.  Full pages are keyed by CHAINED
    hashes (hash i covers tokens[:(i+1)*page_size], so a lookup walks
    matches left to right); a prompt tail that ends mid-page is kept as a
    (parent-hash, tail-tokens) entry so longer prompts sharing it adopt the
    partially-filled page too.  Every published page carries one cache-owned
    refcount; eviction is LRU and only ever drops the cache's own
    references — pages pinned by live requests survive, they just stop
    being discoverable.

``PagedKVManager``
    Per-slot page tables over a pool + prefix cache: admission maps the
    longest cached prefix copy-on-write, ``ensure_writable`` is the single
    COW boundary every device write crosses (allocate past the end, copy a
    page whose refcount exceeds one), retire releases the row.

Token j of logical page i sits at absolute position ``i*page_size + j`` —
positions are implicit in the table, there is no per-token ``pos`` array.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

TRASH_PAGE = 0
_HASH_SEED = b"repro-kvpool-v1"


class PagePool:
    """Host-side free-list allocator with refcounted pages."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: deque = deque(range(1, n_pages))
        self._rc = np.zeros(n_pages, np.int32)
        self._rc[TRASH_PAGE] = 1          # never allocated, never freed

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - 1 - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._rc[page])

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV page pool exhausted: need {n} pages, "
                f"{len(self._free)} free of {self.n_pages - 1}")
        pages = [self._free.popleft() for _ in range(n)]
        self._rc[pages] = 1
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == TRASH_PAGE or self._rc[p] < 1:
                raise ValueError(f"retain of unallocated page {p}")
            self._rc[p] += 1

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages that hit zero
        (back on the free list)."""
        freed = []
        for p in pages:
            if p == TRASH_PAGE or self._rc[p] < 1:
                raise ValueError(f"release of unallocated page {p}")
            self._rc[p] -= 1
            if self._rc[p] == 0:
                self._free.append(p)
                freed.append(int(p))
        return freed


def page_hashes(prompt: np.ndarray, page_size: int) -> List[bytes]:
    """Chained per-page hashes: ``h[i]`` covers ``prompt[:(i+1)*page_size]``
    (each hash folds in its parent, so equal hashes mean equal full
    prefixes, not just equal pages)."""
    out, h = [], _HASH_SEED
    prompt = np.ascontiguousarray(prompt, dtype=np.int32)
    for i in range(len(prompt) // page_size):
        h = hashlib.sha1(
            h + prompt[i * page_size:(i + 1) * page_size].tobytes()).digest()
        out.append(h)
    return out


class PrefixCache:
    """Prompt-hash keyed published pages + partial-tail entries (LRU)."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        # chained full-page hash → physical page, in LRU order
        self._pages: "OrderedDict[bytes, int]" = OrderedDict()
        # parent hash (of the last full page, or the seed) → [(tail, page)]
        self._tails: Dict[bytes, List[Tuple[Tuple[int, ...], int]]] = {}
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0

    def __len__(self) -> int:
        return len(self._pages) + sum(len(v) for v in self._tails.values())

    def lookup(self, prompt: np.ndarray, *, limit: int) -> Tuple[List[int], int]:
        """Longest cached prefix of ``prompt``, capped at ``limit`` tokens
        (callers cap at len(prompt)-1 so first-token logits always have a
        suffix position to come from).  Returns (pages, n_shared_tokens)
        with ONE reference retained on every returned page for the caller.
        A tail entry may be adopted partially — the adopter COWs the page
        before its first write, so over-shared trailing tokens are simply
        overwritten in the copy."""
        ps = self.pool.page_size
        prompt = np.ascontiguousarray(prompt, dtype=np.int32)
        self.lookups += 1
        pages: List[int] = []
        n = 0
        parent = _HASH_SEED
        for h in page_hashes(prompt, ps):
            if n + ps > limit:
                break
            page = self._pages.get(h)
            if page is None:
                break
            pages.append(page)
            self._pages.move_to_end(h)
            n += ps
            parent = h
        rest = prompt[n:]
        best: Optional[Tuple[Tuple[int, ...], int]] = None
        for tail, page in self._tails.get(parent, ()):
            use = min(len(tail), len(rest), limit - n)
            if use > 0 and np.array_equal(rest[:use], tail[:use]) and \
                    (best is None or use > best[0]):
                best = (use, page)
        if best is not None:
            pages.append(best[1])
            n += best[0]
        if n:
            self.pool.retain(pages)
            self.hits += 1
            self.hit_tokens += n
        return pages, n

    def register(self, prompt: np.ndarray, pages: Sequence[int]) -> None:
        """Publish a freshly prefilled prompt's pages (logical order; one
        entry per page the prompt occupies).  First writer wins on hash
        collisions — duplicate content admitted concurrently just keeps the
        earlier pages discoverable.  Newly published pages gain one
        cache-owned reference."""
        ps = self.pool.page_size
        prompt = np.ascontiguousarray(prompt, dtype=np.int32)
        parent = _HASH_SEED
        for i, h in enumerate(page_hashes(prompt, ps)):
            if h not in self._pages:
                self._pages[h] = int(pages[i])
                self.pool.retain([pages[i]])
            self._pages.move_to_end(h)
            parent = h
        tail_len = len(prompt) % ps
        if tail_len:
            tail = tuple(int(t) for t in prompt[len(prompt) - tail_len:])
            entries = self._tails.setdefault(parent, [])
            if not any(t == tail for t, _ in entries):
                entries.append((tail, int(pages[-1])))
                self.pool.retain([pages[-1]])

    def evict(self, n_needed: int) -> int:
        """Drop LRU entries until ``n_needed`` pages are free (or the cache
        is empty).  Evicting a full-page entry also drops the tails chained
        under it (unreachable once the parent is gone).  Returns the number
        of pages actually returned to the free list."""
        freed = 0
        while self.pool.n_free < n_needed and len(self):
            if self._pages:
                h, page = next(iter(self._pages.items()))
                del self._pages[h]
                freed += len(self.pool.release([page]))
                for tail, tpage in self._tails.pop(h, ()):
                    freed += len(self.pool.release([tpage]))
            else:
                parent = next(iter(self._tails))
                entries = self._tails[parent]
                tail, tpage = entries.pop(0)
                if not entries:
                    del self._tails[parent]
                freed += len(self.pool.release([tpage]))
        return freed

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class PagedKVManager:
    """Per-slot page tables over a ``PagePool`` (+ optional ``PrefixCache``).

    Pure host bookkeeping: it decides page ids; the owner applies device
    copies through the ``copy_page(src, dst)`` callback (COW) and pushes
    ``tables`` to the device per step."""

    def __init__(self, pool: PagePool, n_slots: int, n_max: int, *,
                 prefix_cache: Optional[PrefixCache] = None,
                 copy_page: Optional[Callable[[int, int], None]] = None):
        self.pool = pool
        self.cache = prefix_cache
        self.n_max = int(n_max)
        self.tables = np.full((n_slots, n_max), -1, np.int32)
        self.n_mapped = np.zeros(n_slots, np.int32)
        self.copy_page = copy_page or (lambda src, dst: None)

    # ------------------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` pages, evicting prefix-cache entries (LRU) under
        pool pressure.  Raises ``MemoryError`` when even a drained cache
        cannot cover it."""
        try:
            return self.pool.alloc(n)
        except MemoryError:
            if self.cache is None:
                raise
            self.cache.evict(n)
            return self.pool.alloc(n)

    def admit(self, slot: int, prompt: np.ndarray, *,
              share: bool = True) -> int:
        """Map pages for ``prompt`` into ``slot``: the longest cached prefix
        is shared (a partially-filled boundary page is COW-copied up front —
        the suffix prefill writes into it), fresh pages cover the rest.
        Returns the number of shared history tokens (the prefill skips
        them).  On ``MemoryError`` the slot is left empty."""
        if self.n_mapped[slot]:
            raise ValueError(f"slot {slot} still holds pages")
        prompt = np.ascontiguousarray(prompt, dtype=np.int32)
        Lp = len(prompt)
        ps = self.pool.page_size
        if share and self.cache is not None:
            pages, hist = self.cache.lookup(prompt, limit=Lp - 1)
        else:
            pages, hist = [], 0
        row = list(pages)
        try:
            if hist % ps:
                # suffix prefill writes position `hist`, mid-way into the
                # shared boundary page — copy it before anyone writes
                dst = self._cow(row[-1])
                if dst is not None:
                    row[-1] = dst
            need = -(-Lp // ps) - len(row)
            row += self.alloc(need)
        except MemoryError:
            self.pool.release(row)     # undo the lookup's retains
            raise
        self.tables[slot, :len(row)] = row
        self.n_mapped[slot] = len(row)
        return hist

    def register(self, slot: int, prompt: np.ndarray) -> None:
        """Publish ``slot``'s freshly prefilled prompt pages to the prefix
        cache (no-op without one)."""
        if self.cache is None:
            return
        prompt = np.ascontiguousarray(prompt, dtype=np.int32)
        n = -(-len(prompt) // self.pool.page_size)
        self.cache.register(prompt, [int(p) for p in self.tables[slot, :n]])

    def _cow(self, src: int) -> Optional[int]:
        """Copy ``src`` into a fresh exclusively-owned page (the caller holds
        one reference on ``src``, which moves to the copy).  Returns the new
        page, or None when a full pool resolved itself: the eviction inside
        ``alloc`` may drop the CACHE's reference on ``src`` instead of
        freeing anything — the caller then owns ``src`` outright and no copy
        is needed."""
        try:
            [dst] = self.alloc(1)
        except MemoryError:
            if self.pool.refcount(src) == 1:
                return None
            raise
        self.copy_page(src, dst)
        self.pool.release([src])
        return dst

    def ensure_writable(self, slot: int, pos: int) -> None:
        """Guarantee the page position ``pos`` lands in is mapped and
        exclusively owned: allocate one page past the end, COW-copy a page
        whose refcount exceeds one (shared via the prefix cache — including
        this slot's OWN registered tail page, which must stay pristine for
        future lookups)."""
        ps = self.pool.page_size
        ip = pos // ps
        if ip >= self.n_mapped[slot]:
            if ip != self.n_mapped[slot]:
                raise ValueError(
                    f"slot {slot}: write at page {ip} skips unmapped pages "
                    f"(have {int(self.n_mapped[slot])})")
            [page] = self.alloc(1)
            self.tables[slot, ip] = page
            self.n_mapped[slot] += 1
            return
        page = int(self.tables[slot, ip])
        if self.pool.refcount(page) > 1:
            dst = self._cow(page)
            if dst is not None:
                self.tables[slot, ip] = dst

    def free_slot(self, slot: int) -> None:
        """Release every page the slot maps (shared pages just drop one
        reference) and clear its table row."""
        n = int(self.n_mapped[slot])
        self.pool.release([int(p) for p in self.tables[slot, :n]])
        self.tables[slot, :] = -1
        self.n_mapped[slot] = 0

    def capacity_tokens(self, slot: int) -> int:
        return int(self.n_mapped[slot]) * self.pool.page_size
