"""Paged KV-cache subsystem: block allocator + device-side page table (copy
of ``src/repro/serving/pager.py``; only the device upload differs: a torch
tensor instead of a jnp array, and no mesh sharding).

vLLM-style paging for the slot-native serving engine: every full-length
attention buffer (the ``max_len`` K/V rows that gate concurrent-stream
capacity) is replaced by a shared pool of fixed-size pages, and each stream
holds a *chain* of pages covering exactly its live context.  Capacity is then
bounded by total tokens in flight, not ``max_batch x max_len``, which is the
phase-aware capacity lever GreenLLM's decode controller needs (decode is
memory-bound; energy/token falls with batch size at fixed frequency).

Split of responsibilities:

* **Host-side policy** (this module): a free-list allocator with per-stream
  page chains — alloc on admit, incremental grow at decode-block boundaries,
  free at retire.  All decisions happen at admission/block granularity, so the
  engine's no-per-token-host-sync invariant is preserved.
* **Device-side mechanism**: a ``(max_streams, max_pages_per_stream)`` int32
  page table mapping (slot, logical page) -> physical page id.  The jitted
  decode/prefill kernels receive a ctx-bucketed slice of this table and
  gather/scatter K/V by physical page; the table is re-uploaded only when the
  host allocator mutates it (admit / grow / retire — never per token).

Page 0 is a reserved scratch page: freed streams' table rows point at it, so
the (held) writes of inactive batch rows inside a decode block land in scratch
instead of corrupting pages that may have been reallocated to other streams.
Reads from scratch are position-masked exactly like unwritten dense slots.

**Refcounted sharing** (serving.prefix_cache): a physical page may be held by
several stream chains at once (a shared prompt prefix) and/or retained by the
prefix cache itself.  ``ref[p]`` counts the holders — one per chain containing
``p`` plus one if the cache retains it — and a page returns to the free list
only when the count reaches zero.  ``share_chain`` seeds a fresh chain from
existing pages (incref, no data movement), ``cow_page`` gives one chain a
private copy of a shared page before its first write (copy-on-write on
divergence; the *contents* are copied by the caller on device), and
``retain``/``release`` are the cache's grip.  All existing call sites see the
old exclusive-ownership behavior unchanged: without sharing every ref is 1
and ``free_chain`` frees eagerly, exactly as before.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

SCRATCH_PAGE = 0


class PageAllocator:
    """Free-list page allocator with per-stream chains and a host-shadowed
    device page table.

    Invariants (property-tested in tests/test_paging.py and, under sharing,
    tests/test_prefix_cache.py):
    * a physical page is either on the free list (ref 0) or held (ref ==
      #chains containing it + 1 if cache-retained); double frees raise;
    * ``pages_used + pages_free == num_pages - 1`` (scratch excluded), where
      ``pages_used`` counts *distinct* held pages — a page shared by N
      streams is one page, not N;
    * chains grow monotonically between ``free_chain`` calls and drop every
      reference at retire (pages with no other holder return to the pool);
    * table rows of unallocated logical pages (and of freed streams) point at
      ``SCRATCH_PAGE``.
    """

    def __init__(self, num_pages: int, page_size: int, max_streams: int,
                 max_pages_per_stream: int):
        assert num_pages >= 2, "need at least scratch + one usable page"
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_stream = max_pages_per_stream
        # LIFO free list: recently-freed pages are reused first (locality)
        self._free: List[int] = list(range(num_pages - 1, SCRATCH_PAGE, -1))
        self._free_set = set(self._free)
        self.chains: Dict[int, List[int]] = {}
        self._reserved: List[int] = []   # withheld by reserve() (fault inj.)
        # holder counts: chains containing the page + 1 if cache-retained;
        # 0 <=> on the free list (scratch excluded from both)
        self.ref = np.zeros(num_pages, np.int32)
        self._retained = set()           # pages gripped by the prefix cache
        self.peak_used = 0               # run peak, monotone (telemetry)
        self.table = np.full((max_streams, max_pages_per_stream),
                             SCRATCH_PAGE, np.int32)
        self._dev = None          # cached device copy, refreshed when dirty
        self._dirty = True
        # optional placement applied at upload (mesh serving stores the
        # table's rows along the data axis); None -> the plain tensor
        self.place = None

    # -- capacity queries -----------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page_size)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def can_admit(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= len(self._free)

    # -- pressure injection (serving.faults) ----------------------------------
    def reserve(self, n_pages: int) -> int:
        """Withhold up to ``n_pages`` free pages from the pool (a simulated
        external pressure spike: co-tenant allocation, fragmentation burst).
        Returns the number actually withheld — never more than the free
        list holds, so live chains are untouched.  Reserved pages count as
        used (``pages_used`` is derived from the free list), preserving the
        ``pages_used + pages_free == num_pages - 1`` invariant; the engine
        responds with its normal pressure ladder (shrink blocks, preempt
        youngest, gate admission)."""
        take = min(max(n_pages, 0), len(self._free))
        for _ in range(take):
            page = self._free.pop()
            self._free_set.discard(page)
            self._reserved.append(page)
        if take:
            self.peak_used = max(self.peak_used, self.pages_used)
        return take

    def release_reserved(self) -> int:
        """Return every reserved page to the free list (pressure spike
        over).  Returns the number released."""
        n = len(self._reserved)
        while self._reserved:
            page = self._reserved.pop()
            self._free.append(page)
            self._free_set.add(page)
        return n

    @property
    def pages_reserved(self) -> int:
        return len(self._reserved)

    # -- alloc / grow / free --------------------------------------------------
    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s chain to cover ``n_tokens``; all-or-nothing.

        Returns False (allocating nothing) if the free list can't cover the
        growth — the caller shrinks its decode block or preempts a stream.
        """
        chain = self.chains.setdefault(slot, [])
        need = self.pages_for(n_tokens) - len(chain)
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        if len(chain) + need > self.max_pages_per_stream:
            raise ValueError(
                f"stream {slot} needs {len(chain) + need} pages "
                f"> max_pages_per_stream={self.max_pages_per_stream}")
        for _ in range(need):
            page = self._free.pop()
            self._free_set.discard(page)
            self.ref[page] = 1
            self.table[slot, len(chain)] = page
            chain.append(page)
        self.peak_used = max(self.peak_used, self.pages_used)
        self._dirty = True
        return True

    def _drop_ref(self, page: int, who: str) -> None:
        """Release one holder's reference; the page returns to the free list
        only when nobody — chain or cache — holds it anymore."""
        if page in self._free_set or page == SCRATCH_PAGE \
                or self.ref[page] <= 0:
            raise ValueError(f"double free of page {page} ({who})")
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self._free.append(page)
            self._free_set.add(page)

    def free_chain(self, slot: int) -> int:
        """Drop ``slot``'s reference on every page of its chain (pages with
        no other holder return to the free list) and point the table row
        back at scratch.  Returns the chain length released."""
        chain = self.chains.pop(slot, [])
        for page in chain:
            self._drop_ref(page, f"slot {slot}")
        if chain:
            self.table[slot, :] = SCRATCH_PAGE
            self._dirty = True
        return len(chain)

    # -- prefix sharing (serving.prefix_cache) --------------------------------
    def share_chain(self, slot: int, pages: List[int]) -> None:
        """Seed ``slot``'s (empty) chain with existing live pages — no data
        moves, each page just gains a reference.  This is how a prefix-cache
        hit adopts the cached pages of a shared prompt."""
        if self.chains.get(slot):
            raise ValueError(f"slot {slot} already holds a chain; "
                             "free it before sharing into it")
        if len(pages) > self.max_pages_per_stream:
            raise ValueError(
                f"shared prefix of {len(pages)} pages "
                f"> max_pages_per_stream={self.max_pages_per_stream}")
        chain = []
        for i, page in enumerate(pages):
            if page == SCRATCH_PAGE or page in self._free_set \
                    or self.ref[page] <= 0:
                raise ValueError(f"cannot share dead page {page}")
            self.ref[page] += 1
            self.table[slot, i] = page
            chain.append(page)
        self.chains[slot] = chain
        if chain:
            self._dirty = True

    def cow_page(self, slot: int, logical: int) -> Optional[int]:
        """Copy-on-write: give ``slot`` a private copy of logical page
        ``logical`` before its first write into it.  Exclusively-held pages
        are already private (returned as-is); shared ones are swapped for a
        fresh page (or None — changing nothing — if the pool is dry).  The
        caller must copy the page *contents* on device (e.g.
        ``kvcache.paged_page_copy``) when the returned id differs."""
        chain = self.chains[slot]
        page = chain[logical]
        if self.ref[page] == 1:
            return page
        if not self._free:
            return None
        new = self._free.pop()
        self._free_set.discard(new)
        self.ref[new] = 1
        self.ref[page] -= 1       # >= 1 left: another chain or the cache
        chain[logical] = new
        self.table[slot, logical] = new
        self.peak_used = max(self.peak_used, self.pages_used)
        self._dirty = True
        return new

    def retain(self, page: int) -> None:
        """The prefix cache grips ``page``: it survives ``free_chain`` until
        ``release``d, keeping its contents addressable for future hits."""
        if page == SCRATCH_PAGE or page in self._free_set \
                or self.ref[page] <= 0:
            raise ValueError(f"cannot retain dead page {page}")
        if page in self._retained:
            raise ValueError(f"page {page} already retained")
        self.ref[page] += 1
        self._retained.add(page)

    def release(self, page: int) -> None:
        """Drop the cache's grip on ``page`` (eviction); the page frees now
        if no chain still holds it, or when the last chain retires."""
        if page not in self._retained:
            raise ValueError(f"page {page} is not retained")
        self._retained.discard(page)
        self._drop_ref(page, "cache")

    def stream_refs(self, page: int) -> int:
        """How many stream chains hold ``page`` (cache grip excluded)."""
        return int(self.ref[page]) - (1 if page in self._retained else 0)

    @property
    def pages_retained(self) -> int:
        return len(self._retained)

    # -- migration (replica-to-replica paged-KV handoff) ----------------------
    def export_chain(self, slot: int) -> List[int]:
        """Release ``slot``'s chain for migration: returns the physical page
        ids (in logical order) and hands them back to the free list, pointing
        the table row at scratch.

        The caller must have copied the pages' *contents* out (e.g. via
        ``kvcache.paged_chain_extract``) before calling — after this returns,
        the pages may be reallocated to other streams at the next ``ensure``.
        """
        chain = list(self.chains.get(slot, []))
        self.free_chain(slot)
        return chain

    def adopt_chain(self, slot: int, n_pages: int) -> Optional[List[int]]:
        """Allocate a fresh chain of exactly ``n_pages`` for an imported
        stream and return the physical ids (scatter targets for
        ``kvcache.paged_chain_insert``), or None — allocating nothing — if the
        free list cannot cover it.  ``slot`` must not already hold a chain:
        adoption is the first act of an imported stream's life on this pool.
        """
        if self.chains.get(slot):
            raise ValueError(f"slot {slot} already holds a chain; "
                             "free it before adopting")
        if not self.ensure(slot, n_pages * self.page_size):
            return None
        return list(self.chains[slot])

    # -- device table ---------------------------------------------------------
    def table_device(self, device):
        """torch copy of the table on ``device``; re-uploaded only after host
        mutations.  On a GPU the upload goes through pinned memory without
        blocking the host (no drain of the work already queued).  With
        ``place`` set, the copy is stored through it."""
        if self._dirty or self._dev is None:
            host = torch.from_numpy(self.table.copy())
            if device.type == "cuda":
                host = host.pin_memory()
            self._dev = host.to(device, non_blocking=True)
            if self.place is not None:
                self._dev = self.place(self._dev)
            self._dirty = False
        return self._dev

    # -- telemetry ------------------------------------------------------------
    def occupancy(self, live_tokens: Optional[Dict[int, int]] = None) -> Dict:
        """Pool pressure for ``stats()``/telemetry: later energy PRs feed
        ``occupancy`` to the controller as a memory-pressure input.

        Reserved, shared, and cache-retained pages are counted *distinctly*:
        ``pages_used`` is derived from the free list, so a page shared by N
        streams contributes one page, and ``pages_shared`` /
        ``pages_reserved`` / ``pages_cached`` break the total down without
        double-counting.  ``occupancy_live`` excludes pages only the prefix
        cache holds (evictable on demand) — the decode controller's
        ``occ_high`` bias reads this so a warm cache is not mistaken for
        pool pressure.

        ``fragmentation`` is internal (last-page slack): 1 - live tokens /
        token slots held, over *distinct* held pages — a shared page's
        utilization is the max coverage over its sharers.  There is no
        external fragmentation — pages are uniform — so this is the only
        capacity lost to the page granularity.
        """
        usable = self.num_pages - 1
        used = self.pages_used
        counts: Dict[int, int] = {}
        for chain in self.chains.values():
            for p in chain:
                counts[p] = counts.get(p, 0) + 1
        shared = sum(1 for n in counts.values() if n > 1)
        # pages only the cache holds (no chain): freeable by eviction
        evictable = sum(1 for p in self._retained if p not in counts)
        frag = 0.0
        if live_tokens is not None and used:
            ps = self.page_size
            cover: Dict[int, int] = {}
            for s, live in live_tokens.items():
                for i, p in enumerate(self.chains.get(s, [])):
                    c = min(max(live - i * ps, 0), ps)
                    cover[p] = max(cover.get(p, 0), c)
            if cover:
                frag = 1.0 - sum(cover.values()) / (len(cover) * ps)
        return {
            "pages_used": used,
            "pages_total": usable,
            "pages_shared": shared,
            "pages_reserved": len(self._reserved),
            "pages_cached": len(self._retained),
            "pages_evictable": evictable,
            "occupancy": used / usable if usable else 0.0,
            "occupancy_live": (used - evictable) / usable if usable else 0.0,
            "peak_occupancy": self.peak_used / usable if usable else 0.0,
            "fragmentation": frag,
        }
