"""Content-addressed prefix cache over the paged KV pool (ROADMAP item 3).

Chat and agent traffic re-prefills the same system prompts and RAG templates
thousands of times, and prefill energy scales directly with processed prompt
tokens (Maliakel et al., PAPERS.md) — so the complementary lever to GreenLLM's
frequency scaling is simply *not recomputing* shared prefixes.  This module
is the vLLM-style realization over ``serving.pager``:

* **Content addressing** — the unit of sharing is one *page-aligned* chunk of
  prompt token ids.  Entry ``i`` of a prompt is keyed by a digest chain
  ``d_i = H(d_{i-1} || tokens[i*ps:(i+1)*ps])`` (H = blake2b-128), so a page
  is reachable only through its exact ancestry: two prompts share entries for
  precisely their common page-aligned prefix, and a one-token divergence
  changes every digest from that page on.
* **Refcounted pages, zero-copy hits** — an entry's payload is a physical
  page in the existing ``PageAllocator`` pool, gripped via
  ``PageAllocator.retain`` so it survives the producing stream's retirement.
  A hit seeds the new stream's chain with the cached pages through
  ``share_chain`` (incref, no data movement) and chunked prefill starts at
  the matched position; the K/V *bits* are the original stream's, which is
  exactly what makes hit == miss token-identical at f32.
* **Copy-on-write on divergence** — a stream that must write into a shared
  page (the fully-covered-prompt case: its first real prefill token rewrites
  the last matched page's final position) gets a private copy first
  (``cow_page`` + a device page copy); everything past the shared prefix
  lands in freshly-allocated private pages, so cached pages are immutable
  once registered.
* **LRU eviction over unreferenced leaves only** — ``reclaim`` (called by the
  engine when the free list runs dry, *before* preempting a live stream)
  evicts least-recently-used entries that no stream chain references and
  that no longer entry extends; a cached prefix can therefore never yank a
  page out from under a live chain, and interior entries never orphan their
  descendants.

Only fully-paged models participate (every attention stage a paged pool:
dense / GQA / kv_quant full-attention layouts).  Hybrid models with ring or
recurrent (SSM / RG-LRU) row state carry per-position state outside the page
pool, so their lookups report misses and their pages are never registered —
correctness by construction, caching win deferred.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .pager import PageAllocator


class _Entry:
    __slots__ = ("digest", "parent", "page", "children", "stamp")

    def __init__(self, digest: bytes, parent: Optional[bytes], page: int,
                 stamp: int):
        self.digest = digest
        self.parent = parent
        self.page = page
        self.children = 0       # entries extending this one (evict leaves only)
        self.stamp = stamp      # LRU clock at last touch


def _digest(parent: Optional[bytes], page_tokens: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    if parent is not None:
        h.update(parent)
    h.update(np.ascontiguousarray(page_tokens, np.int32).tobytes())
    return h.digest()


class PrefixCache:
    """Digest-chained map of page-aligned prompt chunks to retained pages.

    ``max_pages`` bounds the number of retained pages (0 = bounded only by
    pool pressure: the engine calls ``reclaim`` when allocation fails).
    Counters (hits / misses / evictions / tokens served from cache) feed the
    ``greenllm_prefix_cache_*`` metrics.
    """

    def __init__(self, pager: PageAllocator, max_pages: int = 0):
        self.pager = pager
        self.max_pages = max_pages
        self.entries: Dict[bytes, _Entry] = {}
        self.hits = 0           # lookups that matched >= 1 page
        self.misses = 0         # lookups that matched nothing
        self.evictions = 0      # entries dropped by reclaim()
        self.hit_tokens = 0     # prompt tokens served from cache (all hits)
        self._clock = 0         # LRU stamp source (monotone, not vtime)

    def __len__(self) -> int:
        return len(self.entries)

    # -- read side -------------------------------------------------------------
    def _walk(self, tokens: np.ndarray) -> List[_Entry]:
        """Longest chain of cached entries covering full pages of
        ``tokens``; stops at the first unknown digest."""
        ps = self.pager.page_size
        out: List[_Entry] = []
        parent: Optional[bytes] = None
        i = 0
        while (i + 1) * ps <= len(tokens):
            d = _digest(parent, tokens[i * ps:(i + 1) * ps])
            e = self.entries.get(d)
            if e is None:
                break
            out.append(e)
            parent = d
            i += 1
        return out

    def probe(self, tokens: np.ndarray) -> int:
        """Matched-prefix length in tokens, counters and LRU untouched —
        the pure query ``busy_time`` accounting and routing use.  Capped at
        ``len(tokens) - 1``: at least one token must be genuinely prefilled
        so the first-token logits exist."""
        if not self.entries or len(tokens) < 2:
            return 0
        n = len(self._walk(np.asarray(tokens, np.int32)))
        return min(n * self.pager.page_size, len(tokens) - 1)

    def lookup(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Admission-time match: returns (cached physical pages, matched
        tokens) and bumps hit/miss counters + LRU stamps.  The token count
        is capped at ``len(tokens) - 1`` (see ``probe``); when the cap bites
        — a page-aligned prompt fully covered by the cache — the *last*
        matched page must be copied-on-write by the caller, because the
        one remaining prefill token rewrites that page's final position."""
        tokens = np.asarray(tokens, np.int32)
        chain = self._walk(tokens) if len(tokens) >= 2 else []
        matched = min(len(chain) * self.pager.page_size, len(tokens) - 1) \
            if chain else 0
        n_pages = -(-matched // self.pager.page_size)
        chain = chain[:n_pages]
        if matched:
            self.hits += 1
            self.hit_tokens += matched
            self._clock += 1
            for e in chain:
                e.stamp = self._clock
        else:
            self.misses += 1
        return [e.page for e in chain], matched

    # -- write side ------------------------------------------------------------
    def register(self, tokens: np.ndarray, chain: List[int],
                 upto: int) -> int:
        """Insert the fully-written pages of a (partial) prompt: page ``i``
        of ``chain`` is registered iff ``(i+1)*ps <= upto`` (both the token
        content *and* the K/V contents of the page are complete).  Existing
        digests are touched, not replaced — first writer wins, so a page is
        retained at most once.  Returns the number of new entries."""
        ps = self.pager.page_size
        tokens = np.asarray(tokens, np.int32)
        limit = min(upto, len(tokens))
        parent: Optional[bytes] = None
        added = 0
        self._clock += 1
        for i in range(limit // ps):
            if i >= len(chain):
                break
            d = _digest(parent, tokens[i * ps:(i + 1) * ps])
            e = self.entries.get(d)
            if e is None:
                if self.max_pages and \
                        self.pager.pages_retained >= self.max_pages and \
                        not self.reclaim(1):
                    break       # at capacity and nothing evictable: stop
                self.pager.retain(chain[i])
                e = _Entry(d, parent, chain[i], self._clock)
                self.entries[d] = e
                if parent is not None:
                    self.entries[parent].children += 1
                added += 1
            else:
                e.stamp = self._clock
            parent = d
        return added

    # -- eviction --------------------------------------------------------------
    def _evictable(self, e: _Entry) -> bool:
        """Leaves of the digest tree that no live stream chain shares:
        eviction may only drop pages whose sole holder is the cache."""
        return e.children == 0 and self.pager.stream_refs(e.page) == 0

    def reclaim(self, n_pages: int) -> int:
        """Evict up to ``n_pages`` LRU evictable entries, freeing their
        pages back to the pool.  Called by the engine when ``ensure`` /
        admission fails before it reaches for preemption — cached prefixes
        are strictly less valuable than live work.  Returns pages freed."""
        freed = 0
        while freed < n_pages:
            victim = None
            for e in self.entries.values():
                if self._evictable(e) and \
                        (victim is None or e.stamp < victim.stamp):
                    victim = e
            if victim is None:
                break
            self._drop(victim)
            freed += 1
        return freed

    def _drop(self, e: _Entry) -> None:
        del self.entries[e.digest]
        if e.parent is not None:
            parent = self.entries.get(e.parent)
            if parent is not None:
                parent.children -= 1
        self.pager.release(e.page)
        self.evictions += 1

    def clear(self) -> int:
        """Release every entry (leaves first).  Returns entries dropped —
        after this the pool owes nothing to the cache, which is what the
        leak tests assert against."""
        dropped = 0
        while self.entries:
            leaves = [e for e in self.entries.values() if e.children == 0]
            assert leaves, "digest tree cycle (impossible by construction)"
            for e in leaves:
                self._drop(e)
                dropped += 1
        return dropped

    # -- telemetry -------------------------------------------------------------
    def shared_pages(self) -> int:
        """Cached pages currently also held by >= 1 live stream chain (the
        ``greenllm_prefix_cache_shared_pages`` gauge)."""
        return sum(1 for e in self.entries.values()
                   if self.pager.stream_refs(e.page) > 0)

    def stats(self) -> Dict:
        total = self.hits + self.misses
        return {
            "entries": len(self.entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_tokens": self.hit_tokens,
            "hit_rate": self.hits / total if total else 0.0,
            "shared_pages": self.shared_pages(),
        }
