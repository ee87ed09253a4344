"""Paged KV-cache manager with prefix caching (vLLM-style).

Block-granular allocation; prompt prefixes deriving from a shared template
are content-addressed so repeated templates hit cached blocks instead of
recomputing prefill (the mechanism behind the paper's "High Cache Hit"
prototype and the ``cache_hit_rate`` fingerprint dimension).

Accounting invariant (property-tested):
    num_blocks == free_blocks + sum(seq_blocks.values()) + len(prefix_blocks)
Every resident block is exactly one of: free, owned by a sequence, or a
cache-resident prefix block (shared read-only; refcount counts borrowers).

The hot paths (``lookup_prefix``/``try_allocate``/``register_prefix``) run
once per admission at fleet scale — millions of times per mega-fleet
replay — so they are written dict-local-and-branch-lean: attribute loads
hoisted out of per-block loops, cache statistics accumulated per call
instead of per block, and registration evicting its shortfall in one bulk
LRU sweep (exactly equivalent to per-block eviction: newly registered
blocks always enter at the LRU tail, so the victims of n sequential
single evictions are the same n oldest unreferenced blocks a single bulk
sweep selects).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List

from repro_torch.serving.request import Request

_NO_KEYS: List[int] = []


@dataclasses.dataclass
class CacheStats:
    hits: int = 0          # block-granular prefix-cache hits
    queries: int = 0       # block-granular lookups
    preemptions: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.queries if self.queries else 0.0


class PagedKVCache:
    """Block placement + prefix cache. Simulation-grade: tracks occupancy,
    not tensors — the tensors live in the model cache pytree; this layer
    produces the usage/hit-rate metrics the AGFT fingerprint consumes."""

    def __init__(self, num_blocks: int, block_size: int = 16,
                 enable_prefix_cache: bool = True):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_cache = enable_prefix_cache
        self.free_blocks = num_blocks
        self.seq_blocks: Dict[int, int] = {}             # request_id -> count
        self.seq_borrowed: Dict[int, List[int]] = {}
        self.prefix_blocks: Dict[int, int] = {}          # key -> refcount
        self.prefix_lru: collections.OrderedDict = collections.OrderedDict()
        # cached blocks with refcount 0 — lets the LRU eviction sweep
        # short-circuit when the whole cache is borrowed (the steady state
        # of a saturated long run, where scanning would find nothing)
        self._evictable = 0
        # per-template prefix-key chains, memoised and grown in place: key
        # i of a template's chain is always (template_id << 32) | i — a
        # packed int, so chains build at C speed from range() and hash as
        # small ints — and a shorter request's chain is a prefix slice of
        # the longest one built so far
        self._keys_memo: Dict[int, List[int]] = {}
        self.stats = CacheStats()

    # ------------------------------------------------------------------
    def blocks_needed(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def usage(self) -> float:
        return self.used_blocks / self.num_blocks if self.num_blocks else 0.0

    def check_invariant(self) -> bool:
        return (self.free_blocks + sum(self.seq_blocks.values())
                + len(self.prefix_blocks)) == self.num_blocks

    # ------------------------------------------------------------------
    def _prefix_keys(self, req: Request) -> List[int]:
        """The request's chain, as a shared memo list (callers iterate or
        copy-slice; they never mutate the returned list)."""
        n = int(req.prompt_len * req.template_frac) // self.block_size
        if n <= 0:
            return _NO_KEYS
        tid = req.template_id
        memo = self._keys_memo.get(tid)
        if memo is None:
            base = tid << 32
            memo = list(range(base, base + n))
            self._keys_memo[tid] = memo
            return memo
        ln = len(memo)
        if ln < n:
            base = tid << 32
            memo.extend(range(base + ln, base + n))
            return memo
        if ln == n:
            return memo
        return memo[:n]

    def lookup_prefix(self, req: Request) -> int:
        """Longest cached prefix (tokens); records hit/miss stats."""
        if not self.enable_prefix_cache:
            return 0
        keys = self._prefix_keys(req)
        hits = 0
        pb = self.prefix_blocks
        move = self.prefix_lru.move_to_end
        for key in keys:
            if key in pb:
                hits += 1
                move(key)
            else:
                break                                    # prefixes are chains
        st = self.stats
        st.queries += hits + 1 if hits < len(keys) else hits
        st.hits += hits
        return hits * self.block_size

    def _evict_prefix(self, n: int) -> int:
        """Evict up to n unreferenced cached blocks (LRU order)."""
        want = min(n, self._evictable)
        if want <= 0:
            return 0
        # collect victims with an early-exit scan (no full-LRU snapshot:
        # the head of the order is where unreferenced blocks live, so this
        # stops after O(victims) entries in the common case)
        pb = self.prefix_blocks
        victims: List[int] = []
        for key in self.prefix_lru:
            if pb[key] == 0:
                victims.append(key)
                if len(victims) >= want:
                    break
        lru = self.prefix_lru
        for key in victims:
            del pb[key]
            del lru[key]
        self.free_blocks += len(victims)
        self._evictable -= len(victims)
        return len(victims)

    def try_allocate(self, req: Request, total_tokens: int) -> bool:
        """Reserve capacity for prompt+generation. Cached prefix blocks are
        borrowed (shared); the remainder comes from the free pool, evicting
        idle cached blocks if required. All-or-nothing."""
        cached_tokens = self.lookup_prefix(req)
        shared_blocks = cached_tokens // self.block_size
        need = max(0, self.blocks_needed(total_tokens) - shared_blocks)
        # take references on the matched prefix BEFORE any eviction, so the
        # LRU sweep cannot free the very blocks this request matched on
        borrowed = self._prefix_keys(req)[:shared_blocks]
        pb = self.prefix_blocks
        evictable = self._evictable
        for key in borrowed:
            refs = pb[key]
            if refs == 0:
                evictable -= 1
            pb[key] = refs + 1
        self._evictable = evictable
        if need > self.free_blocks:
            self._evict_prefix(need - self.free_blocks)
        if need > self.free_blocks:
            evictable = self._evictable        # re-read: eviction moved it
            for key in borrowed:                       # rollback
                refs = pb[key] - 1
                pb[key] = refs
                if refs == 0:
                    evictable += 1
            self._evictable = evictable
            return False
        self.free_blocks -= need
        self.seq_blocks[req.request_id] = need
        self.seq_borrowed[req.request_id] = borrowed
        req.cached_tokens = cached_tokens
        return True

    def register_prefix(self, req: Request) -> None:
        """After prefill completes, publish the request's template prefix
        into the cache (copy-on-publish: new cached blocks come from the
        free pool; skipped under pressure). The expected shortfall is
        evicted in one bulk sweep up front; the per-block fallback only
        fires when eviction victims were themselves later links of this
        chain (which the live membership re-check then re-registers)."""
        if not self.enable_prefix_cache:
            return
        pb = self.prefix_blocks
        keys = self._prefix_keys(req)
        n_missing = len(keys) - sum(map(pb.__contains__, keys))
        if not n_missing:
            return
        if n_missing > self.free_blocks:
            self._evict_prefix(n_missing - self.free_blocks)
        lru = self.prefix_lru
        free = self.free_blocks
        for key in keys:
            if key in pb:
                continue
            if free <= 0:
                self.free_blocks = free
                if not self._evict_prefix(1):
                    return                               # no room; skip rest
                free = self.free_blocks
            free -= 1
            pb[key] = 0
            lru[key] = True
            self._evictable += 1
        self.free_blocks = free

    def free(self, req: Request, *, preempted: bool = False) -> None:
        self.free_blocks += self.seq_blocks.pop(req.request_id, 0)
        pb = self.prefix_blocks
        for key in self.seq_borrowed.pop(req.request_id, []):
            refs = pb.get(key)
            if refs is not None and refs > 0:
                pb[key] = refs - 1
                if refs == 1:
                    self._evictable += 1
        if preempted:
            self.stats.preemptions += 1
