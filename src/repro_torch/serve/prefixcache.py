"""Radix-tree prompt-prefix cache over the paged KV pool.

The single largest source of redundant GEMM work in serving is
re-prefilling shared prompt prefixes — system prompts, few-shot headers —
that every request repeats. Prefill is the compute-bound phase (the
paper's balance analysis: decode starves on memory, prefill on FLOPs), so
skipping it for tokens whose K/V already sit in the pool is a pure win,
and the block-table cache is exactly the substrate that makes the skip
free: sharing a prefix is *mapping the same physical block ids into
another slot's table row*, no copies.

Structure: a trie keyed by whole KV blocks — one node per **full** block
of ``block_size`` token ids, a child edge per distinct next-block token
tuple. Exact-match by construction (nodes store the token tuple itself,
not a hash), rooted per ``cache_salt`` so tenants that must not share
prompts never do.

Lifecycle (with :class:`repro.serve.blockpool.BlockPool` ref-counting):

* **match** (admission): walk the request's prompt down the trie,
  ``incref`` every matched block, and hand the block ids to the scheduler
  — they go straight into the slot's block table and chunked prefill
  starts at the first uncached token. The walk is capped at
  ``prompt_len - 1`` tokens so at least one real token always prefills
  (the engine samples the first output token from that chunk's logits).
* **insert** (retirement): the request's full-block prefixes become trie
  nodes; each newly adopted block is ``mark_cached`` so the ``decref``
  that follows parks it cached-idle (K/V intact) instead of freeing it.
  A prefix already in the trie — from the admission match, or a
  concurrent duplicate prefill — inserts nothing; the duplicate blocks
  just drop to the free list.
* **reclaim** (pressure): ``BlockPool.alloc`` asks the cache to surrender
  cached-idle blocks before reporting OOM. Eviction is least-recently-
  used **leaves first** — a node is evictable only when no live request
  references its block and no child extends it — so the tree never holds
  a prefix whose own prefix is gone.

Shared blocks are read-only by construction: a borrowing request's
prefill starts at ``start = matched_tokens`` (``paged_prefill_attention``
only writes positions ``>= start``) and its decode writes land at
positions ``>= prompt_len``. Partial tail blocks are never inserted or
matched, so no block is ever both shared and still being written.

Correctness bar (asserted by tests/benchmarks): with the cache on, decode
output is token-for-token identical to cache-off for any trace.
"""
from __future__ import annotations

import dataclasses
from typing import Hashable, Iterator

import numpy as np

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve.blockpool import BlockPool

# private namespace key for salt=None: a sentinel, not a value a caller
# could pass (salt="" must be a distinct namespace, not an alias)
_DEFAULT_NS = object()


@dataclasses.dataclass
class TrieNode:
    """One full KV block of a cached prompt prefix."""

    tokens: tuple[int, ...]            # the block's token ids (exact key)
    block: int                         # pool block id holding their K/V
    parent: "TrieNode | None"
    children: dict[tuple[int, ...], "TrieNode"] = dataclasses.field(
        default_factory=dict)
    last_used: int = 0                 # logical clock, for LRU eviction
    depth: int = 0                     # root distance (eviction tie-break:
                                       # deepest first, leaves before parents)


class PrefixCache:
    """Radix index over token-id sequences at KV-block granularity.

    ``max_cached_blocks`` optionally caps how many blocks the trie may
    retain (``--prefix-cache-blocks``); past it, insertion trims the LRU
    evictable leaves. Uncapped, the cache is bounded by the pool itself —
    cached-idle blocks are reclaimed on demand, so caching never refuses
    an admission the uncached pool would have served.
    """

    def __init__(self, pool: BlockPool, *,
                 max_cached_blocks: int | None = None, tracer=None):
        if max_cached_blocks is not None and max_cached_blocks < 0:
            raise ValueError(
                f"max_cached_blocks must be >= 0, got {max_cached_blocks}")
        self.pool = pool
        self.max_cached_blocks = max_cached_blocks
        # reclaim-phase span sink (repro.obs.trace); the engine stamps the
        # current tick on the tracer, so the deep reclaim callback needs
        # no tick plumbing
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._roots: dict[Hashable, TrieNode] = {}
        self._nodes: dict[int, TrieNode] = {}   # block id -> node
        self._clock = 0
        # counters (exported via stats(); metrics schema `prefix_cache`)
        self.lookups = 0
        self.lookup_tokens = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.duplicate_blocks = 0
        self.reclaimed_blocks = 0     # pressure-driven (alloc shortfall)
        self.trimmed_blocks = 0       # cap-driven (max_cached_blocks)
        pool.set_reclaimer(self._reclaim)

    # ------------------------------------------------------------ helpers
    def _root(self, salt: Hashable) -> TrieNode:
        key = _DEFAULT_NS if salt is None else salt
        root = self._roots.get(key)
        if root is None:
            root = self._roots[key] = TrieNode(tokens=(), block=-1,
                                               parent=None)
        return root

    def _block_keys(self, prompt, limit_blocks: int) -> Iterator[tuple]:
        bs = self.pool.block_size
        toks = np.asarray(prompt).reshape(-1)
        for i in range(limit_blocks):
            yield tuple(int(t) for t in toks[i * bs: (i + 1) * bs])

    @property
    def cached_blocks(self) -> int:
        return len(self._nodes)

    # ------------------------------------------------------------ match
    def peek(self, prompt, salt: Hashable = None) -> int:
        """Cached-prefix length of ``prompt`` in tokens, with no side
        effects: no increfs, no counter movement, no LRU touch. The
        prefix-affinity admission policy ranks the queue with this —
        a ranking probe must not pin blocks or skew hit_rate."""
        limit = (int(np.asarray(prompt).size) - 1) // self.pool.block_size
        node = self._root(salt)
        matched = 0
        for key in self._block_keys(prompt, limit):
            child = node.children.get(key)
            if child is None:
                break
            matched += 1
            node = child
        return matched * self.pool.block_size

    def match(self, prompt, salt: Hashable = None) -> list[int]:
        """Longest cached prefix of ``prompt`` (full blocks only, capped so
        >= 1 token is left to prefill). Matched blocks are increfed — the
        caller owns one reference per block and must ``decref`` them at
        retirement (or immediately, if admission falls through)."""
        self.lookups += 1
        self.lookup_tokens += int(np.asarray(prompt).size)
        self._clock += 1
        limit = (int(np.asarray(prompt).size) - 1) // self.pool.block_size
        node = self._root(salt)
        out: list[int] = []
        for key in self._block_keys(prompt, limit):
            child = node.children.get(key)
            if child is None:
                break
            out.append(child.block)
            child.last_used = self._clock
            node = child
        if out:
            self.pool.incref(out)
            self.hits += 1
            self.hit_tokens += len(out) * self.pool.block_size
        return out

    def cancel(self, prompt, blocks: list[int]) -> None:
        """Undo a :meth:`match` whose admission fell through (the scheduler
        deferred the head): drop the caller's references and remove the
        attempt from the lookup/hit counters — a head deferred for k ticks
        re-matches k times, and only the admission that finally succeeds
        may count toward ``hit_rate`` (hit_tokens is defined as prefill
        actually skipped)."""
        self.lookups -= 1
        self.lookup_tokens -= int(np.asarray(prompt).size)
        if blocks:
            self.hits -= 1
            self.hit_tokens -= len(blocks) * self.pool.block_size
            self.pool.decref(blocks)

    # ------------------------------------------------------------ insert
    def insert(self, prompt, blocks: list[int],
               salt: Hashable = None) -> int:
        """Index a retiring request's full-block prefixes.

        ``blocks`` is the request's block list in prompt order (the leading
        entries may be shared blocks from its own admission match).
        Missing trie nodes adopt the request's block (``mark_cached``, so
        the caller's subsequent ``decref`` idles it instead of freeing);
        existing nodes are kept — a concurrently prefilled duplicate block
        is NOT adopted and simply drops to the free list with the decref.
        Returns the number of newly inserted blocks."""
        n_full = int(np.asarray(prompt).size) // self.pool.block_size
        if n_full > len(blocks):
            raise ValueError(
                f"prompt spans {n_full} full blocks but the request owns "
                f"only {len(blocks)}")
        self._clock += 1
        node = self._root(salt)
        inserted = 0
        for i, key in enumerate(self._block_keys(prompt, n_full)):
            child = node.children.get(key)
            if child is None:
                b = blocks[i]
                if b in self._nodes:
                    # one physical block cannot index two prefixes; only
                    # possible through caller misuse (reused block list)
                    raise ValueError(f"block {b} is already in the trie")
                child = TrieNode(tokens=key, block=b, parent=node,
                                 last_used=self._clock,
                                 depth=node.depth + 1)
                node.children[key] = child
                self._nodes[b] = child
                self.pool.mark_cached(b)
                inserted += 1
            else:
                child.last_used = self._clock
                if child.block != blocks[i]:
                    self.duplicate_blocks += 1
            node = child
        self.inserted_blocks += inserted
        if self.max_cached_blocks is not None:
            self._trim(self.max_cached_blocks)
        return inserted

    # ------------------------------------------------------------ evict
    def _evictable(self) -> Iterator[TrieNode]:
        for node in self._nodes.values():
            if not node.children and self.pool.refcount(node.block) == 0:
                yield node

    def _evict_node(self, node: TrieNode) -> None:
        assert not node.children
        node.parent.children.pop(node.tokens, None)
        del self._nodes[node.block]
        self.pool.release_cached(node.block)

    def _evict_lru(self, need: int) -> int:
        """Evict up to ``need`` cached-idle blocks, least-recently-used
        leaves first (evicting a leaf can make its parent a leaf, so the
        sweep repeats until satisfied or dry). Returns how many were
        released to the pool's free list."""
        freed = 0
        while freed < need:
            best = min(self._evictable(),
                       key=lambda n: (n.last_used, -n.depth, n.block),
                       default=None)
            if best is None:
                break
            self._evict_node(best)
            freed += 1
        return freed

    def _reclaim(self, need: int) -> int:
        """BlockPool's pressure valve: called on alloc shortfall, before
        the pool reports OOM."""
        with self.tracer.phase("reclaim", need=need):
            freed = self._evict_lru(need)
        self.reclaimed_blocks += freed
        return freed

    def _trim(self, cap: int) -> int:
        """Shrink the trie to at most ``cap`` blocks (LRU evictable leaves
        first; blocks pinned by live requests don't count as trimmable,
        so the trie can transiently exceed the cap while sharers live).
        Counted apart from pressure reclaims — a routine cap trim is not a
        memory-pressure signal."""
        excess = len(self._nodes) - cap
        trimmed = self._evict_lru(excess) if excess > 0 else 0
        self.trimmed_blocks += trimmed
        return trimmed

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        hit_rate = (self.hit_tokens / self.lookup_tokens
                    if self.lookup_tokens else 0.0)
        return {
            "lookups": self.lookups,
            "lookup_tokens": self.lookup_tokens,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "hit_rate": hit_rate,
            "inserted_blocks": self.inserted_blocks,
            "duplicate_blocks": self.duplicate_blocks,
            "cached_blocks": len(self._nodes),
            "cached_idle_blocks": self.pool.cached_idle_blocks,
            "reclaimed_blocks": self.reclaimed_blocks,
            "trimmed_blocks": self.trimmed_blocks,
            "max_cached_blocks": self.max_cached_blocks,
        }
