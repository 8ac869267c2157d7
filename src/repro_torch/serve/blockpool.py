"""Fixed-size KV block pool: the host-side allocator behind paged KV.

The paged cache (``layers.attention.PagedKVCache``) stores K/V in a flat
pool of ``num_blocks`` blocks of ``block_size`` tokens each; a request owns
an ordered list of block ids and the device sees them as one
``(num_slots, max_blocks)`` block table. This module is the allocator for
that pool — pure host Python, no jax:

* block 0 is the reserved **null block**: vacant table entries point at it
  and masked/garbage writes land in it, so a freed block can be reused by
  the next request without any device-side scrubbing;
* ``alloc(n)`` pops ``n`` blocks off a free list (lowest ids first, so
  reuse is deterministic for tests) or returns ``None`` — the scheduler
  then simply leaves the request queued and retries next tick;
* blocks are **ref-counted** so the prefix cache (`serve/prefixcache.py`)
  can map one physical block into several requests' block tables:
  ``alloc`` hands blocks out at refcount 1, ``incref`` adds a sharer, and
  ``decref`` (née ``free``; the old name survives as an alias) releases
  one reference. A block whose count hits zero returns to the free list —
  unless the prefix cache has marked it ``cached``, in which case it parks
  on the cached-idle list, its K/V intact, ready to be increfed straight
  back into a future request;
* cached-idle blocks are reclaimed (LRU leaves first, via the cache's
  reclaimer callback) *before* ``alloc`` reports OOM, so prompt caching
  never costs admission capacity;
* counters track peak occupancy and internal fragmentation (tokens of
  allocated-but-unwritten capacity), the paper's compute/memory-balance
  bookkeeping applied to cache capacity instead of GEMM tiles.

Capacity is therefore proportional to *admitted* tokens, not to
``num_slots * max_len`` — the contiguous layout this replaces.
"""
from __future__ import annotations

import heapq
from typing import Callable

NULL_BLOCK = 0


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` tokens (ceil division)."""
    if tokens <= 0:
        return 0
    return -(-tokens // block_size)


class BlockPool:
    """Ref-counted free-list allocator over ``num_blocks`` blocks of
    ``block_size`` tokens. Block 0 (the null block) is never handed out."""

    def __init__(self, num_blocks: int, block_size: int,
                 bytes_per_block: int | None = None):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved null "
                f"block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # bytes one block occupies on device (K + V + scales, all layers;
        # quant.kvcache.kv_block_bytes) — lets OOM decisions and metrics
        # account in bytes, which is what KV quantization halves
        self.bytes_per_block = bytes_per_block
        self._free: list[int] = list(range(1, num_blocks))  # heap, block 0 out
        heapq.heapify(self._free)
        self._ref: dict[int, int] = {}      # block -> live refcount (> 0)
        self._cached: set[int] = set()      # blocks owned by trie nodes
        self._cached_idle: set[int] = set()  # cached AND refcount 0
        self._reclaimer: Callable[[int], int] | None = None
        self._in_use = 0                    # blocks with refcount > 0
        self.peak_in_use = 0
        self.allocs = 0
        self.frees = 0
        self.failed_allocs = 0
        self.increfs = 0
        self.reclaimed_blocks = 0

    # ------------------------------------------------------------ capacity
    @property
    def usable_blocks(self) -> int:
        """Blocks a request can ever own (everything but the null block)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_idle_blocks(self) -> int:
        """Cached blocks no live request references — the LRU reserve
        ``alloc`` reclaims before reporting OOM."""
        return len(self._cached_idle)

    @property
    def blocks_in_use(self) -> int:
        return self._in_use

    def capacity_tokens(self) -> int:
        return self.usable_blocks * self.block_size

    def pool_bytes(self) -> int | None:
        """Device bytes of the whole pool (None when bytes_per_block is
        unknown — pre-quantization callers that never passed it)."""
        if self.bytes_per_block is None:
            return None
        return self.num_blocks * self.bytes_per_block

    def bytes_in_use(self) -> int | None:
        if self.bytes_per_block is None:
            return None
        return self._in_use * self.bytes_per_block

    def blocks_for_bytes(self, budget_bytes: int) -> int:
        """How many pool blocks fit in a byte budget — the capacity side
        of the KV-quantization argument (equal bytes, ~2x blocks)."""
        if self.bytes_per_block is None:
            raise ValueError("blocks_for_bytes needs bytes_per_block")
        return budget_bytes // self.bytes_per_block

    def blocks_for(self, tokens: int) -> int:
        return blocks_for(tokens, self.block_size)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free) + len(self._cached_idle)

    def fits_ever(self, tokens: int) -> bool:
        """Whether a request needing ``tokens`` tokens could be admitted
        into an *empty* pool — False means submit must hard-refuse."""
        return self.blocks_for(tokens) <= self.usable_blocks

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    # ------------------------------------------------------------ alloc/free
    def set_reclaimer(self, fn: Callable[[int], int] | None) -> None:
        """``fn(need)`` is asked to evict up to ``need`` cached-idle blocks
        (returning how many it actually released via
        :meth:`release_cached`) whenever the raw free list runs short —
        installed by the prefix cache, which owns the LRU/leaf ordering."""
        self._reclaimer = fn

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` blocks (lowest ids first) at refcount 1; ``None`` if
        the free list plus whatever the reclaimer can surrender is short —
        the caller defers admission rather than fragmenting. Partial
        reclaims before a failure are kept (the blocks are simply free)."""
        if n < 0:
            raise ValueError(f"alloc of {n} blocks")
        while len(self._free) < n:
            short = n - len(self._free)
            if self._reclaimer is None or self._reclaimer(short) == 0:
                self.failed_allocs += 1
                return None
        out = [heapq.heappop(self._free) for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self._in_use += n
        self.allocs += 1
        self.peak_in_use = max(self.peak_in_use, self._in_use)
        return out

    def incref(self, blocks: list[int]) -> None:
        """Add one reference per block — how a prefix-cache hit maps
        already-written blocks into a new request's table. Revives
        cached-idle blocks (refcount 0) without touching their bytes."""
        for b in blocks:
            self._check_id(b)
            held = self._ref.get(b, 0)
            if held == 0:
                if b not in self._cached_idle:
                    raise ValueError(
                        f"incref of block {b}, which is neither referenced "
                        f"nor cached-idle")
                self._cached_idle.discard(b)
                self._in_use += 1
            self._ref[b] = held + 1
        self.increfs += len(blocks)
        self.peak_in_use = max(self.peak_in_use, self._in_use)

    def decref(self, blocks: list[int]) -> None:
        """Release one reference per block. A block reaching refcount 0
        returns to the free list, or — if the prefix cache owns it — parks
        on the cached-idle (LRU-reclaimable) list with its K/V intact."""
        for b in blocks:
            self._check_id(b)
            held = self._ref.get(b, 0)
            if held == 0:
                raise ValueError(
                    f"double free: block {b} has no live references")
            if held == 1:
                del self._ref[b]
                self._in_use -= 1
                if b in self._cached:
                    self._cached_idle.add(b)
                else:
                    heapq.heappush(self._free, b)
            else:
                self._ref[b] = held - 1
        if blocks:
            self.frees += 1

    # ``free`` predates ref-counting; eviction still just drops the
    # request's references.
    free = decref

    # ------------------------------------------------------- prefix cache
    def mark_cached(self, block: int) -> None:
        """The prefix cache adopted this (currently referenced) block: when
        its refcount hits 0 it idles instead of returning to the free
        list."""
        self._check_id(block)
        if self._ref.get(block, 0) == 0:
            raise ValueError(
                f"mark_cached of unreferenced block {block} (adopt blocks "
                f"before the owning request decrefs them)")
        self._cached.add(block)

    def release_cached(self, block: int) -> None:
        """The prefix cache evicted this block's trie node: the block (which
        must be cached-idle) rejoins the free list for ordinary reuse."""
        if block not in self._cached_idle:
            raise ValueError(
                f"release_cached of block {block}, which is not cached-idle")
        self._cached.discard(block)
        self._cached_idle.discard(block)
        heapq.heappush(self._free, block)
        self.reclaimed_blocks += 1

    def _check_id(self, b: int) -> None:
        if not (0 < b < self.num_blocks):
            raise ValueError(f"invalid block id {b}")

    # ------------------------------------------------------------ accounting
    def fragmentation_tokens(self, live_tokens: int) -> int:
        """Internal fragmentation right now: allocated capacity minus the
        tokens actually written into it (rounded-up tails + reserved-but-
        unreached generation budget). Clamped at zero: with prefix sharing
        one physical block can back several requests' logical tokens, so
        logical live tokens may legitimately exceed physical capacity —
        that surplus is the cache's dedup win, not fragmentation."""
        return max(0, self._in_use * self.block_size - live_tokens)

    def utilization(self) -> float:
        """Peak fraction of the pool ever in use."""
        return (self.peak_in_use / self.usable_blocks
                if self.usable_blocks else 0.0)

    def stats(self) -> dict:
        out = {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_in_use": self._in_use,
            "free_blocks": len(self._free),
            "cached_idle_blocks": len(self._cached_idle),
            "peak_in_use": self.peak_in_use,
            "peak_utilization": self.utilization(),
            "allocs": self.allocs,
            "frees": self.frees,
            "failed_allocs": self.failed_allocs,
            "increfs": self.increfs,
            "reclaimed_blocks": self.reclaimed_blocks,
        }
        if self.bytes_per_block is not None:
            out["bytes_per_block"] = self.bytes_per_block
            out["pool_bytes"] = self.pool_bytes()
            out["bytes_in_use"] = self.bytes_in_use()
            out["peak_bytes_in_use"] = self.peak_in_use * self.bytes_per_block
        return out
