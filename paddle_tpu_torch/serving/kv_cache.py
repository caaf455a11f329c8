"""Paged block KV cache: the serving engine's memory plane.

Port of ``paddle_tpu/serving/kv_cache.py``: the host-side allocator
is unchanged; the pages are one torch tensor on the model's device.

The vLLM-style design: the cache is ONE device tensor of fixed-size
blocks

    pages[n_layer, 2, n_blocks, block_size, n_head, head_dim]

and a request owns an ordered *block table* — the list of block ids its
context occupies. The decode program gathers a request's K/V through its
table and scatters the new token's K/V into the tail slot, so the cache
never compacts and requests of wildly different lengths share one
allocation. Block 0 is the reserved **scratch block**: padded table
entries and inactive batch rows direct their (masked, never-read) reads
and writes there, which keeps every gather/scatter in the model's
decode unconditional.

The host-side :class:`BlockAllocator` is deliberately dumb — a free
list with LIFO reuse (the test observes a freed block coming straight
back) and an explicit utilization view the ledger exports as the
``serve_kv_block_utilization`` gauge. Eviction POLICY lives in the
engine (victim = latest SLO deadline); the allocator only answers
"can I have n blocks" honestly.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["BlockAllocator", "blocks_for_tokens"]


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks a context of n_tokens occupies (ceil division)."""
    if n_tokens <= 0:
        return 0
    return (int(n_tokens) + int(block_size) - 1) // int(block_size)


class BlockAllocator:
    """Free-list allocator over block ids [1, n_blocks): block 0 is the
    scratch block and is never handed out. Thread-safe; alloc is
    all-or-nothing (a request half-granted would deadlock the batch)."""

    def __init__(self, n_blocks: int, block_size: int):
        from ..framework import errors as _errors

        if n_blocks < 2:
            raise _errors.errors.InvalidArgument(
                f"kv cache needs >= 2 blocks (1 scratch + 1 usable), "
                f"got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        # LIFO free list: lowest ids on top so reuse is observable and
        # deterministic in tests
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._owner: Dict[int, str] = {}

    @property
    def capacity(self) -> int:
        """Allocatable blocks (scratch excluded)."""
        return self.n_blocks - 1

    def available(self) -> int:
        with self._lock:
            return len(self._free)

    def used(self) -> int:
        with self._lock:
            return len(self._owner)

    def utilization(self) -> float:
        with self._lock:
            return len(self._owner) / float(self.capacity)

    def can_alloc(self, n: int) -> bool:
        with self._lock:
            return len(self._free) >= int(n)

    def alloc(self, n: int, owner: str = "") -> Optional[List[int]]:
        """Grant n blocks to `owner`, or None when the free list cannot
        cover the whole ask (all-or-nothing)."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                return None
            ids = [self._free.pop() for _ in range(n)]
            for b in ids:
                self._owner[b] = owner
            return ids

    def free(self, ids: List[int]) -> None:
        """Return blocks to the free list (LIFO: the next alloc reuses
        the most recently freed block first). Double-frees and scratch
        frees are programming errors and raise — the WHOLE list is
        validated before any block moves, so a rejected free leaves the
        allocator exactly as it was."""
        from ..framework import errors as _errors

        with self._lock:
            seen = set()
            for b in ids:
                b = int(b)
                if b == 0:
                    raise _errors.errors.InvalidArgument(
                        "block 0 is the reserved scratch block")
                if b not in self._owner or b in seen:
                    raise _errors.errors.InvalidArgument(
                        f"block {b} is not allocated (double free?)")
                seen.add(b)
            for b in ids:
                del self._owner[int(b)]
                self._free.append(int(b))

    def owners(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._owner)

    def blocks_of(self, owner: str) -> List[int]:
        with self._lock:
            return sorted(b for b, o in self._owner.items() if o == owner)
