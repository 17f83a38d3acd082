"""Paged-KV bookkeeping: the block allocator and the radix prefix index
(the port's own copy of ``repro.serve.paging``; it imports nothing of
``repro``).

Everything here is host-side Python over small numpy arrays — the device
never sees these structures.  The engine translates them into a dense
``[n_slots, max_pages]`` int32 page table (``-1`` = unallocated) that the
tick/chunk programs read through.

Two invariants the engine relies on:

- A block's refcount is the number of independent holders: each resident
  request that maps it (one ref per slot, taken at admission, dropped at
  retire) plus the radix tree if a node points at it.  A block returns to
  the free list exactly when its refcount reaches zero.
- Radix nodes are keyed by *full* ``block_len``-token chunks of the prompt
  stream, so a cache hit is always a whole-page hit and shared pages are
  never written after admission (residents only append at positions past
  every shared page).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class OutOfBlocks(Exception):
    """Allocator has fewer free blocks than the request needs."""


class BlockAllocator:
    """Free-list allocator over ``n_blocks`` KV pages with refcounts."""

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"need n_blocks >= 1, got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self.ref = np.zeros(self.n_blocks, np.int32)
        # LIFO free list: recently released blocks are reused first, which
        # keeps the working set of device pages small
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self.peak_used = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh blocks (refcount 1 each)."""
        if n > len(self._free):
            raise OutOfBlocks(
                f"need {n} blocks, {len(self._free)}/{self.n_blocks} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self.ref[b] = 1
        self.peak_used = max(self.peak_used, self.n_used)
        return out

    def retain(self, block: int) -> None:
        """Add a reference to an already-live block (prefix sharing)."""
        if self.ref[block] < 1:
            raise ValueError(f"retain on free block {block}")
        self.ref[block] += 1

    def release(self, blocks) -> None:
        """Drop one reference per block; refcount 0 frees the block."""
        if np.isscalar(blocks):
            blocks = [blocks]
        for b in blocks:
            if self.ref[b] < 1:
                raise ValueError(f"release on free block {b}")
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._free.append(int(b))

    def check(self) -> None:
        """Invariant sweep (tests): free list and refcounts partition blocks."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate blocks on free list"
        for b in range(self.n_blocks):
            if b in free:
                assert self.ref[b] == 0, f"free block {b} has ref {self.ref[b]}"
            else:
                assert self.ref[b] >= 1, f"live block {b} has ref {self.ref[b]}"


class RadixNode:
    """One full-block edge in the prefix tree."""

    __slots__ = ("key", "block", "parent", "children", "last_use")

    def __init__(self, key: Optional[Tuple[int, ...]], block: int,
                 parent: Optional["RadixNode"]):
        self.key = key            # block_len-token tuple (None for the root)
        self.block = block        # backing KV page (-1 for the root)
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.last_use = 0


class RadixPrefixIndex:
    """Radix tree over admitted prompt streams, one node per full KV page.

    Nodes hold one tree reference on their backing block (taken at
    ``insert``, dropped at ``evict``), so a cached page outlives the
    requests that produced it until LRU eviction reclaims it.  Only prompt
    pages written by the canonical chunked-prefill program are ever
    inserted — generated-token pages come from a different fused program
    and would break the bitwise hit==cold contract if shared.
    """

    def __init__(self, block_len: int, allocator: BlockAllocator):
        self.block_len = int(block_len)
        self.alloc = allocator
        self.root = RadixNode(None, -1, None)
        self._nodes: List[RadixNode] = []
        self._clock = 0
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    @property
    def n_nodes(self) -> int:
        return len(self._nodes)

    def _touch(self, node: RadixNode) -> None:
        self._clock += 1
        node.last_use = self._clock

    def match(self, tokens: Sequence[int],
              max_tokens: Optional[int] = None) -> List[RadixNode]:
        """Longest cached prefix of ``tokens`` in whole blocks.

        Returns the matched node path (root excluded); ``max_tokens`` caps
        the walk (the engine passes a chunk-aligned limit so the un-matched
        tail always starts on the canonical prefill-chunk grid).
        """
        limit = len(tokens) if max_tokens is None else min(len(tokens),
                                                          max_tokens)
        bl = self.block_len
        path: List[RadixNode] = []
        node = self.root
        for j in range(limit // bl):
            child = node.children.get(tuple(tokens[j * bl:(j + 1) * bl]))
            if child is None:
                break
            path.append(child)
            node = child
        for n in path:
            self._touch(n)
        if path:
            self.hits += 1
        else:
            self.misses += 1
        return path

    def insert(self, tokens: Sequence[int],
               blocks: Sequence[int]) -> List[RadixNode]:
        """Register the full blocks of ``tokens`` (``blocks[j]`` backs
        block ``j``).  Existing nodes win — a duplicate page stays owned by
        its original node and the caller's copy is simply never shared;
        new nodes take a tree reference on their block.  Returns the nodes
        created."""
        bl = self.block_len
        node = self.root
        created: List[RadixNode] = []
        for j in range(len(tokens) // bl):
            key = tuple(tokens[j * bl:(j + 1) * bl])
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, int(blocks[j]), node)
                node.children[key] = child
                self.alloc.retain(child.block)
                self._nodes.append(child)
                created.append(child)
            self._touch(child)
            node = child
        return created

    def evict(self, n_free_target: int) -> int:
        """Drop LRU leaf nodes whose page only the tree still holds, until
        the allocator has ``n_free_target`` free blocks (cascading: a freed
        leaf exposes its parent).  Returns the number of nodes evicted."""
        evicted = 0
        while self.alloc.n_free < n_free_target:
            victims = [n for n in self._nodes
                       if not n.children and self.alloc.ref[n.block] == 1]
            if not victims:
                break
            victim = min(victims, key=lambda n: n.last_use)
            del victim.parent.children[victim.key]
            self._nodes.remove(victim)
            self.alloc.release(victim.block)
            self.evictions += 1
            evicted += 1
        return evicted
