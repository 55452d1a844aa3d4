"""Block allocator for the paged KV cache (vLLM-style) — the port of
``repro.serve.paged``, line for line (pure Python, no numpy, no torch).

The pool is ``num_blocks`` physical blocks of ``page`` token rows
(``models/lm.lm_paged_cache_defs``); a request's logical positions
``0..cap-1`` map onto ``ceil(cap / page)`` physical blocks through its
block table. The allocator owns the free list on the host — allocation
is a reservation made at admission for the request's WHOLE budget
(prompt + max new tokens), so an admitted request can never run out of
cache mid-generation and the engine never needs preemption.

Physical block 0 is reserved as the scratch sink: idle decode slots and
prefill padding rows write their garbage k/v there, and an idle slot's
block table points every entry at it. It is never handed to a request,
so scratch writes cannot corrupt live caches.
"""

from __future__ import annotations


class BlockAllocator:
    """Free-list allocator over physical cache blocks ``1..num_blocks-1``
    (block 0 is the reserved scratch sink)."""

    def __init__(self, num_blocks: int, page: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 usable + scratch), "
                             f"got {num_blocks}")
        if page < 1:
            raise ValueError(f"page must be >= 1, got {page}")
        self.num_blocks = int(num_blocks)
        self.page = int(page)
        # LIFO free list: recently-retired blocks are re-used first
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._live: set[int] = set()

    # ------------------------------------------------------------ queries

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._live)

    def blocks_for(self, n_tokens: int) -> int:
        """Physical blocks needed to hold ``n_tokens`` logical positions."""
        return -(-max(int(n_tokens), 0) // self.page)

    def can_alloc(self, n_blocks: int) -> bool:
        return n_blocks <= len(self._free)

    # ---------------------------------------------------------- transfers

    def alloc(self, n_blocks: int) -> list[int]:
        """Take ``n_blocks`` blocks off the free list (raises when the
        pool cannot serve the request — callers gate on ``can_alloc``)."""
        if n_blocks > len(self._free):
            raise RuntimeError(
                f"paged KV pool exhausted: need {n_blocks} blocks, "
                f"{len(self._free)} free (of {self.num_blocks - 1} usable)")
        out = [self._free.pop() for _ in range(n_blocks)]
        self._live.update(out)
        return out

    def free(self, blocks) -> None:
        """Return a retired request's blocks. Double-free and foreign
        blocks raise — aliasing a freed block into two live block tables
        is exactly the corruption the property tests hunt for."""
        blocks = list(blocks)
        for b in blocks:
            if b not in self._live:
                raise RuntimeError(
                    f"freeing block {b} that is not live (double free, "
                    f"scratch block, or out of range)")
        for b in blocks:
            self._live.remove(b)
            self._free.append(b)
