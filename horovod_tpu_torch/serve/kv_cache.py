"""Paged KV-cache block accounting (the vLLM PagedAttention insight).

The physical cache is a pool of ``num_blocks`` fixed-size blocks; a
sequence owns a *block table* — the ordered list of physical block ids
covering its logical positions.  This module is the pure-Python
bookkeeping side: funding decisions (admission control), per-token
growth, recycling on completion/eviction.  The tensors themselves live
in :mod:`horovod_tpu_torch.serve.engine`, and the block-table decode math
in ``models/generation.py`` (``paged_decode_step`` / ``paged_prefill``).
This module is the port's own copy of ``horovod_tpu/serve/kv_cache.py``
(numpy only); the port imports nothing of the JAX package.

Physical block id 0 is reserved as the TRASH block: padded batch rows
and unfunded table entries point at it, so the jitted scatter/gather
always has a valid target without the allocator ever handing it out.
Every refusal leaves the allocator untouched — a sequence that cannot
be funded *now* simply waits (or is preempted back to the queue), it is
never half-funded.

Prefix caching (``prefix_cache=True``, vLLM's automatic prefix caching):
full blocks are additionally keyed by a *chained* content hash —
``h_i = blake2b(h_{i-1} || tokens of block i)`` — so a block's key
commits to ALL content up to its end, and equal keys imply bitwise-equal
K/V (the programs are deterministic and causal).  A new sequence whose
leading full blocks hash-match cached ones shares them (refcounted) and
funds only the non-shared suffix; the first divergent or partial block
is a fresh block — a copy-on-write fork, since sequences only ever
WRITE at positions beyond their shared prefix (decode writes at
``pos >= prompt_len``; a hit's suffix prefill scatters only blocks
``>= start_blk``), shared blocks are immutable by construction.  The
block holding the last prompt token is never shared, so a hit always
leaves at least one suffix token to prefill — the query that produces
the first output logits.  When a sequence releases a registered block
the refcount drops; at zero the block parks on an LRU list, still
cached, and is the eviction victim when the free list runs dry.  A
weight-epoch swap calls :meth:`flush_prefix`, dropping every cached
block and all registrations — stale-epoch KV is structurally
unreachable afterwards.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["PagedKVCache", "TRASH_BLOCK"]

#: Reserved physical block id — never allocated, written only by padded
#: rows, never read by a live sequence.
TRASH_BLOCK = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache slots."""
    return -(-int(n_tokens) // int(block_size))


class PagedKVCache:
    """Block allocator + per-sequence block tables.

    ``num_blocks`` counts the whole pool INCLUDING the trash block, so
    ``capacity_blocks = num_blocks - 1`` are allocatable.  All methods
    are O(blocks touched); none raise on refusal — they return False and
    leave state unchanged, which is what admission control keys off.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int, *, prefix_cache: bool = False):
        if num_blocks < 2:
            raise ValueError("need at least one allocatable block "
                             "besides the trash block")
        if block_size < 1:
            raise ValueError("block_size must be positive")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.prefix_cache = bool(prefix_cache)
        self._free: deque[int] = deque(range(1, self.num_blocks))
        self._tables: Dict[int, List[int]] = {}
        # Prefix-cache state: chained content hash <-> physical block
        # (bijective — a hash is registered by at most one block), live
        # refcounts, and the refcount-0 LRU parking lot.
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_hash: Dict[int, bytes] = {}
        self._block_ref: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # Cumulative recycling counters (serve stats).
        self.allocated_blocks_total = 0
        self.freed_blocks_total = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        self.cow_forks = 0

    # -- capacity --

    @property
    def capacity_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 registered blocks (reusable, evictable)."""
        return len(self._lru)

    @property
    def blocks_in_use(self) -> int:
        """Blocks held by live sequences (cached-idle blocks excluded —
        they are reclaimable on demand, so drain accounting still ends
        at zero)."""
        return self.capacity_blocks - len(self._free) - len(self._lru)

    def fits_model(self, n_tokens: int) -> bool:
        """Whether a sequence of ``n_tokens`` total positions can EVER be
        funded (table width + pool size) — False means reject the
        request outright, not queue it."""
        need = blocks_for(n_tokens, self.block_size)
        return need <= min(self.max_blocks_per_seq, self.capacity_blocks)

    def can_fund(self, n_tokens: int) -> bool:
        """Whether ``n_tokens`` cache slots are fundable right now
        (cached-idle blocks count — they evict on demand)."""
        need = blocks_for(n_tokens, self.block_size)
        return need <= len(self._free) + len(self._lru)

    # -- prefix hashing --

    def _chain_hashes(self, tokens: Sequence[int]) -> List[bytes]:
        """Chained digests of the FULL blocks of ``tokens`` — entry i
        commits to every token through block i's end."""
        out: List[bytes] = []
        h = b""
        bs = self.block_size
        for i in range(len(tokens) // bs):
            blk = np.asarray(tokens[i * bs:(i + 1) * bs],
                             dtype=np.int64).tobytes()
            h = hashlib.blake2b(h + blk, digest_size=16).digest()
            out.append(h)
        return out

    def _take_block(self) -> Optional[int]:
        """One block from the free list, else evict the LRU cached
        block (dropping its registration)."""
        if self._free:
            return self._free.popleft()
        if self._lru:
            bid, _ = self._lru.popitem(last=False)
            self._hash_to_block.pop(self._block_hash.pop(bid))
            self._block_ref.pop(bid, None)
            self.prefix_evictions += 1
            return bid
        return None

    # -- lifecycle --

    def allocate(self, seq_id: int, n_tokens: int) -> bool:
        """Fund a new sequence with blocks for ``n_tokens`` slots.
        All-or-nothing: False (state unchanged) when the pool can't
        cover it."""
        if seq_id in self._tables:
            raise KeyError(f"sequence {seq_id} already funded")
        need = blocks_for(n_tokens, self.block_size)
        if need > self.max_blocks_per_seq or \
                need > len(self._free) + len(self._lru):
            return False
        self._tables[seq_id] = [self._take_block() for _ in range(need)]
        self.allocated_blocks_total += need
        return True

    def allocate_prefix(self, seq_id: int,
                        tokens: Sequence[int]) -> Optional[int]:
        """Fund a new sequence for ``len(tokens)`` slots, sharing cached
        leading blocks by content hash.  Returns the number of shared
        (hit) blocks — the prefill may skip ``shared * block_size``
        positions — or None when unfundable (state unchanged).  With
        prefix caching off this is exactly :meth:`allocate`."""
        n_tokens = len(tokens)
        if not self.prefix_cache:
            return 0 if self.allocate(seq_id, n_tokens) else None
        if seq_id in self._tables:
            raise KeyError(f"sequence {seq_id} already funded")
        need_total = blocks_for(n_tokens, self.block_size)
        if need_total > self.max_blocks_per_seq:
            return None
        shareable = min((n_tokens - 1) // self.block_size, need_total)
        shared: List[int] = []
        for h in self._chain_hashes(tokens)[:shareable]:
            bid = self._hash_to_block.get(h)
            if bid is None:
                break
            shared.append(bid)
        need_fresh = need_total - len(shared)
        # Shared blocks parked in the LRU are about to be reserved, so
        # they must not count as evictable headroom for the fresh part.
        avail = len(self._free) + len(self._lru) \
            - sum(1 for bid in shared if bid in self._lru)
        if need_fresh > avail:
            return None
        for bid in shared:
            self._block_ref[bid] += 1
            self._lru.pop(bid, None)
        fresh = [self._take_block() for _ in range(need_fresh)]
        self._tables[seq_id] = shared + fresh
        self.allocated_blocks_total += need_fresh
        self.prefix_hits += len(shared)
        self.prefix_misses += shareable - len(shared)
        if shared and fresh:
            self.cow_forks += 1
        return len(shared)

    def register_prefix(self, seq_id: int, tokens: Sequence[int]) -> int:
        """Publish a funded sequence's FULL blocks into the hash map so
        future identical prefixes hit (call after prefill — the blocks
        must actually hold the K/V).  Blocks already registered (shared
        hits) and hashes already published by another block are left
        alone.  Returns the number of newly registered blocks."""
        if not self.prefix_cache:
            return 0
        table = self._tables[seq_id]
        n_full = min(len(tokens) // self.block_size, len(table))
        new = 0
        for h, bid in zip(self._chain_hashes(tokens)[:n_full],
                          table[:n_full]):
            if bid in self._block_hash or h in self._hash_to_block:
                continue
            self._block_hash[bid] = h
            self._hash_to_block[h] = bid
            self._block_ref[bid] = 1
            new += 1
        return new

    def append_slot(self, seq_id: int, n_tokens: int) -> bool:
        """Ensure the table covers ``n_tokens`` slots (one decode step =
        one more slot).  Allocates at most one block; False when the pool
        is exhausted or the table is at ``max_blocks_per_seq``.  Growth
        blocks are always private (never registered) — decode writes
        only ever land outside shared blocks."""
        table = self._tables[seq_id]
        need = blocks_for(n_tokens, self.block_size)
        if need <= len(table):
            return True
        if need > self.max_blocks_per_seq:
            return False
        bid = self._take_block()
        if bid is None:
            return False
        table.append(bid)
        self.allocated_blocks_total += 1
        return True

    def free(self, seq_id: int) -> int:
        """Recycle a sequence's blocks (completion or eviction); returns
        how many the sequence released.  Registered blocks drop a
        refcount and park on the LRU at zero (still cached); private
        blocks go straight back to the free list."""
        table = self._tables.pop(seq_id)
        for bid in table:
            if bid in self._block_hash:
                self._block_ref[bid] -= 1
                if self._block_ref[bid] == 0:
                    self._lru[bid] = None
                    self._lru.move_to_end(bid)
            else:
                self._free.append(bid)
        self.freed_blocks_total += len(table)
        return len(table)

    def flush_prefix(self) -> int:
        """Weight-epoch flush: drop every cached block to the free list
        and forget ALL registrations — stale-epoch KV is structurally
        unreachable afterwards.  Registered blocks still referenced by a
        live table (none at swap time; the scheduler frees all running
        sequences first) are demoted to private.  Returns blocks
        recycled."""
        dropped = len(self._lru)
        self._free.extend(self._lru)
        self._lru.clear()
        self._hash_to_block.clear()
        self._block_hash.clear()
        self._block_ref.clear()
        self.prefix_evictions += dropped
        return dropped

    # -- views --

    def table(self, seq_id: int) -> List[int]:
        return list(self._tables[seq_id])

    def table_array(self, seq_id: int, width: int) -> np.ndarray:
        """The block table padded to ``width`` with the trash block —
        the shape the jitted decode consumes."""
        table = self._tables[seq_id]
        if len(table) > width:
            raise ValueError(f"table wider than {width}")
        out = np.full((width,), TRASH_BLOCK, dtype=np.int32)
        out[:len(table)] = table
        return out

    def assert_consistent(self) -> None:
        """Exact pool accounting (test hook): every allocatable block is
        in exactly one of free / cached-LRU / live tables, refcounts
        match table membership, and the hash maps are bijective."""
        held = set()
        for t in self._tables.values():
            held.update(t)
        free_set, lru_set = set(self._free), set(self._lru)
        assert TRASH_BLOCK not in held | free_set | lru_set
        assert len(self._free) == len(free_set), "free list duplicates"
        assert not (free_set & lru_set) and not (free_set & held) \
            and not (lru_set & held), "block in two pools"
        assert free_set | lru_set | held == \
            set(range(1, self.num_blocks)), "pool accounting leak"
        assert set(self._block_hash) == set(self._block_ref)
        assert len(self._hash_to_block) == len(self._block_hash)
        for bid, h in self._block_hash.items():
            assert self._hash_to_block[h] == bid
        for bid, ref in self._block_ref.items():
            n = sum(1 for t in self._tables.values() if bid in t)
            assert n == ref, (bid, ref, n)
            assert (ref == 0) == (bid in lru_set), (bid, ref)

    def stats(self) -> dict:
        return {
            "kv_blocks_total": self.capacity_blocks,
            "kv_blocks_in_use": self.blocks_in_use,
            "kv_blocks_free": self.free_blocks,
            "kv_blocks_cached": self.cached_blocks,
            "kv_block_size": self.block_size,
            "kv_blocks_allocated_total": self.allocated_blocks_total,
            "kv_blocks_freed_total": self.freed_blocks_total,
            "kv_sequences": len(self._tables),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_evictions": self.prefix_evictions,
            "cow_forks": self.cow_forks,
        }
