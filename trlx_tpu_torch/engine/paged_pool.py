"""Host-side block pool for the paged KV cache (the counterpart of
``trlx_tpu.engine.paged_pool``; pure host Python, no device).

The device holds ONE shared physical pool per layer
([n_blocks, block_size, n_head, head_dim], ``models.lm.init_paged_cache``);
this module decides which physical block every slot's virtual block maps
to. Every decision is deterministic (free-list order, LRU order, registry
walk), so the same admission stream builds the same block tables.

- **Full worst-case commitment**: a slot is admitted only if its whole
  virtual span (blocks_per_slot, less the blocks a prefix hit shares) can
  be allocated up front, so decode never needs a block mid-flight.
- **Prefix caching**: admission hashes the prompt's leading full blocks
  (chained over the (ids, mask) content, left padding included, so only
  bit-identical columns share) keyed by weight version. A hit pins the
  registered blocks and the slot prefills only its suffix; a divergent tail
  takes private blocks from the first mismatch on (prompt blocks are never
  edited once written, so diverging means "stop sharing", never "copy").
  After a slot's prefill its full-prompt blocks register for the next
  admission.
- **LRU eviction**: released registered blocks stay warm until the free
  list runs dry; then the least recently released one is evicted. Pinned
  blocks are never evicted.

Block 0 is the reserved TRASH block: free and dead slots' table entries
point at it, so the decode step's clamped writes for dead rows land where
no live slot reads with nonzero weight, and a freed block can be reissued
at once. ``leak_audit`` checks the partition invariant (trash + free +
referenced + cached == n_blocks, refcounts equal to the slots' ownership).
"""

import hashlib
from collections import OrderedDict

import numpy as np

TRASH_BLOCK = 0


class PoolExhausted(RuntimeError):
    """Admission asked for more blocks than free + evictable can supply."""


def prefix_block_digests(ids, mask, block_size, n_blocks_max, seed=b""):
    """Chained sha256 digests of the leading full blocks of a left-padded
    prompt row: block j's digest commits to the (ids, mask) content of
    blocks [0, j], as int32 bytes, so a registry walk can stop at the first
    mismatch."""
    ids = np.ascontiguousarray(np.asarray(ids, dtype=np.int32))
    mask = np.ascontiguousarray(np.asarray(mask, dtype=np.int32))
    digests = []
    h = seed
    for b in range(n_blocks_max):
        lo, hi = b * block_size, (b + 1) * block_size
        if hi > ids.shape[0]:
            break
        h = hashlib.sha256(h + ids[lo:hi].tobytes() + mask[lo:hi].tobytes()).digest()
        digests.append(h)
    return digests


class BlockPool:
    """Deterministic host allocator over ``n_blocks`` physical KV blocks."""

    def __init__(self, n_blocks, block_size, blocks_per_slot, n_slots):
        if n_blocks < 2:
            raise ValueError(f"pool needs >= 2 blocks (trash + 1), got {n_blocks}")
        if n_blocks - 1 < blocks_per_slot:
            raise ValueError(f"pool of {n_blocks} blocks cannot hold even one slot's worst-case span of "
                             f"{blocks_per_slot} blocks")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.blocks_per_slot = int(blocks_per_slot)
        self.n_slots = int(n_slots)
        self.free = list(range(self.n_blocks - 1, 0, -1))  # pop() hands out 1, 2, 3, ...
        self.ref = np.zeros((self.n_blocks,), dtype=np.int64)
        self.tables = np.zeros((self.n_slots, self.blocks_per_slot), dtype=np.int32)  # host mirror, trash-filled
        self._slot_shared = [[] for _ in range(self.n_slots)]  # pinned prefix blocks
        self._slot_private = [[] for _ in range(self.n_slots)]
        # (version, digest) -> block, its reverse, and the ref == 0 warm cache
        # in least-recently-released order.
        self._registry = {}
        self._owner_key = {}
        self._lru = OrderedDict()
        self.hits_total = 0
        self.tokens_saved_total = 0
        self.evictions = 0

    # ----------------------------------------------------------- allocation

    def available(self) -> int:
        """Blocks an admission could obtain: free + evictable (warm cache)."""
        return len(self.free) + len(self._lru)

    def used_blocks(self) -> int:
        """Blocks referenced by at least one live slot."""
        return int((self.ref > 0).sum())

    def cached_blocks(self) -> int:
        """Warm (ref == 0, registered, evictable) blocks."""
        return len(self._lru)

    def _take_block(self) -> int:
        if self.free:
            return self.free.pop()
        if self._lru:
            blk, _ = self._lru.popitem(last=False)
            del self._registry[self._owner_key.pop(blk)]
            self.evictions += 1
            return blk
        raise PoolExhausted("no free or evictable blocks")

    def lookup_prefix(self, version, ids, mask, max_hit_blocks):
        """The longest registered chain of leading blocks (a pure read)."""
        hits = []
        for d in prefix_block_digests(ids, mask, self.block_size, max_hit_blocks):
            blk = self._registry.get((version, d))
            if blk is None:
                break
            hits.append(blk)
        return hits

    def admit(self, slot, version, ids, mask):
        """Allocate the slot's whole span, all or nothing: pin the prefix
        blocks the prompt hits, take private blocks for the rest, set the
        table row. Returns (table row, hit tokens). Raises PoolExhausted with
        NOTHING changed if the span cannot be covered."""
        if self._slot_shared[slot] or self._slot_private[slot]:
            raise RuntimeError(f"slot {slot} admitted while still owning blocks")
        width = int(np.asarray(ids).shape[0])
        # Hit blocks lie strictly inside the prompt: at least one token must
        # prefill, or there are no frontier logits.
        max_hit = min(self.blocks_per_slot, (width - 1) // self.block_size)
        hits = self.lookup_prefix(version, ids, mask, max_hit)
        # Pinning a warm hit takes it out of the evictable set, so it costs
        # one unit of availability like a private block.
        fresh_pins = len({b for b in hits if b in self._lru})
        need_private = self.blocks_per_slot - len(hits)
        if self.available() - fresh_pins < need_private:
            raise PoolExhausted(f"slot {slot} needs {need_private} private blocks (+{fresh_pins} warm pins) but "
                                f"only {self.available()} are free or evictable")
        for b in hits:
            if self.ref[b] == 0:
                self._lru.pop(b)
            self.ref[b] += 1
        private = [self._take_block() for _ in range(need_private)]
        for b in private:
            self.ref[b] += 1
        self._slot_shared[slot] = list(hits)
        self._slot_private[slot] = private
        row = np.asarray(hits + private, dtype=np.int32)
        self.tables[slot] = row
        H = len(hits) * self.block_size
        if hits:
            self.hits_total += 1
            self.tokens_saved_total += H
        return row.copy(), H

    def register_prefix(self, slot, version, ids, mask):
        """After the slot's prefill: make its full-prompt blocks shareable.
        A block straddling the prompt/response boundary receives decode
        writes and never registers; a digest already registered keeps its
        owner, and this slot's duplicate stays private."""
        width = int(np.asarray(ids).shape[0])
        for b, d in enumerate(prefix_block_digests(ids, mask, self.block_size, width // self.block_size)):
            key = (version, d)
            blk = int(self.tables[slot][b])
            if key in self._registry or blk in self._owner_key:
                continue
            self._registry[key] = blk
            self._owner_key[blk] = key

    def release(self, slot):
        """Harvest/abort: drop the slot's references. Registered blocks that
        reach ref 0 park in the warm cache, the rest return to the free list.
        The caller must repoint the DEVICE table row at the trash block
        before a freed block can be reissued."""
        for b in self._slot_shared[slot] + self._slot_private[slot]:
            self.ref[b] -= 1
            if self.ref[b] < 0:
                raise RuntimeError(f"block {b} refcount went negative (slot {slot})")
            if self.ref[b] == 0:
                if b in self._owner_key:
                    self._lru[b] = None  # most recently released at the tail
                else:
                    self.free.append(b)
        self._slot_shared[slot] = []
        self._slot_private[slot] = []
        self.tables[slot] = TRASH_BLOCK

    def shared_blocks(self, slot):
        return list(self._slot_shared[slot])

    def prefix_hit_tokens(self, slot) -> int:
        return len(self._slot_shared[slot]) * self.block_size

    def flush_registry(self):
        """On a weight-version switch: KV of the old weights must never be
        shared into new-version slots. Warm entries free at once; pinned
        ones just unregister and free at harvest."""
        for blk in list(self._lru.keys()):
            del self._registry[self._owner_key.pop(blk)]
            self.free.append(blk)
        self._lru.clear()
        for blk in list(self._owner_key.keys()):
            del self._registry[self._owner_key.pop(blk)]

    # ------------------------------------------------------------ invariants

    def leak_audit(self, expect_idle=False):
        """Raise RuntimeError naming every partition/refcount violation.
        With ``expect_idle`` (abort/shutdown) no slot may own anything and
        every non-free block must be a warm registered entry."""
        owned = {}
        for s in range(self.n_slots):
            for b in self._slot_shared[s] + self._slot_private[s]:
                owned[b] = owned.get(b, 0) + 1
        problems = []
        if TRASH_BLOCK in self.free or TRASH_BLOCK in owned or TRASH_BLOCK in self._lru:
            problems.append("trash block leaked into free/owned/cache")
        free_set = set(self.free)
        if len(free_set) != len(self.free):
            problems.append("duplicate blocks on the free list")
        for b in range(1, self.n_blocks):
            states = (b in free_set) + (b in self._lru) + (self.ref[b] > 0)
            if states != 1:
                problems.append(f"block {b} in {states} states (free={b in free_set}, cached={b in self._lru}, "
                                f"ref={int(self.ref[b])})")
            if self.ref[b] != owned.get(b, 0):
                problems.append(f"block {b} ref {int(self.ref[b])} != slot ownership {owned.get(b, 0)}")
        for blk in self._lru:
            if blk not in self._owner_key:
                problems.append(f"cached block {blk} is not registered")
        for key, blk in self._registry.items():
            if self._owner_key.get(blk) != key:
                problems.append(f"registry/reverse-map mismatch on block {blk}")
        if expect_idle and owned:
            problems.append(f"idle pool still owned: {sorted(owned)}")
        if expect_idle and 1 + len(free_set) + len(self._lru) != self.n_blocks:
            problems.append(f"idle pool leaks blocks: trash+free+cached={1 + len(free_set) + len(self._lru)} "
                            f"!= n_blocks={self.n_blocks}")
        if problems:
            raise RuntimeError("KV pool leak audit failed: " + "; ".join(problems))
