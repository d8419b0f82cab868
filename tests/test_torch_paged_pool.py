"""The port's ``BlockPool`` and prefix digests (``trlx_tpu_torch.engine.
paged_pool``): the thirteen cases of the JAX package's
``tests/test_paged_pool.py`` run on the port's pool, the digests byte-equal
to the JAX package's, and both pools driven in lockstep through one seeded
stream of admissions, registrations, releases and flushes, with equal
tables, hits, free lists and counters after every operation. Pure host
bookkeeping, no device."""

import numpy as np
import pytest

from trlx_tpu.engine.paged_pool import BlockPool as JaxBlockPool
from trlx_tpu.engine.paged_pool import PoolExhausted as JaxPoolExhausted
from trlx_tpu.engine.paged_pool import prefix_block_digests as jax_digests
from trlx_tpu_torch.engine.paged_pool import TRASH_BLOCK, BlockPool, PoolExhausted, prefix_block_digests


def _row(*toks):
    ids = np.asarray(toks, dtype=np.int32)
    return ids, np.ones_like(ids)


# --------------------------------------------------------------- digests


def test_digests_are_chained_and_content_addressed():
    ids, msk = _row(*range(8))
    d = prefix_block_digests(ids, msk, 4, 8)
    assert len(d) == 2  # only full blocks digest
    assert prefix_block_digests(ids.copy(), msk.copy(), 4, 8) == d
    ids2 = ids.copy()
    ids2[0] += 1
    d2 = prefix_block_digests(ids2, msk, 4, 8)
    assert d2[0] != d[0] and d2[1] != d[1]  # block 1's digest commits to block 0
    msk2 = msk.copy()
    msk2[1] = 0
    assert prefix_block_digests(ids, msk2, 4, 8)[0] != d[0]  # the mask is content too
    assert len(prefix_block_digests(ids, msk, 4, 1)) == 1


@pytest.mark.parametrize("width,block,cap,seed", [(8, 4, 8, 0), (37, 5, 3, 1), (768, 128, 8, 2), (300, 128, 2, 3)])
def test_digests_byte_equal_to_jax(width, block, cap, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 50400, size=width).astype(np.int64)  # any int dtype: hashed as int32
    msk = np.ones(width, dtype=np.int64)
    msk[: width // 5] = 0
    for s in (b"", b"seed"):
        assert prefix_block_digests(ids, msk, block, cap, seed=s) == jax_digests(ids, msk, block, cap, seed=s)


# -------------------------------------------------------------- admission


def test_admit_allocates_full_span_and_release_frees():
    pool = BlockPool(n_blocks=9, block_size=4, blocks_per_slot=2, n_slots=4)
    ids, msk = _row(*range(8))
    row, hit = pool.admit(0, 1, ids, msk)
    assert hit == 0 and row.shape == (2,)
    assert TRASH_BLOCK not in row
    assert pool.used_blocks() == 2 and pool.available() == 6
    assert (pool.tables[0] == row).all()
    pool.leak_audit()
    pool.release(0)
    assert pool.used_blocks() == 0 and pool.available() == 8
    assert (pool.tables[0] == TRASH_BLOCK).all()
    pool.leak_audit(expect_idle=True)


def test_admit_is_transactional_on_exhaustion():
    pool = BlockPool(n_blocks=5, block_size=4, blocks_per_slot=2, n_slots=4)
    pool.admit(0, 1, *_row(*range(8)))
    pool.admit(1, 1, *_row(*range(100, 108)))
    free_before = list(pool.free)
    with pytest.raises(PoolExhausted):
        pool.admit(2, 1, *_row(*range(200, 208)))
    assert pool.free == free_before
    assert pool.used_blocks() == 4
    assert (pool.tables[2] == TRASH_BLOCK).all()
    pool.leak_audit()


def test_double_admit_same_slot_raises():
    pool = BlockPool(n_blocks=9, block_size=4, blocks_per_slot=2, n_slots=4)
    pool.admit(0, 1, *_row(*range(8)))
    with pytest.raises(RuntimeError, match="still owning"):
        pool.admit(0, 1, *_row(*range(8)))


# ---------------------------------------------------------- prefix sharing


def test_prefix_hit_pins_shared_block_and_skips_its_tokens():
    pool = BlockPool(n_blocks=9, block_size=4, blocks_per_slot=2, n_slots=4)
    ids, msk = _row(*range(8))
    row0, hit0 = pool.admit(0, 1, ids, msk)
    assert hit0 == 0
    pool.register_prefix(0, 1, ids, msk)
    # width 8, cap (8 - 1) // 4 = 1: block 0 shares, block 1 stays private
    row1, hit1 = pool.admit(1, 1, ids, msk)
    assert hit1 == 4
    assert row1[0] == row0[0] and row1[1] != row0[1]
    assert pool.ref[row0[0]] == 2
    assert pool.hits_total == 1 and pool.tokens_saved_total == 4
    assert pool.shared_blocks(1) == [row0[0]] and pool.prefix_hit_tokens(1) == 4
    pool.release(0)
    assert pool.ref[row0[0]] == 1
    pool.leak_audit()
    pool.release(1)
    assert pool.cached_blocks() >= 1
    pool.leak_audit(expect_idle=True)


def test_divergent_tail_stops_sharing_without_copy():
    pool = BlockPool(n_blocks=12, block_size=4, blocks_per_slot=3, n_slots=4)
    ids, msk = _row(*range(12))
    row0, _ = pool.admit(0, 1, ids, msk)
    pool.register_prefix(0, 1, ids, msk)
    ids2 = ids.copy()
    ids2[5] += 1
    row1, hit = pool.admit(1, 1, ids2, msk)
    assert hit == 4
    assert row1[0] == row0[0]
    assert row1[1] != row0[1] and row1[2] != row0[2]
    pool.release(0)
    pool.release(1)
    pool.leak_audit(expect_idle=True)


def test_no_hit_across_weight_versions():
    pool = BlockPool(n_blocks=9, block_size=4, blocks_per_slot=2, n_slots=4)
    ids, msk = _row(*range(8))
    pool.admit(0, 1, ids, msk)
    pool.register_prefix(0, 1, ids, msk)
    pool.release(0)
    _, hit = pool.admit(1, 2, ids, msk)
    assert hit == 0


def test_flush_registry_on_version_switch():
    pool = BlockPool(n_blocks=9, block_size=4, blocks_per_slot=2, n_slots=4)
    ids, msk = _row(*range(8))
    pool.admit(0, 1, ids, msk)
    pool.register_prefix(0, 1, ids, msk)
    other, om = _row(*range(50, 58))
    pool.admit(1, 1, other, om)
    pool.register_prefix(1, 1, other, om)
    pool.release(0)
    assert pool.cached_blocks() == 2
    pool.flush_registry()
    assert pool.cached_blocks() == 0
    assert pool.used_blocks() == 2
    _, hit = pool.admit(2, 1, ids, msk)
    assert hit == 0
    pool.release(1)
    pool.release(2)
    pool.leak_audit(expect_idle=True)


# --------------------------------------------------------------- eviction


def test_lru_eviction_oldest_first():
    pool = BlockPool(n_blocks=4, block_size=4, blocks_per_slot=1, n_slots=4)
    a, am = _row(*range(6))
    b, bm = _row(*range(10, 16))
    pool.admit(0, 1, a, am)
    pool.register_prefix(0, 1, a, am)
    pool.release(0)
    pool.admit(1, 1, b, bm)
    pool.register_prefix(1, 1, b, bm)
    pool.release(1)
    assert pool.cached_blocks() == 2 and len(pool.free) == 1
    pool.admit(2, 1, *_row(*range(20, 26)))
    assert pool.evictions == 0
    pool.admit(3, 1, *_row(*range(30, 36)))
    assert pool.evictions == 1 and pool.cached_blocks() == 1
    pool.release(2)
    pool.release(3)
    _, hit_a = pool.admit(0, 1, a, am)
    assert hit_a == 0
    pool.release(0)
    _, hit_b = pool.admit(1, 1, b, bm)
    assert hit_b == 4
    pool.release(1)
    pool.leak_audit(expect_idle=True)


def test_pinned_warm_hit_costs_availability():
    pool = BlockPool(n_blocks=4, block_size=4, blocks_per_slot=2, n_slots=4)
    ids, msk = _row(*range(8))
    pool.admit(0, 1, ids, msk)
    pool.register_prefix(0, 1, ids, msk)
    pool.release(0)
    _, hit = pool.admit(1, 1, ids, msk)
    assert hit == 4
    assert pool.available() == 1
    with pytest.raises(PoolExhausted):
        pool.admit(2, 1, *_row(*range(40, 48)))
    pool.release(1)
    pool.leak_audit(expect_idle=True)


# -------------------------------------------------------------- leak audit


def test_leak_audit_names_violations():
    pool = BlockPool(n_blocks=5, block_size=4, blocks_per_slot=2, n_slots=2)
    pool.admit(0, 1, *_row(*range(8)))
    with pytest.raises(RuntimeError, match="still owned"):
        pool.leak_audit(expect_idle=True)
    blk = pool._slot_private[0].pop()
    with pytest.raises(RuntimeError, match=f"block {blk}"):
        pool.leak_audit()


def test_release_detects_negative_refcount():
    pool = BlockPool(n_blocks=5, block_size=4, blocks_per_slot=2, n_slots=2)
    pool.admit(0, 1, *_row(*range(8)))
    stolen = list(pool._slot_private[0])
    pool.release(0)
    pool._slot_private[0] = stolen
    with pytest.raises(RuntimeError, match="negative"):
        pool.release(0)


def test_constructor_validation():
    with pytest.raises(ValueError, match=">= 2 blocks"):
        BlockPool(n_blocks=1, block_size=4, blocks_per_slot=1, n_slots=1)
    with pytest.raises(ValueError, match="worst-case span"):
        BlockPool(n_blocks=3, block_size=4, blocks_per_slot=4, n_slots=1)


# ---------------------------------------------------------------- lockstep


def _snapshot(pool):
    return (pool.tables.tolist(), list(pool.free), pool.ref.tolist(), list(pool._lru), pool.hits_total,
            pool.tokens_saved_total, pool.evictions, pool.used_blocks(), pool.cached_blocks())


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_matches_jax_pool_in_lockstep(seed):
    """300 seeded operations on a tight pool (evictions, exhaustion, shared
    templates, version flushes): both pools give the same result for each
    and the same state after it."""
    rng = np.random.default_rng(seed)
    kw = dict(n_blocks=14, block_size=4, blocks_per_slot=3, n_slots=5)
    ours, ref = BlockPool(**kw), JaxBlockPool(**kw)
    templates = [rng.integers(2, 30, size=12).astype(np.int32) for _ in range(3)]
    live, version = set(), 1
    for _ in range(300):
        op = rng.integers(0, 10)
        if op < 5 and len(live) < kw["n_slots"]:
            slot = int(rng.choice(sorted(set(range(kw["n_slots"])) - live)))
            ids = templates[rng.integers(0, 3)].copy()
            ids[int(rng.integers(4, 12)):] = rng.integers(2, 30)  # tails diverge
            msk = np.ones_like(ids)
            msk[: int(rng.integers(0, 3))] = 0
            results = []
            for pool in (ours, ref):
                try:
                    row, hit = pool.admit(slot, version, ids, msk)
                    pool.register_prefix(slot, version, ids, msk)
                    results.append((row.tolist(), hit))
                except (PoolExhausted, JaxPoolExhausted):
                    results.append("exhausted")
            assert results[0] == results[1]
            if results[0] != "exhausted":
                live.add(slot)
        elif op < 9 and live:
            slot = int(rng.choice(sorted(live)))
            ours.release(slot)
            ref.release(slot)
            live.discard(slot)
        else:
            version += 1
            ours.flush_registry()
            ref.flush_registry()
        assert _snapshot(ours) == _snapshot(ref)
        ours.leak_audit()
    assert ours.hits_total > 0 and ours.evictions > 0
