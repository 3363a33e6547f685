"""The port's paged-KV block allocator (repro_torch.runtime.kv_pool)
against the reference's (repro.runtime.kv_pool): the same seeded op
sequences (ensure, free_retired, free_slot, adopt / retain / release,
release_slot / readopt) leave equal block tables, ref counts, generations,
free lists and counters, and raise the same errors.  Then the allocator
invariants of tests/test_properties.py::TestBlockPoolProperties, on the
port's ``check_invariants``."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.runtime import kv_pool as kv_ref
from repro_torch.runtime import kv_pool as kv_t
from repro_torch.runtime.telemetry import MetricsRegistry

R = 16


class _Policy:
    """Duck-typed retention policy handed to both pools' free_retired."""

    def __init__(self, lo, keep_unwritten, protected):
        self.lo = lo
        self.keep_unwritten = keep_unwritten
        self.protected = frozenset(protected)

    def retire_lo(self, slot, t):
        return self.lo

    def protected_blocks(self, slot):
        return self.protected


def _state(pool):
    reg = MetricsRegistry()
    pool.publish(reg, bytes_per_block=64.0)
    return dict(table=pool.table.tolist(), ref=pool.ref.tolist(),
                gen=pool.gen.tolist(), free=[sorted(f) for f in pool._free],
                counters=(pool.n_allocs, pool.n_frees, pool.n_retains,
                          pool.n_cow, pool.allocated(), pool.peak_blocks),
                read=pool.table_for_read().tolist(),
                write=pool.table_for_write().tolist(),
                published=reg.flat_view())


def _apply(pool, op):
    """Run one op; return its result or the name of the error it raised."""
    name, args = op
    try:
        if name == "readopt":
            return pool.readopt(*args)
        if name == "release_slot":
            return sorted(pool.release_slot(*args).items())
        if name == "free_retired":
            slot, t, lo, keep, prot = args
            return pool.free_retired(slot, t, _Policy(lo, keep, prot))
        if name == "ensure":
            return pool.ensure(*args)
        return getattr(pool, name)(*args)
    except (kv_ref.PoolExhausted, kv_t.PoolExhausted) as e:
        return ("PoolExhausted", str(e))
    except ValueError as e:
        return ("ValueError", str(e))


def _next_op(rng, pool, pins, held):
    """A random legal op on ``pool``'s current state: ``release`` only
    drops a pin this sequence took (or hits a dead block, which raises
    cleanly); every other op may be refused by the pool itself."""
    n_slots, t_blocks = pool.table.shape
    slot = int(rng.integers(n_slots))
    bi = int(rng.integers(t_blocks))
    gid = int(rng.integers(pool.n_blocks))
    kind = rng.choice(["ensure", "ensure", "free_retired", "free_covered",
                       "free_slot", "free_block", "adopt", "retain",
                       "release", "release_slot", "readopt"])
    if kind == "ensure":
        k = int(rng.integers(1, t_blocks + 1))
        return kind, (slot, sorted(rng.choice(t_blocks, k,
                                              replace=False).tolist()))
    if kind in ("free_retired", "free_covered"):
        t = int(rng.integers(0, 3 * R))
        lo = int(rng.integers(0, t + 1))
        if kind == "free_covered":
            return kind, (slot, t, lo)
        return kind, (slot, t, lo, bool(rng.integers(2)),
                      rng.choice(t_blocks, 1).tolist())
    if kind in ("free_slot", "release_slot"):
        return kind, (slot,)
    if kind == "free_block":
        return kind, (slot, bi)
    if kind == "adopt":
        live = np.nonzero(pool.ref > 0)[0]
        return kind, (slot, bi, int(rng.choice(live)) if len(live) else gid)
    if kind == "retain":
        pins.append(gid)
        return kind, (gid,)
    if kind == "release":
        dead = np.nonzero(pool.ref == 0)[0]
        if pins:
            return kind, (pins.pop(),)
        if not len(dead):
            return "free_slot", (slot,)
        return kind, (int(rng.choice(dead)),)
    if held:
        bi, (gid, gen) = held[int(rng.integers(len(held)))]
        return kind, (slot, bi, gid, gen)
    return kind, (slot, bi, gid, 0)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("bs,pool_blocks", [(4, 0), (4, 6), (8, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_op_sequences_match_reference(shards, bs, pool_blocks, seed):
    n_slots = 3 * shards
    pools = [mod.BlockPool(n_slots, R, mod.PagedKVConfig(
                 block_size=bs, pool_blocks=pool_blocks), n_shards=shards,
                 slots_per_shard=3)
             for mod in (kv_ref, kv_t)]
    rng = np.random.default_rng(seed)
    pins, held = [], []
    raised = 0
    for _ in range(150):
        op = _next_op(rng, pools[0], pins, held)
        want, got = (_apply(p, op) for p in pools)
        assert got == want, op
        if op[0] == "retain" and got is not None:
            pins.pop()                # refused: nothing to release later
        if op[0] == "release_slot" and got:
            held = list(got)
        raised += isinstance(got, tuple) and got[0] in ("PoolExhausted",
                                                        "ValueError")
        assert _state(pools[1]) == _state(pools[0]), op
        pools[1].check_invariants()
    assert raised > 0                 # the error paths ran too
    assert pools[1].n_allocs > 0 and pools[1].n_frees > 0


@pytest.mark.parametrize("t,cov,r,bs", [(5, 0, 16, 4), (40, 30, 16, 4),
                                        (33, 20, 32, 8), (16, 16, 16, 4)])
def test_ring_helpers_match_reference(t, cov, r, bs):
    np.testing.assert_array_equal(kv_t.ring_claims(t, r),
                                  kv_ref.ring_claims(t, r))
    assert kv_t.live_blocks(t, cov, r, bs) == kv_ref.live_blocks(t, cov,
                                                                 r, bs)
    assert (kv_t.write_blocks(t, 9, r, bs)
            == kv_ref.write_blocks(t, 9, r, bs))


class TestBlockPoolProperties:
    """tests/test_properties.py::TestBlockPoolProperties on the port."""

    @settings(max_examples=25, deadline=None)
    @given(st.integers(1, 2), st.sampled_from([4, 8]),
           st.lists(st.tuples(st.integers(0, 3), st.integers(0, 3),
                              st.sampled_from(["alloc", "free_block",
                                               "free_slot", "covered"])),
                    min_size=1, max_size=60),
           st.integers(0, 10_000))
    def test_random_op_sequences_conserve_pool(self, shards, bsz, ops,
                                               seed):
        rng = np.random.default_rng(seed)
        n_slots = 4 * shards
        pool = kv_t.BlockPool(n_slots, R, kv_t.PagedKVConfig(block_size=bsz),
                              n_shards=shards, slots_per_shard=4)
        t_of = np.zeros(n_slots, np.int64)
        for slot_raw, bi_raw, op in ops:
            slot = (slot_raw * shards) % n_slots
            bi = bi_raw % pool.blocks_per_slot
            if op == "alloc":
                try:
                    gid = pool.alloc(slot, bi)
                except kv_t.PoolExhausted:
                    pass
                else:
                    assert gid // pool.pool_blocks == pool.shard_of(slot)
            elif op == "free_block":
                pool.free_block(slot, bi)
            elif op == "free_slot":
                pool.free_slot(slot)
            else:
                t_of[slot] += int(rng.integers(1, R))
                cov = max(0, int(t_of[slot]) - int(rng.integers(0, R)))
                pool.free_covered(slot, int(t_of[slot]), cov)
            pool.check_invariants()
        for slot in range(n_slots):
            pool.free_slot(slot)
        pool.check_invariants()
        assert pool.allocated() == 0
        assert (pool.table == -1).all()
        assert pool.n_frees == pool.n_allocs

    def test_release_dead_block_raises_cleanly(self):
        pool = kv_t.BlockPool(2, 16, kv_t.PagedKVConfig(block_size=4))
        gid = pool.alloc(0, 0)
        pool.free_block(0, 0)
        free_before = sorted(pool._free[0])
        for _ in range(2):
            with pytest.raises(ValueError, match="dead block"):
                pool.release(gid)
            assert int(pool.ref[gid]) == 0
            assert sorted(pool._free[0]) == free_before
        with pytest.raises(ValueError, match="dead block"):
            pool.retain(gid)
        pool.check_invariants()

    def test_cow_never_mutates_a_referenced_block(self):
        pool = kv_t.BlockPool(2, 16, kv_t.PagedKVConfig(block_size=4))
        gid = pool.alloc(0, 1)
        pool.adopt(1, 1, gid)
        pool.retain(gid)
        assert int(pool.ref[gid]) == 3
        pairs = pool.ensure(0, [1])
        assert len(pairs) == 1 and pairs[0][0] == gid
        _, dst = pairs[0]
        assert int(pool.table[0, 1]) == dst != gid
        assert int(pool.table[1, 1]) == gid
        assert int(pool.ref[gid]) == 2 and int(pool.ref[dst]) == 1
        assert pool.ensure(0, [1]) == []
        pool.check_invariants()

    def test_pool_smaller_than_one_ring_is_refused(self):
        with pytest.raises(ValueError, match="cannot hold"):
            kv_t.BlockPool(2, 16, kv_t.PagedKVConfig(block_size=4,
                                                     pool_blocks=3))
        with pytest.raises(ValueError, match="must divide"):
            kv_t.BlockPool(2, 18, kv_t.PagedKVConfig(block_size=4))
