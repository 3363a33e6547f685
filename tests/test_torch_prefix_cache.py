"""The port's prefix cache and template store against the reference's.

``repro_torch.runtime.prefix_cache`` and ``template_store`` are host
copies of the reference modules.  The same seeded operation sequences
(register, lookup, match_len, adoption_done, evict_lru, assign, bind,
invalidate, clear) drive a reference and a port instance, each over its
own ``BlockPool`` twin, and every entry, ref count, hit counter, cluster
and stat must agree after every step.  The reference's host-only store
tests (tests/test_template_store.py) run as one parametrised twin test,
their assertions held on both packages.  Also the slot snapshot and
restore (``transformer.clustered_slot_state``,
``restore_clustered_slot_state``) against the reference's on a TINY
clustered cache, and a snapshot that stays put while its slot goes on
absorbing."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as tfm
from repro.models.config import ModelConfig
from repro.runtime import kv_pool as kv_pool_ref
from repro.runtime import prefix_cache as pc_ref
from repro.runtime import template_store as ts_ref
from repro_torch import bridge
from repro_torch.core import kv_compress as kv_t
from repro_torch.models import transformer as tfm_t
from repro_torch.models.config import ModelConfig as ModelConfigT
from repro_torch.runtime import kv_pool as kv_pool_t
from repro_torch.runtime import prefix_cache as pc_t
from repro_torch.runtime import template_store as ts_t
from repro_torch.runtime.server import Server as ServerT

CHUNK, BS, TAIL, SLOTS = 8, 4, 16, 4
REF = types.SimpleNamespace(pool=kv_pool_ref, pc=pc_ref, ts=ts_ref)
PORT = types.SimpleNamespace(pool=kv_pool_t, pc=pc_t, ts=ts_t)


def _pool(pkg, blocks=64):
    return pkg.pool.BlockPool(SLOTS, TAIL, pkg.pool.PagedKVConfig(
        block_size=BS, pool_blocks=blocks))


def _prompts(seed):
    """Templated prompts: three 24-token templates, each cut at a random
    length and given a random suffix, so prefixes share chunk
    boundaries."""
    rng = np.random.default_rng(seed)
    tpl = [rng.integers(0, 64, size=24).astype(np.int32) for _ in range(3)]
    out = []
    for _ in range(8):
        t = tpl[int(rng.integers(3))][:int(rng.integers(12, 25))]
        sfx = rng.integers(0, 64, size=int(rng.integers(1, 17)))
        out.append(np.concatenate([t, sfx]).astype(np.int32))
    return out


def _state(cache, pool):
    """Everything observable of a cache (a store too) and its pool."""
    maps = [[(key, e.tokens.tolist(), e.fed, e.cov, sorted(e.blocks.items()),
              e.stamp, e.hits, e.cluster, e.in_flight)
             for key, e in m.items()] for m in cache._maps]
    st = {"maps": maps, "hits": cache.hits, "reused": cache.tokens_reused,
          "clock": cache._clock}
    if pool is not None:
        st["pool"] = (pool.table.tolist(), pool.ref.tolist(), pool.n_allocs,
                      pool.n_frees, pool.n_retains, pool.allocated())
    if hasattr(cache, "tcfg"):
        st.update(stats=cache.stats(), clusters=cache.cluster_stats(),
                  families=sorted(cache._families.items()),
                  medoids=sorted(cache._medoid_cid.items()),
                  next_cid=cache._next_cid, tick=cache._tick,
                  invalidations=cache.invalidations,
                  retired=cache.clusters_retired, epoch=cache.epoch,
                  pinned=cache.pinned_blocks())
    return st


class _Driver:
    """One package's cache (or store) and pool, fed the twin's ops."""

    def __init__(self, pkg, store, cfg_kw):
        self.pkg = pkg
        self.pool = _pool(pkg)
        if store:
            self.cache = pkg.ts.TemplateStore(pkg.ts.TemplateStoreConfig(
                **cfg_kw))
            self.cache.bind("e0", 1, self.pool)
        else:
            self.cache = pkg.pc.PrefixCache(
                pkg.pc.PrefixShareConfig(**cfg_kw), 1, self.pool)
        self.in_flight = []
        self.last_cid = -1      # the last assign's cluster, as the engine
                                # tags a request's registrations

    def do(self, op, prompt, arg):
        c, pool = self.cache, self.pool
        if op == "register":
            fed, cov, nblk, slot, tagged = arg
            cluster = self.last_cid if tagged else -1
            for bi in range(nblk):
                pool.alloc(slot, bi)
            blocks = {bi: int(pool.table[slot, bi]) for bi in range(nblk)}
            got = c.register(0, prompt, fed, cov, blocks, snap=None,
                             cluster=cluster)
            pool.free_slot(slot)       # the entry's retains keep them live
            return got
        if op == "lookup":
            e = c.lookup(0, prompt, CHUNK,
                         digests=c.prefix_digests(prompt, CHUNK))
            if e is not None:
                self.in_flight.append(e)
            return None if e is None else e.fed
        if op == "match_len":
            return c.match_len(0, prompt, CHUNK)
        if op == "adoption_done":
            if self.in_flight:
                c.adoption_done(self.in_flight.pop(0))
            return None
        if op == "evict_lru":
            return c.evict_lru(0)
        if op == "assign":
            self.last_cid = c.assign(prompt, c.prefix_digests(prompt, CHUNK))
            return self.last_cid
        # the rest drop entries: every adoption must finish first
        while self.in_flight:
            c.adoption_done(self.in_flight.pop(0))
        if op == "bind":
            epoch, new_pool = arg
            self.last_cid = -1      # the clusters may go with the entries
            if new_pool:
                self.pool = _pool(self.pkg)
            return c.bind(epoch, 1, self.pool)
        if op == "invalidate":
            self.last_cid = -1
            return c.invalidate()
        if op == "clear":
            return c.clear()
        raise AssertionError(op)


def _ops(seed, store, n=160):
    rng = np.random.default_rng(seed)
    prompts = _prompts(seed)
    names = ["register", "register", "lookup", "lookup", "match_len",
             "adoption_done", "evict_lru"]
    names += ["assign", "assign", "bind", "invalidate"] if store else ["clear"]
    for i in range(n):
        op = names[int(rng.integers(len(names)))]
        if op in ("invalidate", "clear", "bind") and rng.random() < 0.7:
            op = "lookup"                      # keep entries around longer
        p = prompts[int(rng.integers(len(prompts)))]
        arg = None
        if op == "register":
            top = (len(p) - 1) // CHUNK
            fed = CHUNK * int(rng.integers(1, top + 1)) if top else CHUNK
            arg = (fed, int(rng.integers(0, fed + 1)),
                   int(rng.integers(1, TAIL // BS + 1)), i % SLOTS,
                   bool(rng.random() < 0.5))
        elif op == "bind":
            arg = (f"e{int(rng.integers(2))}", bool(rng.random() < 0.3))
        yield op, p, arg


@pytest.mark.parametrize("store,cfg_kw", [
    (False, dict(max_entries=4)),
    (False, dict(max_entries=32, min_prefix=16)),
    (True, dict(max_entries=3)),
    (True, dict(max_entries=6, promote_after=1, retire_after=5)),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_operation_sequence_matches_reference(store, cfg_kw, seed):
    ref, port = _Driver(REF, store, cfg_kw), _Driver(PORT, store, cfg_kw)
    hits = 0
    for step, (op, p, arg) in enumerate(_ops(seed, store)):
        want = ref.do(op, p, arg)
        got = port.do(op, p, arg)
        assert got == want, (step, op)
        assert _state(port.cache, port.pool) == _state(ref.cache, ref.pool), \
            (step, op)
        hits += op == "lookup" and want is not None
    assert hits > 0                            # the sequence really hit


def test_digests_match_reference():
    for p in _prompts(3):
        assert (pc_t.PrefixCache(pc_t.PrefixShareConfig(), 1, None)
                .prefix_digests(p, CHUNK)
                == pc_ref.PrefixCache(pc_ref.PrefixShareConfig(), 1, None)
                .prefix_digests(p, CHUNK))


# ---------------------------------------------------------------------------
# tests/test_template_store.py's host-only tests, on both packages
# ---------------------------------------------------------------------------


def _registered(store, pool, slot, prompt, fed):
    bis = [bi for bi in range(pool.blocks_per_slot) if bi * 4 < fed]
    for bi in bis:
        pool.alloc(slot, bi)
    blocks = {bi: int(pool.table[slot, bi]) for bi in bis}
    store.register(pool.shard_of(slot), prompt, fed, 0, blocks,
                   snap=object())


def _pool16(pkg):
    return pkg.pool.BlockPool(2, 16, pkg.pool.PagedKVConfig(
        block_size=4, pool_blocks=16))


def case_inflight_guard(pkg):
    """An entry between lookup and restore survives pool-pressure
    eviction even as the scored victim (reference :183)."""
    pool = _pool16(pkg)
    store = pkg.ts.TemplateStore(pkg.ts.TemplateStoreConfig(max_entries=4))
    store.bind("epoch", 1, pool)
    pA = np.arange(24, dtype=np.int32)
    pB = np.arange(24, dtype=np.int32) + 1
    _registered(store, pool, 0, pA, 8)
    _registered(store, pool, 1, pB, 8)
    for _ in range(2):
        e = store.lookup(0, pB, 8, digests=store.prefix_digests(pB, 8))
        store.adoption_done(e)
    eA = store.lookup(0, pA, 8, digests=store.prefix_digests(pA, 8))
    assert eA is not None and eA.in_flight == 1
    assert store.evict_lru(0)                  # must pick B, not A
    assert any(v is eA for v in store._maps[0].values())
    assert not store.evict_lru(0)              # only the pin remains
    with pytest.raises(RuntimeError, match="in flight"):
        store.invalidate()
    store.adoption_done(eA)
    assert store.evict_lru(0)
    assert store.pinned_blocks() == 0
    for s in range(2):
        pool.free_slot(s)
    assert pool.allocated() == 0
    with pytest.raises(ValueError, match="without a matching"):
        store.adoption_done(eA)
    return _state(store, pool)


def case_scored_eviction(pkg):
    """hits x tokens-reused beats recency (reference :219)."""
    pool = _pool16(pkg)
    store = pkg.ts.TemplateStore(pkg.ts.TemplateStoreConfig(max_entries=4))
    store.bind("epoch", 1, pool)
    hot = np.arange(24, dtype=np.int32)
    decoy = np.arange(24, dtype=np.int32) + 1
    _registered(store, pool, 0, hot, 8)
    for _ in range(2):
        e = store.lookup(0, hot, 8, digests=store.prefix_digests(hot, 8))
        store.adoption_done(e)
    _registered(store, pool, 1, decoy, 8)
    assert store.evict_lru(0)
    assert store.match_len(0, hot, 8) == 8
    assert store.match_len(0, decoy, 8) == 0
    return _state(store, pool)


def case_bind_epoch_and_pool(pkg):
    """Same epoch and pool: warm; another epoch or pool: cold (:240)."""
    pool = _pool16(pkg)
    store = pkg.ts.TemplateStore(pkg.ts.TemplateStoreConfig())
    assert store.bind("e1", 1, pool)
    p = np.arange(24, dtype=np.int32)
    _registered(store, pool, 0, p, 8)
    assert not store.bind("e1", 1, pool)
    assert store.pinned_blocks() > 0
    assert store.bind("e2", 1, pool)
    assert store.pinned_blocks() == 0
    _registered(store, pool, 0, p, 8)
    pool2 = _pool16(pkg)
    assert store.bind("e2", 1, pool2)
    assert store.pinned_blocks() == 0
    return _state(store, pool2)


def case_promotion(pkg):
    """A recurring family becomes a cluster medoid (:257)."""
    store = pkg.ts.TemplateStore(pkg.ts.TemplateStoreConfig(promote_after=2))
    store.bind("e", 1, _pool16(pkg))
    p = np.arange(24, dtype=np.int32)
    d = store.prefix_digests(p, 8)
    assert store.assign(p, d) == -1
    cid = store.assign(p, d)
    assert cid >= 0
    assert store.assign(p, d) == cid
    assert store.stats()["template_clusters"] == 1.0
    return _state(store, None)


def case_recurrence_decay(pkg):
    """An idle medoid retires; its entries de-associate and keep their
    blocks; the family re-promotes from scratch (:312)."""
    pool = _pool16(pkg)
    store = pkg.ts.TemplateStore(pkg.ts.TemplateStoreConfig(
        promote_after=2, retire_after=4))
    store.bind("epoch", 1, pool)
    p = np.arange(10, dtype=np.int32)
    digA, digB = [(8, b"A")], [(8, b"B")]
    assert store.assign(p, digA) == -1
    cid_a = store.assign(p, digA)
    assert cid_a >= 0
    _registered(store, pool, 0, p, 8)
    entry = next(iter(store._maps[0].values()))
    entry.cluster = cid_a
    for _ in range(6):
        store.assign(p, digB)
    assert cid_a not in store._clusters
    assert store.clusters_retired == 1
    assert store.stats()["template_clusters_retired"] == 1.0
    assert entry.cluster == -1
    assert store.pinned_blocks() > 0
    assert any(c.medoid == b"B" for c in store._clusters.values())
    assert store.assign(p, digA) == -1
    cid_a2 = store.assign(p, digA)
    assert cid_a2 >= 0 and cid_a2 != cid_a
    return _state(store, pool)


def case_stale_families(pkg):
    """Unpromoted family counts expire on the same clock (:346)."""
    store = pkg.ts.TemplateStore(pkg.ts.TemplateStoreConfig(
        promote_after=2, retire_after=3))
    p = np.arange(10, dtype=np.int32)
    store.assign(p, [(8, b"X")])
    for i in range(5):
        store.assign(p, [(8, bytes([i]))])
    assert b"X" not in store._families
    assert store.assign(p, [(8, b"X")]) == -1
    return _state(store, None)


def case_retire_disabled(pkg):
    """retire_after 0 never retires (:360)."""
    store = pkg.ts.TemplateStore(pkg.ts.TemplateStoreConfig(promote_after=1))
    p = np.arange(10, dtype=np.int32)
    cid = store.assign(p, [(8, b"A")])
    assert cid >= 0
    for i in range(200):
        store.assign(p, [(8, bytes([i % 250]))])
    assert cid in store._clusters
    assert store.clusters_retired == 0
    return _state(store, None)


@pytest.mark.parametrize("case", [
    case_inflight_guard, case_scored_eviction, case_bind_epoch_and_pool,
    case_promotion, case_recurrence_decay, case_stale_families,
    case_retire_disabled], ids=lambda f: f.__name__[5:])
def test_store_unit_twins(case):
    assert case(PORT) == case(REF)


# ---------------------------------------------------------------------------
# slot snapshots
# ---------------------------------------------------------------------------

_TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                pad_vocab_multiple=16, dtype="float32")
TINY, TINY_T = ModelConfig(**_TINY_KW), ModelConfigT(**_TINY_KW)


@pytest.fixture(scope="module")
def caches():
    """A TINY clustered cache of 3 slots filled with seeded values, as
    the reference's tree and the port's."""
    ref = tfm.init_cache(TINY, 3, 64, kv_mode="clustered", kv_clusters=8,
                         kv_tail=16)
    rng = np.random.default_rng(0)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return rng.integers(0, 40, size=a.shape).astype(np.int32)
        if a.ndim == 4:                                 # counts (L, B, C, H)
            return rng.integers(0, 5, size=a.shape).astype(a.dtype)
        return rng.normal(size=a.shape).astype(a.dtype)

    ref = jax.tree.map(fill, ref)
    return ref, bridge.cache_from_numpy(ref, TINY_T, "cpu")


def _ref_layers(tree):
    """The reference's scan-stacked leaves as one numpy dict per layer."""
    leaf = tree["scan"]["sub0"]
    return [{k: np.asarray(v)[i] for k, v in leaf.items()}
            for i in range(TINY.n_layers)]


def test_slot_snapshot_matches_reference(caches):
    ref, port = caches
    for j in range(3):
        want = _ref_layers(tfm.clustered_slot_state(ref, jnp.int32(j)))
        got = tfm_t.clustered_slot_state(port, j)["layers"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"k_cents", "v_cents", "counts",
                                        "cov"}
            for k in g:
                assert g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_slot_restore_matches_reference(caches):
    ref, port = caches
    port = {"layers": [{k: v.clone() for k, v in leaf.items()}
                       for leaf in port["layers"]]}
    want = tfm.restore_clustered_slot_state(
        ref, tfm.clustered_slot_state(ref, jnp.int32(2)), jnp.int32(0))
    got = tfm_t.restore_clustered_slot_state(
        port, tfm_t.clustered_slot_state(port, 2), 0)
    for g, w in zip(got["layers"], _ref_layers(want)):
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_snapshot_survives_the_slot_advancing(caches):
    """Regression: a snapshot is a copy.  The slot goes on absorbing (its
    centroids, counts and frontier move, in place); a later adoption must
    restore the rows as they were at the snapshot, not as they are."""
    port = {"layers": [{k: v.clone() for k, v in leaf.items()}
                       for leaf in caches[1]["layers"]]}
    for leaf in port["layers"]:
        leaf["cov"].zero_()
        leaf["counts"].zero_()
    snap = tfm_t.clustered_slot_state(port, 1)
    before = [{k: v.clone() for k, v in s.items()} for s in snap["layers"]]
    ccfg = kv_t.KVCompressConfig(n_clusters=8, iters=2, keep_recent=16,
                                 refresh_every=4)
    ServerT._absorb(port, 1, 16, 12, ccfg)
    for leaf in port["layers"]:
        assert int(leaf["cov"][1]) == 12       # the slot really advanced
        assert float(leaf["counts"][1].sum()) > 0
    for s, b in zip(snap["layers"], before):
        for k in s:
            assert torch.equal(s[k], b[k]), k
