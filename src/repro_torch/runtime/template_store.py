"""Persistent cross-serve template store with incremental request
clustering — the prefix cache promoted from a per-serve scratch index to
a durable, self-organizing template registry (port of
``repro.runtime.template_store``, host numpy, copied whole).

`runtime/prefix_cache.py` already makes one serve's templated traffic
cheap: chunk-boundary slot state is prefix-pure, so later same-prefix
admissions adopt registered tail blocks and centroid snapshots instead
of re-prefilling.  But the cache was built inside ``Server.serve`` and
cleared at the end of it, so template knowledge never survived a request
stream.  This module keeps it alive across ``serve()`` calls.

Persistence safety argument
---------------------------
A registered snapshot is reusable across serve calls because every input
that determines it is pinned for the lifetime of the store:

* **The bytes cannot change.**  An entry ``retain``-s its tail-ring pool
  blocks, so the allocator never recycles them, and copy-on-write
  (``kv_pool.ensure``) gives any writer of a ``ref > 1`` block a private
  copy first — a pinned payload is immutable from the moment of
  registration.  The centroid snapshot is a device tensor the entry
  owns (a clone, never a view of the slot it came from).  Between serves
  nothing writes at all: the engine hands the pool and the device cache
  back to the server instance, and the only live references into them
  are the store's pins.
* **The bytes stay *meaningful*.**  Chunk-boundary state is a
  deterministic function of ``(tokens[:fed], prefill_chunk,
  KVCompressConfig, model params)`` alone (per-slot compaction gating
  keeps neighbours out of it).  The first three are frozen on the
  ``Server``; the store stamps all of them — plus the params' identity
  and the pool it was registered against — into an **epoch** at
  ``bind()``.  A bind with a different epoch (new model, new
  ``KVCompressConfig``, new pool after a crashed serve, a different
  ``Server`` reusing the store object) invalidates every entry before
  any lookup can adopt a stale snapshot.  Token equality is still
  verified on every hit, exactly as within one serve.

What invalidates the store: ``Server.invalidate_templates()`` (explicit),
an epoch change at ``bind()`` (implicit, conservative), and per-entry
eviction under capacity or pool pressure.  Invalidation releases every
pinned block, so the pool drains to zero; short of it the end-of-serve
invariant is ``pool.allocated() == store.pinned_blocks()``.

Eviction: templates must *earn* their pinned blocks.  Under pool
pressure and the per-shard capacity cap the store drops the entry with
the lowest ``hits × tokens-reused`` score (LRU stamp breaks ties), not
the plain-LRU victim: a template boundary that keeps collapsing
admissions is worth more than a recently-registered suffix-contaminated
boundary that nothing ever hits.  Entries mid-adoption are pinned
(``in_flight``) and never evicted — see ``PrefixCache.lookup``.

Incremental request clustering
------------------------------
The store also clusters the live request traffic online, in the style of
Mettu & Plaxton's online-medoid construction and nearest-neighbor
incremental assignment (Yadav et al.):

* each incoming prompt is assigned to the cluster of its **nearest
  registered boundary** — the longest ``(fed, digest)`` candidate that
  matches a registered entry on any shard (digest-prefix
  nearest-neighbor; token equality verified);
* an unmatched prompt is tracked by its shortest boundary digest (its
  *family*); when a family recurs ``promote_after`` times the digest is
  promoted to a cluster **medoid** (Mettu–Plaxton-style: recurring mass
  at a point makes it a center) and subsequent members assign to it;
* the engine steers same-cluster requests onto the data shards already
  holding that cluster's entries (``shard_affinity``), extending the
  ``match_len`` steering so back-to-back template bursts land where
  their blocks live.

Per-cluster cohesion (matched prefix tokens / prompt tokens), hit rate,
and bytes pinned are reported through ``stats()`` / ``cluster_stats()``
into ``last_stats`` and the serve benchmark.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.prefix_cache import (PrefixCache, PrefixEntry,
                                              PrefixShareConfig)


@dataclasses.dataclass(frozen=True)
class TemplateStoreConfig:
    """Knobs for the persistent template store
    (``ServerConfig.template_store``).

    ``max_entries``/``min_prefix`` mean what they mean for
    ``PrefixShareConfig`` — but entries now pin pool blocks *between*
    serves too, so ``max_entries`` bounds the standing pinned-memory
    cost of an idle server, not just a transient within one stream.
    ``promote_after`` is the Mettu–Plaxton recurrence threshold: how
    many times an unmatched prompt family must be seen before its
    digest is promoted to a cluster medoid.  ``retire_after`` is the
    recurrence-*decay* twin (0 = never retire): a medoid whose cluster
    saw no member, hit, or registration for that many ``assign()``
    ticks is pruned — a long-lived server sheds dead
    ``TemplateCluster`` records instead of accumulating every template
    family it ever met, the symmetric counterpart of promotion (mass
    arriving makes a center; mass decaying unmakes it).  Unpromoted
    family recurrence counts decay on the same clock."""
    max_entries: int = 32
    min_prefix: int = 0
    promote_after: int = 2
    retire_after: int = 0


@dataclasses.dataclass
class TemplateCluster:
    cid: int
    medoid: bytes             # digest of the medoid prefix boundary
    medoid_fed: int           # boundary length of the medoid, in tokens
    members: int = 0          # requests assigned (lifetime)
    hits: int = 0             # store hits by members
    tokens_reused: int = 0    # prompt tokens members skipped
    prompt_tokens: int = 0    # total prompt tokens over members
    matched_tokens: int = 0   # matched boundary tokens at assignment
    last_seen: int = 0        # assign-tick of last member/hit activity

    @property
    def cohesion(self) -> float:
        """How much of the cluster's prompt mass its shared boundary
        explains (1.0 = members are pure template repeats)."""
        return self.matched_tokens / max(self.prompt_tokens, 1)

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.members, 1)


class TemplateStore(PrefixCache):
    """Cross-serve ``PrefixCache``: same per-shard boundary maps and the
    same engine-facing API, plus epoch-stamped persistence, scored
    eviction, and online traffic clustering.  Construct it unbound; the
    server binds it to its pool (and epoch) at each serve."""

    def __init__(self, cfg: Optional[TemplateStoreConfig] = None):
        self.tcfg = cfg or TemplateStoreConfig()
        super().__init__(PrefixShareConfig(
            max_entries=self.tcfg.max_entries,
            min_prefix=self.tcfg.min_prefix), 1, None)
        self.epoch: object = None
        self.invalidations = 0
        self._clusters: Dict[int, TemplateCluster] = {}
        # digest -> (recurrences, last assign-tick seen)
        self._families: Dict[bytes, Tuple[int, int]] = {}
        self._medoid_cid: Dict[bytes, int] = {}  # promoted digest -> cid
        self._next_cid = 0
        self._tick = 0                 # assign() clock for retirement
        self.clusters_retired = 0
        # canonical warm-handoff slot: (pool, device cache, epoch,
        # n_shards) parked by the server at end-of-serve.  Living on the
        # STORE (not the Server) makes the epoch's content-hashed weight
        # stamp meaningful — a brand-new Server over a reloaded pytree
        # with identical bytes adopts the parked pool + cache and keeps
        # every pin, instead of cold-binding on pool identity.  Adoption
        # clears the slot eagerly (single ownership: an older server
        # serving afterwards simply rebinds cold).
        self.parked: Optional[tuple] = None

    @property
    def share(self) -> PrefixShareConfig:
        """The engine-facing prefix-sharing view of this store."""
        return self.cfg

    # ------------------------------------------------------------------
    # persistence lifecycle
    # ------------------------------------------------------------------

    def bind(self, epoch, n_shards: int, pool) -> bool:
        """Attach the store to a serve's pool under a config epoch.
        Same (epoch, pool, shard count) as the previous bind → warm
        rebind, entries kept.  Anything else → the previous contents are
        invalidated first: a new ``KVCompressConfig``, model params, or
        pool can never adopt a stale snapshot.  Returns True when the
        store came up cold (invalidated or first bind)."""
        if (self.pool is pool and self.epoch == epoch
                and len(self._maps) == n_shards):
            return False
        if self.pool is not None:
            self.invalidate()
        self.epoch = epoch
        self.pool = pool
        self._maps = [{} for _ in range(max(n_shards, 1))]
        return True

    def invalidate(self) -> None:
        """Drop every entry (releasing its pinned blocks against the
        pool it was registered with) and reset the traffic clustering.
        Lifetime hit counters survive — per-serve stats are deltas."""
        for shard in range(len(self._maps)):
            for key in list(self._maps[shard]):
                e = self._maps[shard][key]
                if e.in_flight:
                    raise RuntimeError(
                        "invalidate with an adoption in flight — the "
                        "engine must finish restoring before the store "
                        "can drop the entry under it")
                self._drop(shard, key)
        self._clusters.clear()
        self._families.clear()
        self._medoid_cid.clear()
        self.parked = None
        self.invalidations += 1

    def pinned_blocks(self) -> int:
        """Distinct physical blocks the store keeps alive — the pool's
        end-of-serve drain target: ``pool.allocated() == pinned_blocks()``
        once every request has exited."""
        gids = set()
        for m in self._maps:
            for e in m.values():
                gids.update(e.blocks.values())
        return len(gids)

    # ------------------------------------------------------------------
    # scored eviction (overrides pure LRU)
    # ------------------------------------------------------------------

    def evict_lru(self, shard: int) -> bool:
        """Evict the entry with the lowest hits × tokens-reused score
        (LRU stamp breaks ties among never-hit entries): under pool
        pressure the store keeps the templates that earn their pinned
        blocks.  Entries mid-adoption are skipped.  Keeps the base-class
        name — the engine's reclaim paths call it blindly."""
        m = self._maps[shard]
        cands = [k for k, e in m.items() if e.in_flight == 0]
        if not cands:
            return False
        key = min(cands, key=lambda k: (m[k].hits * m[k].fed, m[k].stamp))
        self._drop(shard, key)
        return True

    # ------------------------------------------------------------------
    # incremental traffic clustering
    # ------------------------------------------------------------------

    def _promote(self, dig: bytes, fed: int) -> int:
        cid = self._medoid_cid.get(dig)
        if cid is None:
            cid = self._next_cid
            self._next_cid += 1
            self._medoid_cid[dig] = cid
            self._clusters[cid] = TemplateCluster(cid=cid, medoid=dig,
                                                  medoid_fed=fed,
                                                  last_seen=self._tick)
            self._families.pop(dig, None)
        return cid

    def _touch(self, cid: int) -> None:
        c = self._clusters.get(cid)
        if c is not None:
            c.last_seen = self._tick

    def _retire(self) -> None:
        """Recurrence-decay pruning (Mettu–Plaxton in reverse): drop
        clusters idle for ``retire_after`` assign ticks and family
        counts just as stale.  Entries of a retired cluster stay valid
        (their snapshots/blocks are cluster-agnostic) but de-associate
        — a later recurrence re-promotes from scratch, exactly like a
        never-seen family."""
        horizon = self._tick - self.tcfg.retire_after
        dead = [cid for cid, c in self._clusters.items()
                if c.last_seen < horizon]
        for cid in dead:
            c = self._clusters.pop(cid)
            self._medoid_cid.pop(c.medoid, None)
            for m in self._maps:
                for e in m.values():
                    if e.cluster == cid:
                        e.cluster = -1
            self.clusters_retired += 1
        for dig in [d for d, (_, seen) in self._families.items()
                    if seen < horizon]:
            del self._families[dig]

    def assign(self, prompt: np.ndarray,
               digests: List[Tuple[int, bytes]]) -> int:
        """Assign one incoming request to a prefix cluster (call once
        per request).  Nearest-neighbor over registered boundaries,
        longest first; unmatched prompts accrue family recurrences until
        medoid promotion.  Returns the cluster id, or -1 while the
        prompt's family is still below the promotion threshold."""
        self._tick += 1
        if self.tcfg.retire_after > 0:
            self._retire()
        plen = len(prompt)
        for fed, dig in digests:
            for m in self._maps:
                e = m.get((fed, dig))
                if e is not None and np.array_equal(e.tokens, prompt[:fed]):
                    if e.cluster < 0:
                        # entry registered before its family recurred:
                        # the recurrence is happening now — promote
                        e.cluster = self._promote(dig, fed)
                    c = self._clusters[e.cluster]
                    c.members += 1
                    c.matched_tokens += fed
                    c.prompt_tokens += plen
                    c.last_seen = self._tick
                    return e.cluster
        if not digests:
            return -1
        fam_fed, fam_dig = digests[-1]   # shortest boundary = family key
        cid = self._medoid_cid.get(fam_dig)
        if cid is None:
            seen = self._families.get(fam_dig, (0, 0))[0] + 1
            self._families[fam_dig] = (seen, self._tick)
            if seen < self.tcfg.promote_after:
                return -1
            cid = self._promote(fam_dig, fam_fed)
        c = self._clusters[cid]
        c.members += 1
        c.prompt_tokens += plen
        c.last_seen = self._tick
        return cid

    def shard_affinity(self, shard: int, cid: int) -> int:
        """Entries of cluster ``cid`` living on ``shard`` — the steering
        signal that sends same-cluster requests back-to-back onto the
        shards already holding their blocks."""
        if cid < 0:
            return 0
        return sum(1 for e in self._maps[shard].values()
                   if e.cluster == cid)

    def lookup(self, shard: int, prompt: np.ndarray, chunk: int,
               digests: Optional[List[Tuple[int, bytes]]] = None,
               ) -> Optional[PrefixEntry]:
        e = super().lookup(shard, prompt, chunk, digests=digests)
        if e is not None and e.cluster >= 0:
            c = self._clusters.get(e.cluster)
            if c is not None:
                c.hits += 1
                c.tokens_reused += e.fed
                c.last_seen = self._tick
        return e

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------

    def cluster_stats(self) -> List[Dict[str, float]]:
        """Per-cluster records (largest membership first)."""
        out = []
        for c in sorted(self._clusters.values(),
                        key=lambda c: (-c.members, c.cid)):
            gids = set()
            for m in self._maps:
                for e in m.values():
                    if e.cluster == c.cid:
                        gids.update(e.blocks.values())
            out.append({"cid": float(c.cid), "members": float(c.members),
                        "hits": float(c.hits),
                        "hit_rate": float(c.hit_rate),
                        "tokens_reused": float(c.tokens_reused),
                        "cohesion": float(c.cohesion),
                        "blocks_pinned": float(len(gids))})
        return out

    def publish(self, reg, bytes_per_block: float = 0.0,
                max_clusters: int = 8) -> None:
        """Publish store metrics into a telemetry registry (duck-typed).

        Key names match :meth:`stats` plus the per-cluster
        ``template_cluster{cid}_*`` trio for the ``max_clusters`` largest
        clusters.  Lifetime ``*_total`` counters register with
        ``persist=True`` (the store outlives serves) and republish via
        ``set_to``; everything else is a per-serve gauge, so stale
        cluster keys from a previous serve can never leak."""
        st = self.stats()
        reg.gauge("template_entries",
                  "prefix entries registered in the store"
                  ).set(st["template_entries"])
        reg.gauge("template_pinned_blocks",
                  "pool blocks pinned by store entries"
                  ).set(st["template_pinned_blocks"])
        reg.counter("template_hits_total",
                    "lifetime prefix-adoption hits", persist=True
                    ).set_to(st["template_hits_total"])
        reg.counter("template_tokens_reused_total",
                    "lifetime prompt tokens adopted from the store",
                    persist=True).set_to(st["template_tokens_reused_total"])
        reg.gauge("template_clusters",
                  "live traffic clusters").set(st["template_clusters"])
        reg.counter("template_clusters_retired",
                    "clusters retired under recurrence decay", persist=True
                    ).set_to(st["template_clusters_retired"])
        reg.gauge("template_cohesion_mean",
                  "mean matched/prompt token cohesion over live clusters"
                  ).set(st["template_cohesion_mean"])
        reg.gauge("template_bytes_pinned",
                  "bytes of tail KV pinned by store entries"
                  ).set(st["template_pinned_blocks"] * bytes_per_block)
        for c in self.cluster_stats()[:max_clusters]:
            cid = int(c["cid"])
            reg.gauge(f"template_cluster{cid}_cohesion",
                      f"cluster {cid}: matched/prompt cohesion"
                      ).set(c["cohesion"])
            reg.gauge(f"template_cluster{cid}_hit_rate",
                      f"cluster {cid}: hits per member admission"
                      ).set(c["hit_rate"])
            reg.gauge(f"template_cluster{cid}_bytes_pinned",
                      f"cluster {cid}: bytes pinned by its entries"
                      ).set(c["blocks_pinned"] * bytes_per_block)

    def stats(self) -> Dict[str, float]:
        live = [c for c in self._clusters.values() if c.members]
        coh = [c.cohesion for c in live]
        return {
            "template_entries": float(sum(len(m) for m in self._maps)),
            "template_pinned_blocks": float(self.pinned_blocks()),
            "template_hits_total": float(self.hits),
            "template_tokens_reused_total": float(self.tokens_reused),
            "template_clusters": float(len(live)),
            "template_clusters_retired": float(self.clusters_retired),
            "template_cohesion_mean": (float(np.mean(coh)) if coh
                                       else 0.0),
        }
