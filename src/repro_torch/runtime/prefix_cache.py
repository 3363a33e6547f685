"""Prefix-sharing admission cache for the paged clustered-KV engine (port
of ``repro.runtime.prefix_cache``, host numpy, copied whole).

Bursty, templated traffic — the dominant serving regime the paper's
request-processing half targets — sends many prompts that share a long
common prefix (system prompt, few-shot template, document header).  The
paged engine already stores every slot's exact tail ring as pool blocks
behind per-slot block tables with ref counts (runtime/kv_pool.py), so
two requests whose prompts agree on a prefix can point their tables at
the *same* physical blocks: K/V at position ``p`` is a pure function of
tokens ``[0, p]`` under causal attention, so the bytes are identical by
construction.  The streaming-clustering results this repo builds on
(He et al.; Mettu & Plaxton) make the same argument for the summaries:
the admission-time centroid state after ``F`` streamed tokens is a
deterministic function of those tokens alone, so it too can be reused
across requests instead of recomputed.

This module is the host-side index that makes that sharing safe:

  * **Entries are registered at chunk boundaries** of a chunked
    admission (``fed`` a multiple of ``prefill_chunk`` and strictly less
    than the prompt length).  At exactly those moments a slot's
    clustered state — centroids, counts, coverage frontier, and the live
    ring blocks — is *prefix-pure*: a function of ``tokens[:fed]``, the
    chunk size, and the compression config only.  (Anything later mixes
    in the prompt's total length via the final absorb target, and decode
    mixes in generated tokens; neither is shareable.)  Per-slot
    compaction gating in ``kv_compress.recompact_clustered`` keeps this
    true even when neighbouring slots force compaction passes at
    arbitrary engine steps.
  * An entry holds the prefix tokens themselves (hashes only route the
    lookup — equality is verified before any reuse), the ``(fed, cov)``
    pair, the live ring-block ids (each ``retain``-ed so donor exit or
    give-back cannot free the payload while the entry lives), and an
    opaque device snapshot of the slot's centroid rows taken by the
    engine.
  * **Shard locality**: block ids are only meaningful on the data shard
    that owns them, so the map is per shard and a request admitted on
    shard ``s`` can only reuse shard-``s`` entries (one device is one
    shard).  On a mesh every rank keeps every shard's map; the snapshot
    of an entry is held only by the ranks of its shard (their head block
    of it), the others keep None.
  * **LRU + pressure eviction**: beyond ``max_entries`` per shard — or
    whenever the engine needs blocks back (pool pressure) — the least
    recently used entry releases its refs.  Entries are a cache, never
    an obligation: dropping one only costs re-prefilling.  Shorter
    prefixes of a registered stream are kept alongside longer ones: the
    chunk boundary just before a stream's unique suffix is the entry
    other suffixes actually hit.

Copy-on-write (kv_pool.ensure) is what keeps adopted blocks immutable:
any slot writing into a block with ``ref > 1`` gets a fresh copy first,
so an entry's payload can never be clobbered by a divergent suffix.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.kv_pool import BlockPool


@dataclasses.dataclass(frozen=True)
class PrefixShareConfig:
    """Engine-facing prefix-sharing knobs (ServerConfig.prefix_share).

    Requires the paged engine with chunked prefill: block-granular
    sharing needs the block pool, and prefix-pure registration points
    only exist on the chunked admission schedule.

    ``max_entries`` is the pinned-memory knob: every entry retains its
    live ring blocks (~keep_recent/block_size blocks), so a shard can
    pin up to ``max_entries`` windows of tail KV on top of the slots'
    own usage.  Single-template burst traffic wants it SMALL (1-2: one
    boundary per template is all that ever hits, and a tight cap keeps
    the physical peak below unshared serving — the regime
    benchmarks/run.py prefix_share pins); diverse prefixes or suffixes
    spanning several chunks want it larger so the boundary just before
    each stream's divergence stays registered.  Pool pressure evicts
    entries LRU-first regardless, so an oversized cap degrades to
    re-prefilling, never to PoolExhausted."""
    max_entries: int = 32     # LRU capacity per data shard
    min_prefix: int = 0       # shortest prefix worth an entry, in tokens
                              # (0 = one admission chunk)


@dataclasses.dataclass
class PrefixEntry:
    tokens: np.ndarray        # the prefix itself; verified on every hit
    fed: int                  # tokens streamed when the state was taken
    cov: int                  # coverage frontier at that point
    blocks: Dict[int, int]    # ring-block idx -> retained global block id
    snap: object              # device snapshot of the slot's clustered
                              # rows (k_cents/v_cents/counts/cov), taken
                              # and restored by the engine
                              # (transformer.clustered_slot_state; on a
                              # mesh None off the entry's data shard)
    stamp: int = 0            # LRU clock
    hits: int = 0             # times this entry was adopted
    cluster: int = -1         # template_store traffic cluster (-1 = none)
    in_flight: int = 0        # adoptions between lookup and restore —
                              # a nonzero count pins the entry against
                              # eviction (see ``adoption_done``)


def _digest(tokens: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(tokens, np.int32).tobytes(),
                           digest_size=16).digest()


class PrefixCache:
    """Per-data-shard prefix → (blocks, snapshot) map (host side)."""

    def __init__(self, cfg: PrefixShareConfig, n_shards: int,
                 pool: BlockPool):
        self.cfg = cfg
        self.pool = pool
        self._maps: List[Dict[Tuple[int, bytes], PrefixEntry]] = [
            {} for _ in range(max(n_shards, 1))]
        self._clock = 0
        self.hits = 0
        self.tokens_reused = 0

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------

    def _candidate_feds(self, prompt_len: int, chunk: int) -> List[int]:
        """Reusable prefix lengths for a prompt, longest first: chunk
        multiples strictly below the prompt length (at least one token
        must still stream through the model to produce the request's
        first logits), floored at min_prefix."""
        lo = max(self.cfg.min_prefix, chunk)
        top = ((prompt_len - 1) // chunk) * chunk
        return [f for f in range(top, lo - 1, -chunk)]

    def prefix_digests(self, prompt: np.ndarray,
                       chunk: int) -> List[Tuple[int, bytes]]:
        """Candidate (fed, digest) pairs for a prompt, longest first.
        Hashing is the only O(prompt²/chunk) part of a lookup — the
        engine computes this once per request and passes it to every
        ``match_len``/``lookup`` instead of re-hashing per shard per
        engine step while the request queues."""
        return [(f, _digest(prompt[:f]))
                for f in self._candidate_feds(len(prompt), chunk)]

    def match_len(self, shard: int, prompt: np.ndarray, chunk: int,
                  digests: Optional[List[Tuple[int, bytes]]] = None) -> int:
        """Longest reusable prefix length available on ``shard`` (0 =
        none) — admission steering, no LRU side effects."""
        m = self._maps[shard]
        for fed, dig in (digests if digests is not None
                         else self.prefix_digests(prompt, chunk)):
            e = m.get((fed, dig))
            if e is not None and np.array_equal(e.tokens, prompt[:fed]):
                return fed
        return 0

    def lookup(self, shard: int, prompt: np.ndarray, chunk: int,
               digests: Optional[List[Tuple[int, bytes]]] = None,
               ) -> Optional[PrefixEntry]:
        """Longest verified entry matching the prompt on ``shard``.

        The returned entry is marked **in flight**: until the caller
        declares ``adoption_done(entry)`` it cannot be evicted, so a
        pool-pressure reclaim landing between the match and the
        block-adopt/snapshot-restore can never release the blocks the
        admitting slot is about to resume from."""
        m = self._maps[shard]
        for fed, dig in (digests if digests is not None
                         else self.prefix_digests(prompt, chunk)):
            e = m.get((fed, dig))
            if e is not None and np.array_equal(e.tokens, prompt[:fed]):
                self._clock += 1
                e.stamp = self._clock
                e.hits += 1
                e.in_flight += 1
                self.hits += 1
                self.tokens_reused += fed
                return e
        return None

    def adoption_done(self, entry: PrefixEntry) -> None:
        """Release the in-flight pin taken by ``lookup`` — the adopting
        slot holds its own block refs (``pool.adopt``) and has restored
        the snapshot, so the entry is evictable again."""
        if entry.in_flight <= 0:
            raise ValueError("adoption_done without a matching lookup")
        entry.in_flight -= 1

    # ------------------------------------------------------------------
    # registration / eviction
    # ------------------------------------------------------------------

    def register(self, shard: int, prompt: np.ndarray, fed: int, cov: int,
                 blocks: Dict[int, int], snap, cluster: int = -1) -> bool:
        """Register the prefix state at ``fed`` tokens.  Retains every
        listed block.  Returns False (and retains nothing) when an
        identical entry already exists.

        Shorter prefixes of the same tokens are deliberately KEPT: the
        boundary just before a stream's unique suffix (e.g. the pure
        template) is exactly the entry later requests with *different*
        suffixes will hit — evicting it when the stream registers a
        suffix-contaminated longer boundary would collapse the hit rate
        whenever suffixes exceed one chunk.  Capacity is bounded by the
        per-shard LRU cap here and by pool-pressure eviction in the
        engine instead."""
        m = self._maps[shard]
        key = (fed, _digest(prompt[:fed]))
        if key in m:
            self._clock += 1
            m[key].stamp = self._clock
            return False
        for gid in blocks.values():
            self.pool.retain(gid)
        self._clock += 1
        m[key] = PrefixEntry(tokens=np.array(prompt[:fed], np.int32),
                             fed=fed, cov=cov, blocks=dict(blocks),
                             snap=snap, stamp=self._clock, cluster=cluster)
        while len(m) > self.cfg.max_entries:
            if not self.evict_lru(shard):
                break   # every other entry is mid-adoption: over-stay
        return True

    def _drop(self, shard: int, key) -> None:
        e = self._maps[shard].pop(key)
        for gid in e.blocks.values():
            self.pool.release(gid)

    def evict_lru(self, shard: int) -> bool:
        """Release the least recently used entry's blocks (pool-pressure
        reclaim).  Entries with an adoption in flight are pinned — the
        admitting slot has matched but not yet adopted/restored, and
        evicting under it would hand its blocks back to the free list
        mid-resume.  Returns False when nothing is evictable."""
        m = self._maps[shard]
        cands = [k for k, e in m.items() if e.in_flight == 0]
        if not cands:
            return False
        key = min(cands, key=lambda k: m[k].stamp)
        self._drop(shard, key)
        return True

    def entries(self, shard: int) -> int:
        return len(self._maps[shard])

    def clear(self) -> None:
        """Release every entry (end of serve: the pool must drain).
        Raises if an adoption is still in flight — by the time a serve
        drains, every ``lookup`` has seen its ``adoption_done``."""
        for shard in range(len(self._maps)):
            for key in list(self._maps[shard]):
                if self._maps[shard][key].in_flight:
                    raise RuntimeError(
                        "clear with an adoption in flight — the engine "
                        "must finish restoring before the cache drops "
                        "the entry under it")
                self._drop(shard, key)
