"""Paged clustered-KV memory manager (port of ``repro.runtime.kv_pool``,
host numpy, copied whole): a block-pool allocator for the
tail rings of the clustered KV cache (PagedAttention-style memory
management built on the paper's clustering-as-memory-manager thesis).

The dense engine allocates every slot's exact tail as a contiguous
``(slots, R, H, Dh)`` ring — a finished slot, an empty slot, and a slot
whose ring is mostly *covered* (positions already folded into centroids)
all pay the full ``R``.  The paged engine instead carves the tail into
fixed-size blocks of ``block_size`` positions drawn from a shared
per-shard pool:

  * ring offset ``r`` lives at offset ``r % block_size`` of the block at
    ``block_table[slot, r // block_size]`` — the ring *semantics* (position
    ``p`` at offset ``p % R``) are unchanged, only the storage is
    scattered, so the dense and paged engines stay token-identical;
  * blocks are allocated lazily right before the decode/chunk write that
    first touches them, recycled the moment a request exits, and returned
    mid-stream by compaction: once the coverage frontier ``cov`` passes
    every position a block claims, the block's payload is dead (centroids
    summarize it) and it goes back to the free list;
  * one block table is shared by every layer's pool: all clustered leaves
    of a slot advance in lockstep (same ``t``/``cov``), so a single
    (slot, ring-block) → physical-block mapping serves the whole stack;
  * the pool backs the **ring family only** (core/layer_state.py):
    recurrent-state layers ('M'/'R') carry a fixed-size per-slot state
    with no position-indexed tail — block tables skip them entirely, and
    their bytes are accounted separately (``mapped_blocks`` prices a
    slot's pool footprint; the engine adds recurrent state bytes on top
    for victim selection and swap payloads).

The allocator itself is host-side (the engine loop is host-driven and the
table is pushed to the device as a small int32 array each launch); the
block *payloads* are device-resident pool arrays inside the cache pytree
(``k_tail``/``v_tail`` become ``(n_blocks, block_size, H, Dh)``) — in
the reference sharded over the data mesh axis exactly like slots.

Ref counts are kept per block so the prefix-sharing admission path
(runtime/prefix_cache.py) can map one physical block into several slots:
``adopt`` installs an extra table mapping onto a live block and
``retain``/``release`` let the prefix cache hold blocks alive with no
table mapping at all.

**Retire-safety argument, in policy terms**: the pool never decides
*what* is dead — a :class:`repro_torch.core.retention.RetentionPolicy` does.
``free_retired(slot, t, policy)`` frees a block exactly when every
position it claims is retired under the policy: claimed position ``p``
is dead iff ``p < policy.retire_lo(slot, t)`` (frontier mode: absorbed
into centroids; window mode: outside the model's own attention window)
or ``p >= t`` and the policy does not ``keep_unwritten`` (the offset was
never written — quota mode keeps these because admission reserved them).
This is safe for *any* policy with monotone ``retire_lo`` because a ring
offset's claimed position only changes when the offset is written, and
every write re-allocates through ``ensure`` first — so a freed block's
payload can never be read again: the masks (cov / window / qpos) that
gate the decode kernels exclude exactly the retired positions the sweep
freed.  ``free_covered`` survives as the frontier-policy wrapper.

**Copy-on-write rule** (the sharing twin of the retire-safety
argument): a ring write may only land in a block the writing slot
owns *exclusively* (``ref == 1``).  ``ensure`` — which every engine-side
ring write goes through first — enforces it: when the write's target
block has ``ref > 1``, a fresh block is allocated from the slot's shard,
the slot's table entry is swapped to it, the shared block's ref is
dropped, and the (src, dst) pair is returned so the engine copies the
payload on device *before* the write executes.  Together with
``free_covered``'s invariant (a ring offset's claimed position only
changes when written, and every write re-allocates through ``ensure``
first), this means a shared block's payload is immutable for as long as
anyone else holds a reference — readers of a shared prefix can never
observe another slot's divergent suffix.

The ref counts back the allocator invariants pinned in
tests/test_torch_kv_pool.py: no double allocation, alloc/free conservation,
live block tables only, no free-list entry with ``ref > 0``, and
COW never mutating a block someone else still references.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Engine-facing paged-KV knobs (ServerConfig.paged).

    ``block_size`` positions per block (must divide the clustered tail
    ``keep_recent``); ``pool_blocks`` blocks per data shard shared by all
    of that shard's slots — 0 = full provisioning (``slots_per_shard *
    keep_recent / block_size``, never exhausts); sizing below that
    oversubscribes memory and relies on admission laziness + compaction
    returning covered blocks (PoolExhausted if a burst outruns it)."""
    block_size: int = 16
    pool_blocks: int = 0


class PoolExhausted(RuntimeError):
    """The per-shard free list ran dry.  Raise rather than silently
    spilling: the caller chose the oversubscription ratio."""


def ring_claims(t: int, r: int) -> np.ndarray:
    """Host mirror of kv_compress.ring_positions: the absolute position
    each of the ``r`` ring offsets claims at watermark ``t`` (next write
    goes to offset ``t % r``)."""
    s = np.arange(r)
    if t <= r:
        return s
    return t - r + np.mod(s - t, r)


def live_blocks(t: int, cov: int, r: int, block_size: int) -> List[int]:
    """Ring-block indices holding at least one live position (claimed
    position in ``[cov, t)``) at watermark ``t``."""
    claims = ring_claims(t, r)
    live = (claims >= cov) & (claims < t)
    return sorted(set((np.nonzero(live)[0] // block_size).tolist()))


def write_blocks(start: int, count: int, r: int, block_size: int) -> List[int]:
    """Ring-block indices touched by writing positions
    ``start .. start+count-1`` (a decode token or a prompt chunk)."""
    offs = np.mod(start + np.arange(count), r)
    return sorted(set((offs // block_size).tolist()))


class _InlineFrontier:
    """Minimal frontier-policy view for ``free_covered`` (duck-typed so
    the pool never imports core.retention)."""

    keep_unwritten = False

    def __init__(self, cov: int, exclude: Sequence[int] = ()):
        self._cov = int(cov)
        self._excl = frozenset(int(b) for b in exclude)

    def retire_lo(self, slot: int, t: int) -> int:
        return self._cov

    def protected_blocks(self, slot: int):
        return self._excl


class BlockPool:
    """Free-list block allocator with per-slot block tables.

    Physical block ids are *global* (``shard * pool_blocks + local``):
    shard ``s`` owns exactly the ids ``[s*pool_blocks, (s+1)*pool_blocks)``
    — a slot only ever references blocks of its own shard, which is what
    lets the kernel run per mesh shard without collectives (mesh serving
    is a later slice of the port; one device is one shard).
    """

    def __init__(self, n_slots: int, tail: int, cfg: PagedKVConfig,
                 n_shards: int = 1, slots_per_shard: Optional[int] = None,
                 full_tail_resident: bool = True):
        if tail % cfg.block_size != 0:
            raise ValueError(
                f"block_size {cfg.block_size} must divide the clustered "
                f"tail keep_recent={tail}")
        self.cfg = cfg
        self.tail = tail
        self.block_size = cfg.block_size
        self.blocks_per_slot = tail // cfg.block_size      # T
        self.n_slots = n_slots
        self.n_shards = max(n_shards, 1)
        self.slots_per_shard = (slots_per_shard
                                or max(n_slots // self.n_shards, 1))
        self.pool_blocks = (cfg.pool_blocks or
                            self.slots_per_shard * self.blocks_per_slot)
        # under FrontierRetention a slot at depth >= tail keeps its whole
        # ring mapped, so a pool that can't hold one ring is dead on
        # arrival; under QuotaRetention residency is only the admitted
        # budget (<= blocks_per_slot), so a smaller pool still serves and
        # an unservable request surfaces via the zero-progress backstop
        if full_tail_resident and self.pool_blocks < self.blocks_per_slot:
            raise ValueError(
                f"pool_blocks {self.pool_blocks} cannot hold even one "
                f"slot's tail ({self.blocks_per_slot} blocks)")
        self.n_blocks = self.n_shards * self.pool_blocks
        # -1 = unmapped; otherwise a global physical block id
        self.table = np.full((n_slots, self.blocks_per_slot), -1, np.int32)
        self.ref = np.zeros(self.n_blocks, np.int32)
        # per-block generation, bumped when a block returns to the free
        # list.  A swap record that remembers (gid, gen) can prove at
        # resume time that the block was never recycled in between — and
        # since a live shared block's payload is immutable under the COW
        # rule, an unchanged generation means the device bytes still
        # match the host copy and the re-upload can be skipped entirely
        # (scheduler re-adoption fast path).
        self.gen = np.zeros(self.n_blocks, np.int64)
        # min-heaps per shard (lowest free id first, O(log n) alloc/free)
        self._free: List[List[int]] = [
            list(range(s * self.pool_blocks, (s + 1) * self.pool_blocks))
            for s in range(self.n_shards)
        ]
        self._live = 0
        self._live_shard = np.zeros(self.n_shards, np.int64)
        self.peak_blocks = 0
        self.peak_blocks_shard = np.zeros(self.n_shards, np.int64)
        self.n_allocs = 0
        self.n_frees = 0
        self.n_retains = 0         # extra refs taken (adopt/retain)
        self.n_cow = 0             # copy-on-write block swaps
        # set on every table mutation; the engine caches the device copy
        # of the table and only re-uploads when this flips
        self.dirty = True

    # ------------------------------------------------------------------
    # shard bookkeeping
    # ------------------------------------------------------------------

    def shard_of(self, slot: int) -> int:
        return min(slot // self.slots_per_shard, self.n_shards - 1)

    def shard_base(self, slot: int) -> int:
        return self.shard_of(slot) * self.pool_blocks

    # ------------------------------------------------------------------
    # alloc / free
    # ------------------------------------------------------------------

    def allocated(self) -> int:
        """Physical live blocks — blocks mapped by several slots (or
        pinned by the prefix cache) count ONCE (occupancy and peak-KV
        stats must not double-count shared blocks)."""
        return self._live

    def free_blocks(self, shard: int) -> int:
        """Free-list depth for one data shard — how many fresh blocks
        ``alloc`` can hand out there before ``PoolExhausted``."""
        return len(self._free[shard])

    def mapped_blocks(self, slot: int) -> int:
        """Blocks slot ``slot`` currently maps.  This is the slot's
        ENTIRE pool footprint: the pool backs ring-family tail KV only
        (core/layer_state.py) — recurrent-state layers carry fixed-size
        per-slot state outside the pool, priced separately by the
        engine's victim/swap accounting."""
        return int((self.table[slot] >= 0).sum())

    def shared_extra(self) -> int:
        """Logical table mappings beyond one per physical block — the
        blocks-worth of tail KV that prefix sharing avoided
        materializing at this instant."""
        vals = self.table[self.table >= 0]
        return int(vals.size - np.unique(vals).size)

    def reset_peaks(self) -> None:
        """Start a fresh peak-tracking window from the current live
        occupancy — a pool persisting across serves (template store)
        reports per-serve peaks, not a lifetime high-water mark."""
        self.peak_blocks = self._live
        self.peak_blocks_shard = self._live_shard.copy()

    def _fresh(self, slot: int) -> int:
        """Pop a free block of the slot's shard.  Lowest free id first
        (deterministic)."""
        s = self.shard_of(slot)
        if not self._free[s]:
            raise PoolExhausted(
                f"KV block pool exhausted on data shard {s}: "
                f"{self.pool_blocks} blocks all live — raise "
                f"pool_blocks or shorten refresh_every so compaction "
                f"returns covered blocks sooner")
        gid = heapq.heappop(self._free[s])
        self.ref[gid] = 1
        self.n_allocs += 1
        self._live += 1
        self._live_shard[s] += 1
        self.peak_blocks = max(self.peak_blocks, self._live)
        self.peak_blocks_shard[s] = max(self.peak_blocks_shard[s],
                                        self._live_shard[s])
        return gid

    def alloc(self, slot: int, block_idx: int) -> int:
        """Map (slot, ring-block ``block_idx``) to a fresh physical block
        from the slot's shard; existing mappings are returned as is."""
        if self.table[slot, block_idx] >= 0:
            return int(self.table[slot, block_idx])
        gid = self._fresh(slot)
        self.table[slot, block_idx] = gid
        self.dirty = True
        return gid

    def ensure(self, slot: int, block_indices: Sequence[int],
               pairs: Optional[List[Tuple[int, int]]] = None,
               ) -> List[Tuple[int, int]]:
        """Make every listed ring block writable by ``slot``: unmapped
        blocks get a fresh allocation, and mapped blocks with ``ref > 1``
        are COPY-ON-WRITE swapped — a fresh block replaces the shared one
        in this slot's table and the shared ref is dropped.  The
        (src_gid, dst_gid) pairs the caller must copy on device BEFORE
        the write that prompted the ensure are appended to ``pairs`` (and
        returned).  Raises PoolExhausted mid-list without rolling back
        earlier allocations or COW swaps — pass a caller-owned ``pairs``
        list when a retry/stall path catches the exception, because a
        swap already performed will NOT re-emit its pair on retry (the
        fresh block is exclusively owned by then) and dropping it would
        skip the payload copy and leave the new block uninitialized."""
        if pairs is None:
            pairs = []
        for bi in block_indices:
            gid = int(self.table[slot, bi])
            if gid < 0:
                self.alloc(slot, bi)
            elif self.ref[gid] > 1:
                nid = self._fresh(slot)
                self.table[slot, bi] = nid
                self.dirty = True
                self.n_cow += 1
                self._release(gid)
                pairs.append((gid, nid))
        return pairs

    def retain(self, gid: int) -> None:
        """Take an extra reference on a live block (prefix sharing: the
        prefix cache pins registered blocks, tables aside)."""
        if self.ref[gid] <= 0:
            raise ValueError(f"retain of dead block {gid} (ref "
                             f"{int(self.ref[gid])})")
        self.ref[gid] += 1
        self.n_retains += 1

    def release(self, gid: int) -> None:
        """Drop a reference taken with ``retain``.  Releasing a dead
        block raises cleanly BEFORE any mutation — the count never
        underflows and the free list can never see a double insert."""
        self._release(gid)

    def adopt(self, slot: int, block_idx: int, gid: int) -> None:
        """Map an (unmapped) ring block of ``slot`` onto a live shared
        block — the prefix-sharing admission fast path.  The block must
        belong to the slot's shard (the kernel gathers shard-locally)."""
        if self.table[slot, block_idx] >= 0:
            raise ValueError(
                f"slot {slot} ring block {block_idx} already mapped")
        if gid // self.pool_blocks != self.shard_of(slot):
            raise ValueError(f"block {gid} is not on slot {slot}'s shard")
        self.retain(gid)
        self.table[slot, block_idx] = gid
        self.dirty = True

    def _release(self, gid: int) -> None:
        if self.ref[gid] <= 0:
            raise ValueError(
                f"release of dead block {gid} (ref {int(self.ref[gid])}): "
                "double free — the count is left untouched")
        self.ref[gid] -= 1
        if self.ref[gid] == 0:
            s = gid // self.pool_blocks
            heapq.heappush(self._free[s], int(gid))
            self.gen[gid] += 1
            self.n_frees += 1
            self._live -= 1
            self._live_shard[s] -= 1

    def free_block(self, slot: int, block_idx: int) -> None:
        gid = int(self.table[slot, block_idx])
        if gid < 0:
            return
        self.table[slot, block_idx] = -1
        self.dirty = True
        self._release(gid)

    def free_slot(self, slot: int) -> None:
        """Recycle every block a slot holds (request exit / slot reset)."""
        for bi in range(self.blocks_per_slot):
            self.free_block(slot, bi)

    # ------------------------------------------------------------------
    # preemption swap support (runtime/scheduler.py)
    # ------------------------------------------------------------------

    def release_slot(self, slot: int) -> Dict[int, Tuple[int, int]]:
        """Bulk-release a preempted slot's table, returning
        ``{ring_block_idx: (gid, gen_at_release)}`` for every mapping it
        held.  Shared blocks (prefix-cache pins, other adopters) stay
        live with one fewer ref; exclusively-owned blocks return to the
        free list.  The (gid, gen) pairs are what :meth:`readopt` checks
        at resume time to decide whether the device payload is provably
        unchanged."""
        held: Dict[int, Tuple[int, int]] = {}
        for bi in range(self.blocks_per_slot):
            gid = int(self.table[slot, bi])
            if gid < 0:
                continue
            held[bi] = (gid, int(self.gen[gid]))
            self.free_block(slot, bi)
        return held

    def readopt(self, slot: int, block_idx: int, gid: int,
                gen: int) -> bool:
        """Re-map a resuming slot's ring block onto the physical block it
        held before preemption — but only when the block is provably
        unchanged: still live (someone else kept it referenced the whole
        time, so COW immutability applied throughout), same generation
        (never recycled through the free list), on the resuming slot's
        shard, and the target table entry unmapped.  Returns True on the
        fast path (caller skips the host→device payload upload); False
        means the caller must alloc fresh and re-upload."""
        if self.table[slot, block_idx] >= 0:
            return False
        if not (0 <= gid < self.n_blocks):
            return False
        if self.ref[gid] <= 0 or int(self.gen[gid]) != int(gen):
            return False
        if gid // self.pool_blocks != self.shard_of(slot):
            return False
        self.retain(gid)
        self.table[slot, block_idx] = gid
        self.dirty = True
        return True

    def resume_demand(self, slot: int, held: Dict[int, Tuple[int, int]]) -> int:
        """How many FRESH blocks resuming ``slot`` from ``held``
        (``{ring_block_idx: (gid, gen)}``, a :meth:`release_slot` result)
        would actually pull from the free list: held blocks that would
        survive :meth:`readopt`'s (gid, gen) fast-path checks cost
        nothing.  Read-only — the headroom gate calls this BEFORE
        committing to the resume, so it must not touch any state."""
        s = self.shard_of(slot)
        fresh = 0
        for gid, gen in held.values():
            if (0 <= gid < self.n_blocks and self.ref[gid] > 0
                    and int(self.gen[gid]) == int(gen)
                    and gid // self.pool_blocks == s):
                continue
            fresh += 1
        return fresh

    def publish(self, reg, mark: Tuple[int, int, int, int] = (0, 0, 0, 0),
                bytes_per_block: float = 0.0) -> None:
        """Publish pool metrics into a telemetry registry (duck-typed —
        anything with ``counter``/``gauge`` get-or-create methods).
        ``mark`` is the serve-start snapshot of (n_allocs, n_frees,
        n_retains, n_cow) so per-serve deltas don't double-count."""
        reg.gauge("kv_bytes_peak_per_shard",
                  "peak live tail-KV bytes on the busiest data shard"
                  ).set(float(self.peak_blocks_shard.max()) * bytes_per_block)
        reg.gauge("pool_blocks_total",
                  "pool capacity: blocks per shard x shards"
                  ).set(float(self.n_blocks))
        reg.gauge("pool_blocks_peak",
                  "peak live blocks across the pool this serve"
                  ).set(float(self.peak_blocks))
        reg.gauge("pool_occupancy_peak",
                  "peak live blocks / capacity this serve"
                  ).set(float(self.peak_blocks) / max(self.n_blocks, 1))
        a0, f0, r0, c0 = mark
        reg.counter("pool_allocs", "fresh block allocations this serve"
                    ).add(self.n_allocs - a0)
        reg.counter("pool_frees", "blocks returned to the free list this serve"
                    ).add(self.n_frees - f0)
        reg.counter("pool_retains", "extra refs taken (adopt/retain) this serve"
                    ).add(self.n_retains - r0)
        reg.counter("pool_cow", "copy-on-write block swaps this serve"
                    ).add(self.n_cow - c0)

    def free_retired(self, slot: int, t: int, policy) -> int:
        """Return blocks whose every claimed position is retired under
        ``policy`` (see the module docstring's retire-safety argument).

        A claimed position ``p`` is dead iff ``p < policy.retire_lo(slot,
        t)``, or ``p >= t`` (allocated-but-unwritten) when the policy
        does not ``keep_unwritten``.  Ring blocks the policy has
        write-protected (``policy.protect_write`` — an imminent launch
        will scatter into them) are skipped even if dead: freeing one
        would just force ``ensure`` to re-allocate it and the reclaim
        loop to spin."""
        freed = 0
        lo = int(policy.retire_lo(slot, t))
        keep_unwritten = bool(policy.keep_unwritten)
        protected = policy.protected_blocks(slot)
        claims = ring_claims(t, self.tail)
        for bi in range(self.blocks_per_slot):
            if self.table[slot, bi] < 0 or bi in protected:
                continue
            blk = claims[bi * self.block_size:(bi + 1) * self.block_size]
            dead = blk < lo
            if not keep_unwritten:
                dead = dead | (blk >= t)
            if dead.all():
                self.free_block(slot, bi)
                freed += 1
        return freed

    def free_covered(self, slot: int, t: int, cov: int,
                     exclude: Sequence[int] = ()) -> int:
        """Frontier-policy wrapper around ``free_retired``: free blocks
        whose every claimed position is ``< cov`` (absorbed into
        centroids) or not yet written — the compaction give-back, with
        ``exclude`` standing in for write protection."""
        return self.free_retired(slot, t, _InlineFrontier(cov, exclude))

    # ------------------------------------------------------------------
    # device views
    # ------------------------------------------------------------------

    def table_for_read(self) -> np.ndarray:
        """Block table with unmapped entries pointing at the slot's shard
        base block — a valid gather target whose payload is garbage at
        offsets the position/coverage masks already exclude."""
        out = self.table.copy()
        for slot in range(self.n_slots):
            row = out[slot]
            row[row < 0] = self.shard_base(slot)
        return out

    def row_for_read(self, slot: int) -> np.ndarray:
        """One slot's read-sanitized table row (per-slot absorb path —
        avoids copying the whole table for a (T,) gather)."""
        row = self.table[slot].copy()
        row[row < 0] = self.shard_base(slot)
        return row

    def table_for_write(self) -> np.ndarray:
        """Block table with unmapped entries out of range (``n_blocks``)
        so scatters with mode='drop' skip them."""
        out = self.table.copy()
        out[out < 0] = self.n_blocks
        return out

    def row_for_write(self, slot: int) -> np.ndarray:
        """One slot's write-sanitized table row (admission slot-write)."""
        row = self.table[slot].copy()
        row[row < 0] = self.n_blocks
        return row

    # ------------------------------------------------------------------
    # invariant checks (exercised by Hypothesis property tests)
    # ------------------------------------------------------------------

    def check_invariants(self) -> None:
        owners: Dict[int, List[Tuple[int, int]]] = {}
        for slot in range(self.n_slots):
            for bi in range(self.blocks_per_slot):
                gid = int(self.table[slot, bi])
                if gid >= 0:
                    owners.setdefault(gid, []).append((slot, bi))
        for gid, who in owners.items():
            assert self.ref[gid] >= len(who), (
                f"block {gid} mapped {len(who)}x with ref {self.ref[gid]}")
            assert self.ref[gid] > 0, f"table points at dead block {gid}"
            for slot, _bi in who:
                assert gid // self.pool_blocks == self.shard_of(slot), (
                    f"slot {slot} maps block {gid} of another shard")
        assert self._live == int((self.ref > 0).sum()), \
            "live counter drifted from ref counts"
        for s in range(self.n_shards):
            lo, hi = s * self.pool_blocks, (s + 1) * self.pool_blocks
            free = set(self._free[s])
            live = {g for g in range(lo, hi) if self.ref[g] > 0}
            assert not (free & live), "free list overlaps live blocks"
            assert len(free) + len(live) == self.pool_blocks, (
                "alloc/free leak: free + live != pool")
            for g in free:
                assert lo <= g < hi, "free id escaped its shard"
