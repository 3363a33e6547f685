"""SLO-aware scheduling: priority preemption, host-memory swap, and
graceful brownout under overload (port of ``repro.runtime.scheduler``,
host only, copied whole; the swap payloads are CPU torch tensors).

The paged clustered-KV engine (runtime/server.py) already survives pool
pressure by deferring admissions, sweeping covered blocks, and evicting
unpinned prefix entries — but those rungs are priority-blind: a burst of
best-effort batch traffic can hold every slot and block while an
interactive request queues behind it, and sustained overload still ends
in ``PoolExhausted``.  This module adds the QoS layer on top:

  * requests carry an SLO class (``core.request_cluster.Request.priority``,
    larger = more important) and an optional soft TTFT deadline;
  * under slot or pool pressure the engine **preempts** the cheapest
    lower-priority in-flight slot: its slot snapshot
    (``clustered_slot_state`` — the prefix-snapshot format) plus its
    mapped tail-ring block payloads are gathered to **host memory**, the blocks go back to the pool
    (``BlockPool.release_slot``), and the request parks on a swap
    backlog;
  * a parked request **resumes mid-stream** when capacity returns:
    blocks whose ``(gid, generation)`` survived untouched are re-adopted
    without a re-upload (the COW rule makes a live block's payload
    immutable, so the device bytes provably still match the host copy),
    the rest are re-allocated and scattered back from the host copy.
    Because every slot's clustered state is a deterministic function of
    its own token stream (per-slot compaction cadence), the
    resumed request's greedy tokens are bit-identical to an
    uninterrupted run — preemption is schedule-invisible;
  * when even preemption cannot make progress, best-effort load is
    **shed** (partial tokens returned, blocks freed) before any
    high-class request is failed — ``PoolExhausted`` only fires once all
    remaining work is the protected class.

The brownout ladder, cheapest rung first, each step counted in
``Server.last_stats`` (``sched_*`` keys):

    defer  → retry the admission later (existing machinery, now counted)
    preempt→ swap a lower-priority slot out to host memory
    swap-in→ resume a parked request when capacity returns
    shed   → drop best-effort work that can no longer be served

Victim choice follows the Mettu–Plaxton online-median framing the
ROADMAP points at: among lower-priority active slots, the one mapping
the *fewest* pool blocks is the cheapest eviction — its ring is mostly
covered, i.e. the centroids already summarize it, so swapping it moves
the least exact KV (the swap snapshot is "just another compressed
summary tier" in the stream-clustering view).

This module is host-only and engine-agnostic: it owns the policy
(victim selection, backlog ordering, shed eligibility) and the
accounting; the Server owns the device work (the swap gather and
scatter) and calls in at its clean step boundaries.  That split keeps
the policy unit-testable without a model and lets a Hypothesis state
machine drive scheduler + pool together with no device tensors at all
(tests/test_torch_scheduler.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["SLOConfig", "SwapRecord", "SLOScheduler"]


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Engine-facing SLO knobs (``ServerConfig.scheduler``).

    ``high_class``: requests with ``priority >= high_class`` form the
    protected class — they are never preempted in favor of lower
    classes, never shed, and their TTFT is what the brownout ladder
    defends.  ``shed_on_exhaustion``: when even preemption cannot free a
    block and zero forward progress is possible, drop best-effort work
    (partial tokens returned) instead of raising ``PoolExhausted``; the
    exception still fires if only protected work remains.
    ``max_swapped``: cap on concurrently parked requests (0 = slots
    count, the natural bound — every parked request beyond the slot
    count would have been queue-deferred anyway).
    ``priority_admission``: stable priority-first ordering of the
    pending queue — the admission-control half of the QoS story, and
    what lets a protected request arriving behind a deep best-effort
    backlog see a p95 TTFT bounded by the protected class's own demand
    instead of the whole queue's.  Disable to model strict
    arrival-order admission (an online scheduler that cannot see
    future arrivals), where priority acts only through preemption and
    resume ordering."""
    high_class: int = 1
    shed_on_exhaustion: bool = True
    max_swapped: int = 0
    priority_admission: bool = True


@dataclasses.dataclass
class SwapRecord:
    """Everything needed to resume a preempted request bit-identically,
    host-resident.  ``snap``/``tails`` are trees of CPU torch tensors
    (numpy has no bfloat16): the prefix-snapshot format
    (``transformer.clustered_slot_state``) and the gathered block
    payloads (``Server._gather_swap_tails``), on a mesh held by the
    ranks of the data shard the slot left (their head block of each;
    None on the others);
    ``held`` maps ring-block index → (gid, generation-at-release) for
    the re-adoption fast path; ``epoch`` stamps the server config/weights
    the snapshot was taken under (a resume under any other epoch must
    re-prefill rather than restore — same protocol as the template
    store)."""
    uid: int
    priority: int
    pos: int                    # tokens fed (watermark t)
    cur: int                    # last sampled token id (next step input)
    fed: int                    # prompt tokens consumed
    since_tok: int              # per-slot compaction cadence phase
    cov: int                    # coverage frontier at swap-out
    max_new_tokens: int
    deadline_ms: float
    held: Dict[int, Tuple[int, int]]
    snap: Any                   # host clustered_slot_state tree
    tails: Any                  # host {k_tail, v_tail} payload tree
    epoch: Any
    seq: int                    # swap-out order (FIFO within a class)
    n_blocks_swapped: int = 0   # mapped blocks at swap-out (accounting)
    state_bytes: int = 0        # recurrent-family state bytes riding the
    #                             snapshot (core/layer_state.py)
    hold: bool = False          # parked by a zero-progress (within-class)
    #                             preemption: not resumable until the
    #                             engine decodes real tokens again, or
    #                             the freed blocks would bounce straight
    #                             back and recreate the stall (live-lock)


class SLOScheduler:
    """Host-side policy + accounting for one ``serve()`` call.

    The Server constructs one per serve (the swap backlog never
    outlives the serve — parked requests either resume or shed before
    the serve returns, so cross-serve template-store state is
    untouched).  All methods are O(slots) or O(backlog) host work.
    """

    def __init__(self, cfg: SLOConfig, n_slots: int):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_swapped = cfg.max_swapped or n_slots
        self._backlog: List[SwapRecord] = []
        self._seq = 0
        self.shed_uids: set = set()
        # brownout counters (surfaced as last_stats["sched_*"])
        self.deferrals = 0
        self.preemptions = 0
        self.swaps_out = 0
        self.swaps_in = 0
        self.sheds = 0
        self.shed_high = 0          # must stay 0: protected class never shed
        self.readopted_blocks = 0
        self.reuploaded_blocks = 0
        self.swapped_blocks = 0     # currently parked blocks-worth of tail
        self.swapped_peak = 0
        self.swap_bytes = 0         # host bytes currently parked
                                    # (tail KV + recurrent state)

    # ------------------------------------------------------------------
    # class predicates
    # ------------------------------------------------------------------

    def is_high(self, priority: int) -> bool:
        return priority >= self.cfg.high_class

    # ------------------------------------------------------------------
    # victim selection
    # ------------------------------------------------------------------

    def pick_victim(self, candidates: List[Tuple[int, int, int]],
                    below_prio: int) -> Optional[int]:
        """Choose the cheapest preemption victim among active slots.

        ``candidates`` is ``[(priority, swap_cost, slot), ...]`` for the
        admissible slots (caller pre-filters by shard when the pressure
        is shard-local — blocks are shard-local, so only a same-shard
        victim frees usable blocks).  Eligible victims have
        ``priority < below_prio`` strictly (preemption never reorders
        within a class — that would trade one request's SLO for an
        equal one's) and are outside the protected class unless the
        preemptor itself outranks them.  Cheapest = lowest priority
        first, then lowest swap cost, then lowest slot for determinism.
        The cost function belongs to the caller: the engine prices
        heterogeneous layer-state families as mapped-tail-block bytes
        plus the recurrent family's fixed per-slot state bytes
        (core/layer_state.py) — the most-covered slot moves the least
        exact KV, the Mettu–Plaxton cheapest-eviction rule, and for
        all-ring patterns the byte cost is a monotone transform of the
        old mapped-block count so victim choices are unchanged."""
        elig = [(p, nb, j) for (p, nb, j) in candidates if p < below_prio]
        if not elig:
            return None
        return min(elig)[2]

    # ------------------------------------------------------------------
    # swap backlog
    # ------------------------------------------------------------------

    def record_swap(self, rec: SwapRecord) -> None:
        rec.seq = self._seq
        self._seq += 1
        self._backlog.append(rec)
        self.preemptions += 1
        self.swaps_out += 1
        self.swapped_blocks += rec.n_blocks_swapped
        self.swapped_peak = max(self.swapped_peak, self.swapped_blocks)

    def can_swap(self) -> bool:
        return len(self._backlog) < self.max_swapped

    def backlog_size(self) -> int:
        return len(self._backlog)

    def peek_resume(self) -> Optional[SwapRecord]:
        """Next record to resume: highest priority, then FIFO by
        swap-out order within a class (a parked request re-enters ahead
        of later-parked equals — it already paid its admission).
        Records parked by a zero-progress preemption stay held until
        ``clear_holds`` (the engine decoded real tokens again)."""
        elig = [r for r in self._backlog if not r.hold]
        if not elig:
            return None
        return min(elig, key=lambda r: (-r.priority, r.seq))

    def clear_holds(self) -> None:
        """Forward progress happened: held records become resumable."""
        for r in self._backlog:
            r.hold = False

    def pop_record(self, rec: SwapRecord) -> None:
        """Remove a record that resumed (caller already restored it)."""
        self._backlog.remove(rec)
        self.swaps_in += 1
        self.swapped_blocks -= rec.n_blocks_swapped

    def shed_record(self, rec: SwapRecord) -> None:
        """Drop a parked best-effort request (its blocks were already
        released at swap-out — nothing to free)."""
        if self.is_high(rec.priority):
            raise RuntimeError(
                f"refusing to shed protected request uid={rec.uid} "
                f"(priority {rec.priority} >= high_class "
                f"{self.cfg.high_class})")
        self._backlog.remove(rec)
        self.swapped_blocks -= rec.n_blocks_swapped
        self.shed_uids.add(rec.uid)
        self.sheds += 1

    def shed_uid(self, uid: int, priority: int) -> None:
        """Shed a queued or active best-effort request (caller frees any
        blocks the slot held)."""
        if self.is_high(priority):
            raise RuntimeError(
                f"refusing to shed protected request uid={uid} "
                f"(priority {priority} >= high_class "
                f"{self.cfg.high_class})")
        self.shed_uids.add(uid)
        self.sheds += 1

    def pick_shed(self) -> Optional[SwapRecord]:
        """Cheapest parked record to shed under exhaustion: lowest
        priority, then most recently parked (LIFO among equals — the
        longest-parked request is closest to its deadline budget and
        has the best claim on eventually resuming)."""
        elig = [r for r in self._backlog if not self.is_high(r.priority)]
        if not elig:
            return None
        return min(elig, key=lambda r: (r.priority, -r.seq))

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    def publish(self, reg) -> None:
        """Publish the brownout counters into a telemetry registry
        (duck-typed).  Key names match :meth:`stats` exactly so the
        registry-generated flat view stays backward compatible."""
        reg.counter("sched_deferrals",
                    "admissions/resumes pushed back for later retry"
                    ).add(self.deferrals)
        reg.counter("sched_preemptions",
                    "slots preempted (swap-out rung)").add(self.preemptions)
        reg.counter("sched_swaps_out",
                    "slot states spilled to host memory").add(self.swaps_out)
        reg.counter("sched_swaps_in",
                    "parked requests resumed mid-stream").add(self.swaps_in)
        reg.counter("sched_sheds",
                    "best-effort requests dropped under brownout"
                    ).add(self.sheds)
        reg.counter("sched_shed_high",
                    "protected-class sheds (must stay 0)").add(self.shed_high)
        reg.gauge("sched_swapped_peak_blocks",
                  "peak blocks-worth of tail KV parked on host"
                  ).set(float(self.swapped_peak))
        reg.counter("sched_readopted_blocks",
                    "resume blocks re-adopted without re-upload"
                    ).add(self.readopted_blocks)
        reg.counter("sched_reuploaded_blocks",
                    "resume blocks re-uploaded from the host copy"
                    ).add(self.reuploaded_blocks)
        reg.gauge("sched_swap_bytes",
                  "host bytes parked (tail KV + recurrent state)"
                  ).set(float(self.swap_bytes))
        reg.gauge("sched_backlog_end",
                  "records still parked at end of serve"
                  ).set(float(len(self._backlog)))

    def stats(self) -> Dict[str, float]:
        return {
            "sched_deferrals": float(self.deferrals),
            "sched_preemptions": float(self.preemptions),
            "sched_swaps_out": float(self.swaps_out),
            "sched_swaps_in": float(self.swaps_in),
            "sched_sheds": float(self.sheds),
            "sched_shed_high": float(self.shed_high),
            "sched_swapped_peak_blocks": float(self.swapped_peak),
            "sched_readopted_blocks": float(self.readopted_blocks),
            "sched_reuploaded_blocks": float(self.reuploaded_blocks),
            "sched_swap_bytes": float(self.swap_bytes),
            "sched_backlog_end": float(len(self._backlog)),
        }
