"""Retention policies: *what* the KV cache must keep, decoupled from
*where* the bytes live (port of ``repro.core.retention``).

A :class:`RetentionPolicy` answers one question — which claimed positions
must survive? — through a per-slot lower bound ``retire_lo(slot, t)``:
positions in [retire_lo, t) are live, positions below it are retired, and
positions at or after ``t`` (claimed but never written) are dead unless
the policy sets ``keep_unwritten``.

* :class:`FrontierRetention` — the clustered coverage frontier: positions
  below ``cov`` were absorbed into k-medians centroids, so dropping their
  exact bytes is loss-free.
* :class:`WindowRetention` — sliding-window ('L') layers: retire_lo is
  ``t - window``; a ring of at least ``window`` entries never overwrites
  an in-window entry.
* :class:`QuotaRetention` — paged exact KV with a per-slot block budget:
  nothing retires mid-stream; a request's whole depth is reserved at
  admission and returned at slot exit, so an oversubscribed pool defers
  admissions instead of running dry mid-decode.
* :class:`RecurrentRetention` — recurrent-state layers ('M', 'R'): every
  position is folded into a fixed-size state, so nothing ever retires.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import kv_compress


class RetentionPolicy:
    """Which claimed ring positions must survive a write?"""

    kind = "base"
    #: True when positions claimed but not yet written still hold storage
    keep_unwritten = False

    def retire_lo(self, slot: int, t: int) -> int:
        raise NotImplementedError

    # -- write protection ----------------------------------------------
    def protect_write(self, slot: int, blocks) -> None:
        """Register block indices an imminent write will touch."""
        self._protected()[slot] = frozenset(int(b) for b in blocks)

    def clear_protection(self, slot: int) -> None:
        self._protected().pop(slot, None)

    def protected_blocks(self, slot: int) -> frozenset:
        return self._protected().get(slot, frozenset())

    def _protected(self) -> dict:
        d = getattr(self, "_prot", None)
        if d is None:
            d = self._prot = {}
        return d

    def on_slot_free(self, slot: int) -> None:
        """Reset per-slot policy state when the engine recycles a slot."""
        self.clear_protection(slot)


class FrontierRetention(RetentionPolicy):
    """The clustered coverage frontier.  Owns the host mirror of the
    per-slot ``cov`` device vector; every frontier target (admission,
    streaming absorb, compaction) comes from
    :func:`kv_compress.coverage_frontier`."""

    kind = "frontier"

    def __init__(self, n_slots: int, ccfg: "kv_compress.KVCompressConfig"):
        self.ccfg = ccfg
        self.cov = np.zeros(n_slots, np.int32)

    def retire_lo(self, slot: int, t: int) -> int:
        return int(self.cov[slot])

    def frontier(self, slot: int) -> int:
        return int(self.cov[slot])

    def set_frontier(self, slot: int, cov: int) -> None:
        self.cov[slot] = int(cov)

    def target(self, pos: int) -> int:
        """Loss-free frontier for a stream at absolute length ``pos``."""
        return kv_compress.coverage_frontier(int(pos), self.ccfg)

    def on_slot_free(self, slot: int) -> None:
        super().on_slot_free(slot)
        self.cov[slot] = 0


class WindowRetention(RetentionPolicy):
    """Sliding-window local attention: keep the last ``window`` positions.

    A local layer at stream length ``t`` attends ``[max(0, t - window),
    t)`` only, so anything older is dead by the model's own mask.
    ``advance(slot, t)`` moves the slot's stream head and returns how many
    positions newly crossed the window edge (the ``kv_retired_window``
    counter), in positions: local rings are dense per slot, never in the
    pool, and a retired entry's storage is reclaimed when the ring
    overwrites it."""

    kind = "window"

    def __init__(self, window: int, n_slots: int = 0):
        if window <= 0:
            raise ValueError("WindowRetention needs a positive window")
        self.window = int(window)
        self._head = np.zeros(n_slots, np.int64)

    def retire_lo(self, slot: int, t: int) -> int:
        return max(0, int(t) - self.window)

    def advance(self, slot: int, t: int) -> int:
        """Move slot's stream head to ``t``; return newly retired count."""
        old = int(self._head[slot])
        t = max(old, int(t))
        self._head[slot] = t
        return max(0, t - self.window) - max(0, old - self.window)

    def on_slot_free(self, slot: int) -> None:
        super().on_slot_free(slot)
        if slot < self._head.shape[0]:
            self._head[slot] = 0


class RecurrentRetention(RetentionPolicy):
    """Recurrent-state layers (Mamba2 'M', RG-LRU 'R'): nothing retires.

    Every past token is already folded into ``(conv, ssm)`` / ``(conv,
    h)``, so there are no claimed positions to retire, protect or sweep.
    The policy names the family so the engine's per-serve counters carry
    an explicit ``kv_retired_recurrent`` of 0."""

    kind = "recurrent"
    #: nothing is position-claimed, so sweeps must not touch these slots
    keep_unwritten = True

    def __init__(self, kinds=("M", "R")):
        self.kinds = tuple(kinds)

    def retire_lo(self, slot: int, t: int) -> int:
        return 0

    def advance(self, slot: int, t: int) -> int:
        """Move slot's stream head to ``t``: zero positions retire."""
        return 0

    def diagnostics(self) -> dict:
        """Named per-family counters for the end-of-serve publish."""
        return {"kv_retired_recurrent": 0,
                "retention_recurrent_kinds": "".join(self.kinds)}


class QuotaRetention(RetentionPolicy):
    """Paged exact KV with a per-slot block budget.

    Every written position of an exact cache may be attended until the
    request exits, so nothing retires (``retire_lo`` 0) and reserved but
    unwritten positions keep their blocks (``keep_unwritten``).  The
    engine reserves ``admit_blocks`` before a request's first token and
    defers the request when the pool cannot supply them; the blocks go
    back at slot exit."""

    kind = "quota"
    keep_unwritten = True

    def __init__(self, block_size: int, blocks_per_slot: int):
        self.block_size = int(block_size)
        self.blocks_per_slot = int(blocks_per_slot)

    def retire_lo(self, slot: int, t: int) -> int:
        return 0

    def admit_blocks(self, plen: int, max_new: int) -> int:
        """Blocks for a request's whole written depth: the prompt's
        ``plen`` positions and ``max_new - 1`` generated tokens (the last
        sampled token is never written back), rounded up to blocks and
        clamped to the per-slot budget."""
        depth = int(plen) + max(1, int(max_new)) - 1
        need = -(-depth // self.block_size)
        return min(self.blocks_per_slot, max(1, need))
