"""Retention policies: *what* the KV cache must keep, decoupled from
*where* the bytes live (port of the frontier subset of
``repro.core.retention``).

A :class:`RetentionPolicy` answers one question — which claimed positions
must survive? — through a per-slot lower bound ``retire_lo(slot, t)``:
positions in [retire_lo, t) are live, positions below it are retired.
:class:`FrontierRetention` is the clustered coverage frontier: positions
below ``cov`` were absorbed into k-medians centroids, so dropping their
exact bytes is loss-free.  The window, quota and recurrent policies come
with the paged engine.
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
