"""Layer-state families: *what* state a layer carries per slot (port of
the ring family of ``repro.core.layer_state``).

:class:`RingKVState` covers position-indexed KV rings ('G' global
attention, exact or clustered; 'L' sliding-window rings): state grows with
the stream and positions retire under a retention policy.  The recurrent
family ('M' Mamba2, 'R' RG-LRU) comes with the rest of the model zoo;
:func:`families_for` reports such kinds, and the engine rejects them.
"""

from __future__ import annotations

from dataclasses import dataclass

RING_KINDS = frozenset("GL")
RECURRENT_KINDS = frozenset("MR")


def family_of_kind(kind: str) -> str:
    """'ring' | 'recurrent' for a layer_pattern kind character."""
    if kind in RING_KINDS:
        return "ring"
    if kind in RECURRENT_KINDS:
        return "recurrent"
    raise ValueError(f"unknown layer kind {kind!r}")


@dataclass(frozen=True)
class RingKVState:
    """Ring-family descriptor: position-indexed KV, retention-governed."""

    kinds: frozenset
    family = "ring"
    pool_backed = True      # clustered tails / quota blocks live in the pool
    fixed_size = False      # state grows with the stream
    retirable = True        # positions retire behind a RetentionPolicy


@dataclass(frozen=True)
class LayerStateFamilies:
    """Which state families a config's layer pattern instantiates."""

    ring: RingKVState
    recurrent_kinds: frozenset

    @property
    def has_ring(self) -> bool:
        return bool(self.ring.kinds)

    @property
    def has_recurrent(self) -> bool:
        return bool(self.recurrent_kinds)


def families_for(cfg) -> LayerStateFamilies:
    """Classify a :class:`~repro_torch.models.config.ModelConfig`'s
    layers; MoE dense prefix layers are always global attention."""
    kinds = set(cfg.layer_pattern)
    if cfg.moe is not None and cfg.moe.n_dense_layers > 0:
        kinds.add("G")
    unknown = kinds - RING_KINDS - RECURRENT_KINDS
    if unknown:
        raise ValueError(f"unknown layer kinds {sorted(unknown)!r} in "
                         f"pattern {cfg.layer_pattern!r}")
    return LayerStateFamilies(
        ring=RingKVState(kinds=frozenset(kinds & RING_KINDS)),
        recurrent_kinds=frozenset(kinds & RECURRENT_KINDS))


def is_ring_leaf(node) -> bool:
    """A ring-family cache leaf: exact {"k", "v"} or clustered
    {"k_cents", ...}."""
    return isinstance(node, dict) and ("k" in node or "k_cents" in node)


def _walk_leaves(cache, pred):
    out = []

    def walk(node):
        if isinstance(node, dict):
            if pred(node):
                out.append(node)
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(cache)
    return out


def ring_state_bytes(cache, n_slots: int) -> int:
    """Bytes of dense ring-family state one slot carries (centroid
    summaries, exact rings), tail rings excluded."""
    total = 0
    for leaf in _walk_leaves(cache, is_ring_leaf):
        for k, a in leaf.items():
            if k in ("k_tail", "v_tail"):
                continue
            total += a.numel() * a.element_size()
    return total // max(int(n_slots), 1)
