"""Layer-state families: *what* state a layer carries per slot (port of
``repro.core.layer_state``).

* :class:`RingKVState` covers position-indexed KV rings ('G' global
  attention, exact or clustered; 'L' sliding-window rings): state grows
  with the stream and positions retire under a retention policy.
* :class:`RecurrentState` covers fixed-size running state per slot ('M'
  Mamba2 SSD ``(conv, ssm)``, 'R' RG-LRU ``(conv, h)``): advanced one
  token at a time, never retired, never in pool blocks; its swap and
  prefix payload is the whole state, carried in the same slot snapshot as
  the clustered summaries.

The engine prices a slot for victim selection and swap as its mapped tail
blocks plus :func:`recurrent_state_bytes`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

#: the keys of a recurrent-state cache leaf: Mamba2 carries {"conv",
#: "ssm"}, RG-LRU {"conv", "h"}; snapshot, restore and swap move every key
RECURRENT_LEAF_KEYS: Tuple[Tuple[str, ...], ...] = (("conv", "ssm"),
                                                    ("conv", "h"))

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
class RecurrentState:
    """Recurrent-family descriptor: fixed-size running state per slot."""

    kinds: frozenset
    family = "recurrent"
    pool_backed = False     # never in pool blocks; block tables skip it
    fixed_size = True       # (conv, ssm) / (conv, h): constant per slot
    retirable = False       # nothing to retire; checkpointed whole


@dataclass(frozen=True)
class LayerStateFamilies:
    """Which state families a config's layer pattern instantiates."""

    ring: RingKVState
    recurrent: RecurrentState

    @property
    def has_ring(self) -> bool:
        return bool(self.ring.kinds)

    @property
    def has_recurrent(self) -> bool:
        return bool(self.recurrent.kinds)

    @property
    def mixed(self) -> bool:
        return self.has_ring and self.has_recurrent


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
        recurrent=RecurrentState(kinds=frozenset(kinds & RECURRENT_KINDS)))


def is_recurrent_leaf(node) -> bool:
    """A recurrent-state cache leaf: {"conv", "ssm"} or {"conv", "h"}."""
    return (isinstance(node, dict) and "conv" in node
            and ("ssm" in node or "h" in node))


def recurrent_leaf_stacked(node) -> bool:
    """True when the leaf carries a leading layer axis, as the reference's
    scan-stacked leaves do; the port keeps one leaf per layer, (B, k-1, C)
    or (B, 3, W), so this is False on every port leaf."""
    return node["conv"].dim() == 4


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


def recurrent_state_bytes(cache, n_slots: int) -> int:
    """Bytes of recurrent state one slot carries across all layers: the
    swap and victim price of the recurrent family (the whole state moves,
    every time, and never shrinks).  Every recurrent leaf is slot-major,
    so a slot's share is the total over ``n_slots``."""
    total = 0
    for leaf in _walk_leaves(cache, is_recurrent_leaf):
        for a in leaf.values():
            total += a.numel() * a.element_size()
    return total // max(int(n_slots), 1)


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
