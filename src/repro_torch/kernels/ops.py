"""Public wrappers of the kernels and the backend choice (port of
``repro.kernels.ops``).

The backend follows the tensors: a CPU tensor takes the kernel's plain
PyTorch version (what the tests run), a CUDA tensor launches the
hand-written kernel — built at first use — or raises.  There is no
fallback from the card to the plain version.  This is the counterpart of
the reference's ``interpret_default``.

Each wrapper carries a plain integer ``launches`` that it bumps where it
launches its kernel and nowhere else (``distance_argmin``: one integer per
metric), so a run can show that its main path went through the kernels
(``reset_launches`` / ``launch_counts``).

A ``meta`` tensor (the dry run's count, ``launch/dryrun.py``) reaches
neither the kernel nor the plain version: the wrapper returns its
outputs' shapes and dtypes.  Whatever the device, under an active
``roofline.op_count.OpCounter`` each call records one launch with the
kernel's work model (``roofline/work.py``; ``op_count.counted``), so the
counts of the CPU, the card and ``meta`` agree; with no counter in force
a call costs one thread-local read more.  ``launches`` stays the card's
count.

Mesh serving (``sharding.rules.use_rules`` active) dispatches the decode
kernels per model shard, as the reference's ``shard_map`` islands do: a
rank's engine already holds only its data shard's slots, and
:func:`head_island` gives the attention layer this rank's block of query
and kv heads and the ``all_gather`` that puts every rank's outputs back in
head order.  The kernel grid is (rows, kv head) and every cell is
independent, so the sharded launch is exact.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import bitserial_median as _bsm
from repro_torch.kernels import clustered_decode as _cd
from repro_torch.kernels import distance_argmin as _da
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import paged_clustered_decode as _pcd
from repro_torch.roofline import op_count
from repro_torch.roofline import work as _work
from repro_torch.sharding.rules import current_rules


def route(x: torch.Tensor) -> str:
    """"kernel" for a CUDA tensor (the kernel runs), "plain" for a CPU
    one (the plain version runs), "meta" on the meta device (shapes
    only); any other device raises."""
    kind = {"cuda": "kernel", "cpu": "plain", "meta": "meta"}.get(
        x.device.type)
    if kind is None:
        raise ValueError(f"no kernel backend for device {x.device}")
    return kind


def _kernel_shard_axes(rules, b: int, hq: int, hkv: int):
    """(data_axes, model_axes) for a (B, Hq/Hkv, …) kernel launch under
    the sharding rules, None where nothing divides.  Heads shard over the
    model axis only when BOTH the query and kv head counts divide (the GQA
    group must stay intact per shard)."""
    data_axes = rules.axes_for("batch", b)
    model_axes = rules.axes_for("heads", hq)
    if (model_axes is not None
            and rules.axes_for("kv_heads", hkv) != model_axes):
        model_axes = None
    return data_axes, model_axes


class HeadIsland:
    """This rank's block of heads in a mesh step: query heads ``q`` and kv
    heads ``kv`` (slices of the head axis) of rank ``index`` of the model
    group, which holds ``size`` ranks."""

    def __init__(self, rules, axes, hq: int, hkv: int):
        self.size = rules.size(axes)
        self.index = rules.axis_index(axes)
        self.group = rules.group(axes)
        nq, nkv = hq // self.size, hkv // self.size
        self.q = slice(self.index * nq, (self.index + 1) * nq)
        self.kv = slice(self.index * nkv, (self.index + 1) * nkv)

    def gather(self, out: torch.Tensor) -> torch.Tensor:
        """(..., Hq / size, Dh) outputs of this rank's heads → (..., Hq, Dh),
        every rank's block in head order (an ``all_gather`` over the model
        group)."""
        out = out.contiguous()
        parts = [torch.empty_like(out) for _ in range(self.size)]
        dist.all_gather(parts, out, group=self.group)
        return torch.cat(parts, dim=-2)


def head_island(hq: int, hkv: int) -> Optional[HeadIsland]:
    """The head island of a decode launch with ``hq`` / ``hkv`` heads under
    the active sharding rules, or None: no rules (one device), or heads
    that do not divide the model axis (every model rank then runs all
    heads, the reference's replicated fallback, and its cache holds them
    all)."""
    r = current_rules()
    if r is None:
        return None
    _, model_axes = _kernel_shard_axes(r, 1, hq, hkv)
    if model_axes is None:
        return None
    return HeadIsland(r, model_axes, hq, hkv)


@op_count.counted("bitserial_median", _work.bitserial_median_work)
def grouped_median_bits(u: torch.Tensor, assign: torch.Tensor, k: int,
                        weights: Optional[torch.Tensor] = None, *,
                        bits: int = 32):
    """Per-cluster bit-serial medians of unsigned-ordered words.

    u (..., N, D) int64, assign (..., N) → (med (..., k, D) int64, totals
    (..., k) f32).  On the card the kernel runs at every N: the reference's
    fallback above ``MAX_KERNEL_POINTS`` is a TPU VMEM limit."""
    how = route(u)
    if how == "kernel":
        grouped_median_bits.launches += 1
        return _bsm.grouped_median_bits_cuda(u, assign, k, weights,
                                             bits=bits)
    if how == "meta":
        lead = u.shape[:-2]
        return (u.new_empty(*lead, k, u.shape[-1]),
                u.new_empty(*lead, k, dtype=torch.float32))
    return _bsm.grouped_median_bits_plain(u, assign, k, weights=weights,
                                          bits=bits)


@op_count.counted(
    lambda x, cents, *, metric="l2": f"distance_argmin {metric}",
    lambda x, cents, *, metric="l2": _work.distance_argmin_work(
        x.shape[0], x.shape[1], cents.shape[0], metric))
def distance_argmin(x: torch.Tensor, cents: torch.Tensor, *,
                    metric: str = "l2"):
    """Closest-centroid assignment: (assign (N,) int32, mindist (N,)).
    Launches are counted per metric (``distance_argmin l1`` and
    ``distance_argmin l2`` in ``launch_counts``, beside their sum)."""
    how = route(x)
    if how == "kernel":
        out = _da.distance_argmin_cuda(x, cents, metric=metric)
        distance_argmin.launches[metric] += 1
        return out
    if how == "meta":
        n = x.shape[0]
        return (x.new_empty(n, dtype=torch.int32),
                x.new_empty(n, dtype=torch.float32))
    return _da.distance_argmin_plain(x, cents, metric=metric)


@op_count.counted("clustered_decode",
                  lambda *a, scale, softcap=None, **kw:
                  _work.clustered_decode_work(*a, **kw))
def clustered_decode(q, k_cents, v_cents, counts, k_tail, v_tail, t, cov,
                     chunk_len=None, *, scale: float,
                     softcap: Optional[float] = None):
    """Fused clustered-KV decode attention (centroids ⊕ tail ring).

    q (B, Hq, Dh) for plain decode, or (B, L, Hq, Dh) for the mixed launch
    with per-slot ``chunk_len`` (B,) valid rows → output shaped like q."""
    how = route(q)
    if how == "kernel":
        clustered_decode.launches += 1
        return _cd.clustered_decode_cuda(
            q, k_cents, v_cents, counts, k_tail, v_tail, t, cov, chunk_len,
            scale=scale, softcap=softcap)
    if how == "meta":
        return torch.empty_like(q)
    return _cd.clustered_decode_plain(
        q, k_cents, v_cents, counts, k_tail, v_tail, t, cov, chunk_len,
        scale=scale, softcap=softcap)


@op_count.counted("paged_clustered_decode",
                  lambda *a, scale, softcap=None, **kw:
                  _work.paged_clustered_decode_work(*a, **kw))
def paged_clustered_decode(q, k_cents, v_cents, counts, k_pool, v_pool,
                           row_slot, row_bt, qpos1, tw, cov, row_wlo=None,
                           row_group=None, *, scale: float,
                           softcap: Optional[float] = None):
    """Paged clustered-KV decode over packed ragged rows.

    q (N, Hq, Dh) packed (slot, position) rows; k/v_pool (nb, bs, Hkv, Dh)
    tail block pools; row_bt (N, T) physical block per ring block (every
    entry valid: unmapped blocks point at a garbage block the masks
    exclude); qpos1 / tw / cov per row: position + 1 (0: padding row),
    ring watermark, coverage frontier; ``row_wlo`` (N,) the retention
    window floor (None: zeros, frontier-only masking); ``row_group`` (N,)
    the kernel's row groups (``paged_clustered_decode.group_rows``; None:
    one row each) → (N, Hq, Dh)."""
    how = route(q)
    if how == "kernel":
        paged_clustered_decode.launches += 1
        return _pcd.paged_clustered_decode_cuda(
            q, k_cents, v_cents, counts, k_pool, v_pool, row_slot, row_bt,
            qpos1, tw, cov, row_wlo, row_group, scale=scale, softcap=softcap)
    if how == "meta":
        return torch.empty_like(q)
    return _pcd.paged_clustered_decode_plain(
        q, k_cents, v_cents, counts, k_pool, v_pool, row_slot, row_bt,
        qpos1, tw, cov, row_wlo, row_group, scale=scale, softcap=softcap)


@op_count.counted("flash_decode",
                  lambda q, k, v, t, **_: _work.flash_decode_work(q, k, v, t))
def flash_decode(q, k, v, t, *, scale: float, softcap: Optional[float] = None,
                 chunk: int = 512):
    """One-token exact GQA attention over a (B, S, Hkv, Dh) cache, positions
    < t: q (B, Hq, Dh) → (B, Hq, Dh).  Nothing in the model calls it, as
    nothing in the reference's does."""
    how = route(q)
    if how == "kernel":
        flash_decode.launches += 1
        return _fd.flash_decode_cuda(q, k, v, t, scale=scale,
                                     softcap=softcap, chunk=chunk)
    if how == "meta":
        return torch.empty_like(q)
    return _fd.flash_decode_plain(q, k, v, t, scale=scale, softcap=softcap,
                                  chunk=chunk)


_WRAPPERS = {"clustered_decode": clustered_decode,
             "paged_clustered_decode": paged_clustered_decode,
             "bitserial_median": grouped_median_bits,
             "flash_decode": flash_decode}


def reset_launches() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
    distance_argmin.launches = {"l1": 0, "l2": 0}


reset_launches()


def launch_counts() -> Dict[str, int]:
    counts = {name: fn.launches for name, fn in _WRAPPERS.items()}
    counts["distance_argmin"] = sum(distance_argmin.launches.values())
    counts.update({f"distance_argmin {m}": n
                   for m, n in distance_argmin.launches.items()})
    return counts
