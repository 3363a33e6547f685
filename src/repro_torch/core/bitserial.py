"""Bit-serial median via majority voting — the paper's core algorithm
(port of ``repro.core.bitserial``).

MSB→LSB scan.  At every bit position the majority vote across the still
active inputs yields the median's bit; inputs whose bit disagrees with the
majority retire, and from then on vote their deviating bit, so retired
inputs keep voting on the correct side.  A bit is 1 iff strictly more than
half of the effective votes are 1, so an even count converges to the
*lower* median.

Words are unsigned-ordered fixed point carried in int64 (see
``quantizer``).  The per-bit vote count of the grouped form is a one-hot
matmul over float weights, exact for integer weights below 2^24.  Every
function takes optional leading batch dimensions, which stand for the
``vmap`` over (slot, head) of the reference.

:func:`grouped_median_bits` here is the plain version of the
``bitserial_median`` CUDA kernel.  The float front ends reach it through
``kernels.ops.grouped_median_bits``, which launches the kernel for tensors
on the card, so every grouped median on the card (k-medians updates, the
serve's absorb and compaction) runs the kernel.

The inter-array reduction tree: every entry point takes ``group=`` (a
``torch.distributed`` process group; None is one device), and then the
points are this rank's shard of the set.  The totals and each bit's vote
counts are summed across the group's ranks (``all_reduce``, in int64, so
exactly: the weights are counts or 0/1 masks), and every rank decides the
same bits.  That route is this module's per-bit loop, as the reference's
distributed median is: the kernel decides all bits in one launch and
cannot take a collective between two of them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import quantizer


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (a new tensor); ``x`` as
    is when ``group`` is None."""
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise minimum of ``x`` over the ranks of ``group``."""
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MIN, group=group)
    return y


def _votes(x: torch.Tensor, group) -> torch.Tensor:
    """Integer-valued f32 vote counts summed over ``group`` exactly (in
    int64); ``x`` as is without a group."""
    if group is None:
        return x
    return psum(torch.round(x).to(torch.int64), group)


def _median_limbs(limbs, weights: Optional[torch.Tensor], bits: int,
                  group=None):
    """The vote along axis 0 over words split into limbs, most significant
    first, ``bits`` low bits of each: ``active`` and ``forced`` carry from
    one limb to the next.  Returns one median limb (int64) per limb."""
    shape, dev = limbs[0].shape, limbs[0].device
    w = (torch.ones(shape, dtype=torch.float32, device=dev)
         if weights is None
         else torch.broadcast_to(weights.to(torch.float32), shape))
    total = _votes(w.sum(0), group)
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    forced = torch.zeros(shape, dtype=torch.float32, device=dev)
    meds = []
    for word in limbs:
        word = word.to(torch.int64)
        med = torch.zeros(shape[1:], dtype=torch.int64, device=dev)
        for b in range(bits - 1, -1, -1):
            bit = ((word >> b) & 1).to(torch.float32)
            eff = torch.where(active, bit, forced)
            # 1 iff strictly more ones
            mbit = _votes((w * eff).sum(0), group) * 2 > total
            med = med | (mbit.to(torch.int64) << b)
            out = active & (bit.bool() != mbit.unsqueeze(0))
            forced = torch.where(out, bit, forced)
            active = active & ~out
        meds.append(med)
    return meds


def median_bits(u: torch.Tensor, *, weights: Optional[torch.Tensor] = None,
                bits: int = 32, group=None) -> torch.Tensor:
    """Weighted bit-serial median of unsigned-ordered words along axis 0.

    u (N, ...) int64; weights optional, broadcastable to u, >= 0.  Returns
    the median with the leading axis reduced (int64).  With ``group`` the
    vote counts are summed across its ranks bit by bit."""
    return _median_limbs([u], weights, bits, group)[0]


def grouped_median_bits(u: torch.Tensor, assign: torch.Tensor, k: int, *,
                        weights: Optional[torch.Tensor] = None,
                        bits: int = 32, group=None):
    """Per-cluster bit-serial medians, all clusters in parallel.

    u (..., N, D) int64 words; assign (..., N) in [0, k); weights optional
    (..., N).  Returns (med (..., k, D) int64, totals (..., k) float32);
    totals == 0 marks empty clusters (their median word is 0).  With
    ``group`` the points are this rank's shard: the totals and each bit's
    (K, D) vote counts are summed across the group, level 2 of the
    reduction tree (level 1 is the one-hot matmul within the shard)."""
    u = u.to(torch.int64)
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    if weights is not None:
        onehot = onehot * weights.to(torch.float32).unsqueeze(-1)
    onehot_t = onehot.transpose(-1, -2)                  # (..., K, N)
    total = onehot.sum(-2)                               # (..., K)
    votes = _votes(total, group)
    active = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    forced = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    med = torch.zeros(u.shape[:-2] + (k, u.shape[-1]), dtype=torch.int64,
                      device=u.device)
    gidx = assign.long().unsqueeze(-1).expand(u.shape)   # (..., N, D)
    for b in range(bits - 1, -1, -1):
        bit = ((u >> b) & 1).to(torch.float32)
        eff = torch.where(active, bit, forced)
        cnt1 = _votes(torch.matmul(onehot_t, eff), group)   # (..., K, D)
        mbit = cnt1 * 2 > votes.unsqueeze(-1)
        med = med | (mbit.to(torch.int64) << b)
        # broadcast each point's cluster-median bit back (gather)
        mper = torch.gather(mbit, -2, gidx)
        dev = active & (bit.bool() != mper)
        forced = torch.where(dev, bit, forced)
        active = active & ~dev
    return med, (total if group is None else votes.to(torch.float32))


def median_bits64(hi: torch.Tensor, lo: torch.Tensor, *,
                  weights: Optional[torch.Tensor] = None, group=None):
    """64-bit two-limb variant (the paper's 64-bit fixed point): hi, lo
    (N, ...) int64 holding the uint32 limbs of unsigned-ordered 64-bit
    words.  Returns (med_hi, med_lo) int64 limbs, bits 63..0 scanned."""
    med_hi, med_lo = _median_limbs([hi, lo], weights, 32, group)
    return med_hi, med_lo


def _point_scale(scale):
    """A per-feature scale row broadcasts over the point / cluster axis."""
    if torch.is_tensor(scale) and scale.dim() >= 1:
        return scale.unsqueeze(-2)
    return scale


def median(x: torch.Tensor, *, bits: int = 32, scale=None,
           weights: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Bit-serial median of float data along axis 0 (per remaining dims).

    ``weights`` holds one weight per point, shaped (N,) or (N, 1, ...).
    With ``group`` the points are this rank's shard: the scale is the
    group's smallest (the largest magnitude wins) and the votes are
    summed across it (:func:`median_bits`)."""
    if scale is None:
        if x.dim() > 1:
            scale = quantizer.auto_scale(
                x.reshape(x.shape[0], -1), bits).reshape(x.shape[1:])
        else:
            scale = quantizer.auto_scale(x[:, None], bits)[0]
        if group is not None:
            scale = pmin(torch.as_tensor(scale, device=x.device), group)
    spec = quantizer.FixedPointSpec(bits=bits, scale=scale)
    u = quantizer.to_unsigned_order(quantizer.quantize(x, spec), bits)
    n = u.shape[0]
    if weights is not None:
        if weights.numel() != n or weights.shape[:1] != (n,):
            raise ValueError(
                f"median takes one weight per point, shape ({n},) or "
                f"({n}, 1, ...), not {tuple(weights.shape)}; per-element "
                "weights go through median_bits")
        weights = weights.reshape(n)
    if group is not None:
        w = None if weights is None else weights.reshape(
            (n,) + (1,) * (u.dim() - 1))
        med_u = median_bits(u, weights=w, bits=bits, group=group)
    else:
        # one cluster of every point: the grouped kernel's path
        from repro_torch.kernels import ops

        assign = torch.zeros((n,), dtype=torch.int32, device=u.device)
        med_u, _ = ops.grouped_median_bits(u.reshape(n, -1), assign, 1,
                                           weights, bits=bits)
        med_u = med_u.reshape(u.shape[1:])
    return quantizer.dequantize(quantizer.from_unsigned_order(med_u, bits),
                                spec)


def grouped_median(x: torch.Tensor, assign: torch.Tensor, k: int, *,
                   bits: int = 32, scale=None,
                   weights: Optional[torch.Tensor] = None, group=None):
    """Per-cluster float medians: x (..., N, D), assign (..., N) →
    ((..., k, D), totals (..., k)).  With ``group`` the points are this
    rank's shard (a scale left to this function is the group's smallest)
    and the medians take :func:`grouped_median_bits`'s per-bit loop with
    its votes summed across the group."""
    if scale is None:
        scale = quantizer.auto_scale(x, bits)
        if group is not None:
            scale = pmin(torch.as_tensor(scale, device=x.device), group)
    spec = quantizer.FixedPointSpec(bits=bits, scale=_point_scale(scale))
    u = quantizer.to_unsigned_order(quantizer.quantize(x, spec), bits)
    if group is not None:
        med_u, totals = grouped_median_bits(u, assign, k, weights=weights,
                                            bits=bits, group=group)
    else:
        from repro_torch.kernels import ops

        med_u, totals = ops.grouped_median_bits(u, assign, k, weights,
                                                bits=bits)
    return (quantizer.dequantize(quantizer.from_unsigned_order(med_u, bits),
                                 spec), totals)


def sort_median_ref(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sort-based lower-median oracle: element at 1-based rank ceil(N/2)."""
    n = x.shape[axis]
    xs = torch.sort(x, dim=axis).values
    return xs.select(axis, (n + 1) // 2 - 1)
