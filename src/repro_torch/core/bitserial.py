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
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantizer


def median_bits(u: torch.Tensor, *, weights: Optional[torch.Tensor] = None,
                bits: int = 32) -> torch.Tensor:
    """Weighted bit-serial median of unsigned-ordered words along axis 0.

    u (N, ...) int64; weights optional, broadcastable to u, >= 0.  Returns
    the median with the leading axis reduced (int64)."""
    u = u.to(torch.int64)
    w = (torch.ones(u.shape, dtype=torch.float32, device=u.device)
         if weights is None
         else torch.broadcast_to(weights.to(torch.float32), u.shape))
    total = w.sum(0)
    active = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    forced = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    med = torch.zeros(u.shape[1:], dtype=torch.int64, device=u.device)
    for b in range(bits - 1, -1, -1):
        bit = ((u >> b) & 1).to(torch.float32)
        eff = torch.where(active, bit, forced)
        cnt1 = (w * eff).sum(0)
        mbit = cnt1 * 2.0 > total        # majority: 1 iff strictly more ones
        med = med | (mbit.to(torch.int64) << b)
        dev = active & (bit.bool() != mbit.unsqueeze(0))
        forced = torch.where(dev, bit, forced)
        active = active & ~dev
    return med


def grouped_median_bits(u: torch.Tensor, assign: torch.Tensor, k: int, *,
                        weights: Optional[torch.Tensor] = None,
                        bits: int = 32):
    """Per-cluster bit-serial medians, all clusters in parallel.

    u (..., N, D) int64 words; assign (..., N) in [0, k); weights optional
    (..., N).  Returns (med (..., k, D) int64, totals (..., k) float32);
    totals == 0 marks empty clusters (their median word is 0)."""
    u = u.to(torch.int64)
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    if weights is not None:
        onehot = onehot * weights.to(torch.float32).unsqueeze(-1)
    onehot_t = onehot.transpose(-1, -2)                  # (..., K, N)
    total = onehot.sum(-2)                               # (..., K)
    active = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    forced = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    med = torch.zeros(u.shape[:-2] + (k, u.shape[-1]), dtype=torch.int64,
                      device=u.device)
    gidx = assign.long().unsqueeze(-1).expand(u.shape)   # (..., N, D)
    for b in range(bits - 1, -1, -1):
        bit = ((u >> b) & 1).to(torch.float32)
        eff = torch.where(active, bit, forced)
        cnt1 = torch.matmul(onehot_t, eff)               # (..., K, D)
        mbit = cnt1 * 2.0 > total.unsqueeze(-1)
        med = med | (mbit.to(torch.int64) << b)
        # broadcast each point's cluster-median bit back (gather)
        mper = torch.gather(mbit, -2, gidx)
        dev = active & (bit.bool() != mper)
        forced = torch.where(dev, bit, forced)
        active = active & ~dev
    return med, total


def _point_scale(scale):
    """A per-feature scale row broadcasts over the point / cluster axis."""
    if torch.is_tensor(scale) and scale.dim() >= 1:
        return scale.unsqueeze(-2)
    return scale


def median(x: torch.Tensor, *, bits: int = 32, scale=None,
           weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bit-serial median of float data along axis 0 (per remaining dims)."""
    if scale is None:
        if x.dim() > 1:
            scale = quantizer.auto_scale(
                x.reshape(x.shape[0], -1), bits).reshape(x.shape[1:])
        else:
            scale = quantizer.auto_scale(x[:, None], bits)[0]
    spec = quantizer.FixedPointSpec(bits=bits, scale=scale)
    u = quantizer.to_unsigned_order(quantizer.quantize(x, spec), bits)
    med_u = median_bits(u, weights=weights, bits=bits)
    return quantizer.dequantize(quantizer.from_unsigned_order(med_u, bits),
                                spec)


def grouped_median(x: torch.Tensor, assign: torch.Tensor, k: int, *,
                   bits: int = 32, scale=None,
                   weights: Optional[torch.Tensor] = None):
    """Per-cluster float medians: x (..., N, D), assign (..., N) →
    ((..., k, D), totals (..., k))."""
    if scale is None:
        scale = quantizer.auto_scale(x, bits)
    spec = quantizer.FixedPointSpec(bits=bits, scale=_point_scale(scale))
    u = quantizer.to_unsigned_order(quantizer.quantize(x, spec), bits)
    med_u, totals = grouped_median_bits(u, assign, k, weights=weights,
                                        bits=bits)
    return (quantizer.dequantize(quantizer.from_unsigned_order(med_u, bits),
                                 spec), totals)


def sort_median_ref(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sort-based lower-median oracle: element at 1-based rank ceil(N/2)."""
    n = x.shape[axis]
    xs = torch.sort(x, dim=axis).values
    return xs.select(axis, (n + 1) // 2 - 1)
