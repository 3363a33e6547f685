"""Fixed-point conversion front end (paper §4), port of ``repro.core.quantizer``.

Floats are scaled by a per-feature power of two and rounded to signed fixed
point; the bit-serial scan then runs on an unsigned-comparable ordering
(sign bit of the fixed-point width flipped), so bit order is numeric order.

Unsigned-ordered words are carried in ``torch.int64``: PyTorch has no
shifts or comparisons for ``torch.uint32`` on the CPU, and every word of a
``bits <= 32`` width fits an int64 exactly.  ``torch.round`` rounds half to
even, as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FixedPointSpec:
    """Quantization spec. ``scale`` maps float -> fixed: q = round(x * scale).

    ``scale`` may be a scalar or a per-feature (broadcastable) tensor of
    powers of two, mirroring the paper's 2^f scaling.
    """

    bits: int = 32
    scale: object = 1.0

    def __post_init__(self):
        if self.bits not in (8, 16, 32):
            raise ValueError(f"unsupported fixed-point width {self.bits}")


def auto_scale(x: torch.Tensor, bits: int = 32, margin_bits: int = 2,
               dim: int = -2) -> torch.Tensor:
    """Per-feature power-of-two scale so data spans the fixed-point range.

    Leaves ``margin_bits`` of headroom.  Reduces over the point axis
    ``dim`` (default -2: (..., N, D) -> (..., D)), so a batch of
    independent point sets gets one scale row each.
    """
    absmax = x.abs().amax(dim=dim).clamp_min(1e-30)
    # largest f with absmax * 2^f <= 2^(bits-1-margin); capped so the scale
    # stays finite in float32 even for all-zero (fully masked) features
    f = torch.floor((bits - 1 - margin_bits) - torch.log2(absmax))
    return pow2(torch.clamp(f, max=126.0))


def pow2(f: torch.Tensor) -> torch.Tensor:
    """2^f exactly, for integer-valued f in [-126, 127], built from the
    float32 exponent bits.  (The reference's ``jnp.exp2`` lowers to
    exp(f · ln 2), which on XLA's CPU backend misses 2^f by an ulp or more
    for most f — e.g. 2^27 comes out as 134217672; see ROADMAP Queue C.)"""
    bits = (f.to(torch.int32) + 127) << 23
    return bits.view(torch.float32)


def quantize(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """float -> signed fixed point, as int64 holding a ``spec.bits`` value."""
    scaled = x * spec.scale
    lim = float(2 ** (spec.bits - 1) - 1)
    q = torch.clamp(torch.round(scaled), -lim - 1, lim)
    return q.to(torch.int64)


def dequantize(q: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    return q.to(torch.float32) / spec.scale


def quantize64_host(x: np.ndarray, scale) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (numpy float64) 64-bit fixed-point encode: returns
    unsigned-comparable (hi, lo) uint32 limbs (sign bit already flipped)."""
    q = np.clip(np.round(np.asarray(x, np.float64) * scale), -(2.0 ** 63),
                2.0 ** 63 - 1)
    u = q.astype(np.int64).astype(np.uint64) ^ np.uint64(0x8000000000000000)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def dequantize64_host(hi: np.ndarray, lo: np.ndarray, scale) -> np.ndarray:
    u = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    qi = (u ^ np.uint64(0x8000000000000000)).astype(np.int64)
    return qi.astype(np.float64) / scale


def to_unsigned_order(q: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """Signed fixed point -> unsigned-comparable word (int64 in [0, 2^bits)):
    flip the sign bit of the fixed-point width and mask to that width."""
    mask = (1 << bits) - 1
    return (q.to(torch.int64) & mask) ^ (1 << (bits - 1))


def from_unsigned_order(u: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """Inverse of :func:`to_unsigned_order`: back to signed (int64)."""
    mask = (1 << bits) - 1
    v = (u.to(torch.int64) ^ (1 << (bits - 1))) & mask
    return torch.where(v >= (1 << (bits - 1)), v - (1 << bits), v)
