"""Grouped bit-serial median (the k-medians centroid update): the CUDA
kernel's wrapper and its plain PyTorch version (port of
``repro.kernels.bitserial_median``; kernel source
``csrc/bitserial_median.cu``).

u (..., N, D) unsigned-ordered words in int64 (< 2^32), assign (..., N) in
[0, k), optional weights (..., N) → (med (..., k, D) int64, totals (..., k)
f32).  Leading dimensions are independent members (the serve's
(layer, slot, head) groups).  For integer-valued weights with totals below
2^24 the kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import bitserial
from repro_torch.kernels import _build

#: the plain version: the per-bit one-hot matmul form of core.bitserial
grouped_median_bits_plain = bitserial.grouped_median_bits

#: a member's tile is staged whole (resident form) while its shared memory
#: stays at or below this, so two blocks fit an SM; above, the streamed form
RESIDENT_MAX_BYTES = 100 * 1024
#: points per block of the streamed form
STREAM_CHUNK = 2048


def tile_width(d: int) -> int:
    return min(d, 32)


def resident_bytes(n: int, d: int, k: int) -> int:
    """Shared memory of one resident block: words, median prefix, counts,
    totals, assignments and weights."""
    td = tile_width(d)
    return 4 * (n * td + 2 * k * td + k + 2 * n)


def grouped_median_bits_cuda(u: torch.Tensor, assign: torch.Tensor, k: int,
                             weights: Optional[torch.Tensor] = None, *,
                             bits: int = 32):
    """Launch the kernel on ``torch.cuda.current_stream()``; the form
    (resident or streamed) follows N."""
    if not (u.is_cuda and assign.is_cuda and assign.device == u.device):
        raise ValueError("bitserial_median: u and assign must be on one CUDA "
                         "device")
    if u.dtype != torch.int64:
        raise TypeError("bitserial_median kernel takes int64 words")
    if u.dim() < 2 or assign.shape != u.shape[:-1]:
        raise ValueError(f"shapes u {tuple(u.shape)}, assign "
                         f"{tuple(assign.shape)}: want (..., N, D), (..., N)")
    if not 1 <= bits <= 32:
        raise ValueError(f"bits {bits}: the kernel scans words of <= 32 bits")
    lead = u.shape[:-2]
    n, d = u.shape[-2:]
    m = math.prod(lead)
    td = tile_width(max(d, 1))
    if 4 * (2 * k * td + k) > _build.MAX_SHARED_BYTES:
        raise ValueError(f"K={k} counts do not fit the "
                         f"{_build.MAX_SHARED_BYTES}-byte shared memory of a "
                         "block")
    u = u.contiguous()
    a = assign.to(torch.int32).contiguous()
    w = None
    if weights is not None:
        w = torch.broadcast_to(weights.to(torch.float32, copy=False),
                               assign.shape).contiguous()
    med = torch.empty(lead + (k, d), dtype=torch.int64, device=u.device)
    totals = torch.empty(lead + (k,), dtype=torch.float32, device=u.device)
    resident = resident_bytes(n, d, k) <= RESIDENT_MAX_BYTES
    chunk = 0 if resident else STREAM_CHUNK
    scratch = None
    if chunk:
        n_chunks = -(-n // chunk)
        scratch = torch.empty(m * n_chunks * k * (d + 1), dtype=torch.float32,
                              device=u.device)
    _build.launch("bitserial_median", u.data_ptr(), a.data_ptr(),
                  None if w is None else w.data_ptr(), m, n, d, k, bits,
                  chunk, med.data_ptr(), totals.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    return med, totals
