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
#: points per block of the streamed form: large enough that the chunk
#: partials (K x 16 bins x D floats a chunk) stay well below the words
STREAM_CHUNK = 4096


def tile_width(d: int) -> int:
    return min(d, 32)


def resident_bytes(n: int, d: int, k: int) -> int:
    """Shared memory of one resident block: words and weights in cluster
    order, each point's cluster and rank, the clusters' first rows and
    their order."""
    return 4 * (n * tile_width(d) + 3 * n + 2 * k + 1)


def grouped_median_digits(u: torch.Tensor, assign: torch.Tensor, k: int,
                          weights: Optional[torch.Tensor] = None, *,
                          bits: int = 32, digit: int = 4,
                          chunk: int = 0):
    """Plain twin of the kernel's selection, for the tests: points of
    weight 0 or outside [0, k) dropped, the low ``bits`` bits of each word;
    the median chosen ``digit`` bits at a time from the top (the last digit
    narrower when ``digit`` does not divide ``bits``) as the largest digit v
    with 2 (above + sum_{v' >= v} hist[v']) > total, where hist is the
    weighted histogram of the digit over the points on their cluster's
    median prefix, summed per chunk of ``chunk`` points (0: one chunk) and
    then over the chunks, and ``above`` the weight already left
    upwards.  ``digit=1`` is the resident kernel's bit-by-bit scan,
    ``digit=4`` with a chunk the streamed form (``kMaxDigit`` in
    csrc/bitserial_median.cu).  Same signature and result as
    ``grouped_median_bits_plain``."""
    lead = u.shape[:-2]
    n, d = u.shape[-2:]
    x = (u.to(torch.int64) & ((1 << bits) - 1)).reshape(-1, n, d)
    a = assign.reshape(-1, n).long()
    w = (torch.ones(a.shape) if weights is None else torch.broadcast_to(
        weights.to(torch.float32), assign.shape).reshape(-1, n))
    keep = (a >= 0) & (a < k) & (w != 0)
    onehot = (torch.nn.functional.one_hot(a.clamp(0, k - 1), k).float()
              * torch.where(keep, w, torch.zeros_like(w)).unsqueeze(-1))
    spans = [(s, min(n, s + chunk)) for s in range(0, n, chunk)] if chunk \
        else [(0, n)]
    total = torch.zeros(onehot.shape[0], k)
    for s, e in spans:
        total = total + onehot[:, s:e].sum(1)
    med = torch.zeros(onehot.shape[0], k, d, dtype=torch.int64)
    above = torch.zeros(onehot.shape[0], k, d)
    gidx = a.clamp(0, k - 1).unsqueeze(-1).expand(x.shape)
    hi = bits
    while hi > 0:
        lo = max(0, hi - digit)
        nb = 1 << (hi - lo)
        dv = (x >> lo) - torch.gather(med >> lo, 1, gidx)   # (M, N, D)
        hist = torch.zeros(onehot.shape[0], nb, k, d)
        for s, e in spans:
            hot = (dv[:, s:e].unsqueeze(1) == torch.arange(nb).view(
                1, nb, 1, 1)).float()                     # (M, nb, n, D)
            hist = hist + torch.einsum("mnk,mvnd->mvkd", onehot[:, s:e], hot)
        cum = above
        vstar = torch.zeros_like(med)
        found = torch.zeros(med.shape, dtype=torch.bool)
        for v in range(nb - 1, 0, -1):
            nxt = cum + hist[:, v]
            hit = ~found & (nxt * 2.0 > total.unsqueeze(-1))
            vstar = torch.where(hit, v, vstar)
            found = found | hit
            cum = torch.where(found, cum, nxt)
        above = cum
        med = med | (vstar << lo)
        hi = lo
    return med.reshape(lead + (k, d)), total.reshape(lead + (k,))


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
    if 4 * (3 * k * td + k) > _build.MAX_SHARED_BYTES:
        raise ValueError(f"K={k} counts do not fit the "
                         f"{_build.MAX_SHARED_BYTES}-byte shared memory of a "
                         "block")
    u = u.contiguous()
    if u.data_ptr() % 16:        # the kernel reads 16-byte pairs of words
        u = u.clone()
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
        scratch = torch.empty(
            _build.query("bitserial_median_scratch_bytes", m, n, d, k, chunk),
            dtype=torch.uint8, device=u.device)
    _build.launch("bitserial_median", u.data_ptr(), a.data_ptr(),
                  None if w is None else w.data_ptr(), m, n, d, k, bits,
                  chunk, med.data_ptr(), totals.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    return med, totals
