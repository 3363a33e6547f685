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
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import bitserial_median as _bsm
from repro_torch.kernels import clustered_decode as _cd
from repro_torch.kernels import distance_argmin as _da
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import paged_clustered_decode as _pcd


def use_kernel_for(x: torch.Tensor) -> bool:
    """True when ``x`` lies on a CUDA device: the kernel runs; False on
    the CPU: the plain version runs."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel backend for device {x.device}")


def grouped_median_bits(u: torch.Tensor, assign: torch.Tensor, k: int,
                        weights: Optional[torch.Tensor] = None, *,
                        bits: int = 32):
    """Per-cluster bit-serial medians of unsigned-ordered words.

    u (..., N, D) int64, assign (..., N) → (med (..., k, D) int64, totals
    (..., k) f32).  On the card the kernel runs at every N: the reference's
    fallback above ``MAX_KERNEL_POINTS`` is a TPU VMEM limit."""
    if use_kernel_for(u):
        grouped_median_bits.launches += 1
        return _bsm.grouped_median_bits_cuda(u, assign, k, weights,
                                             bits=bits)
    return _bsm.grouped_median_bits_plain(u, assign, k, weights=weights,
                                          bits=bits)


def distance_argmin(x: torch.Tensor, cents: torch.Tensor, *,
                    metric: str = "l2"):
    """Closest-centroid assignment: (assign (N,) int32, mindist (N,)).
    Launches are counted per metric (``distance_argmin l1`` and
    ``distance_argmin l2`` in ``launch_counts``, beside their sum)."""
    if use_kernel_for(x):
        out = _da.distance_argmin_cuda(x, cents, metric=metric)
        distance_argmin.launches[metric] += 1
        return out
    return _da.distance_argmin_plain(x, cents, metric=metric)


def clustered_decode(q, k_cents, v_cents, counts, k_tail, v_tail, t, cov,
                     chunk_len=None, *, scale: float,
                     softcap: Optional[float] = None):
    """Fused clustered-KV decode attention (centroids ⊕ tail ring).

    q (B, Hq, Dh) for plain decode, or (B, L, Hq, Dh) for the mixed launch
    with per-slot ``chunk_len`` (B,) valid rows → output shaped like q."""
    if use_kernel_for(q):
        clustered_decode.launches += 1
        return _cd.clustered_decode_cuda(
            q, k_cents, v_cents, counts, k_tail, v_tail, t, cov, chunk_len,
            scale=scale, softcap=softcap)
    return _cd.clustered_decode_plain(
        q, k_cents, v_cents, counts, k_tail, v_tail, t, cov, chunk_len,
        scale=scale, softcap=softcap)


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
    if use_kernel_for(q):
        paged_clustered_decode.launches += 1
        return _pcd.paged_clustered_decode_cuda(
            q, k_cents, v_cents, counts, k_pool, v_pool, row_slot, row_bt,
            qpos1, tw, cov, row_wlo, row_group, scale=scale,
            softcap=softcap)
    return _pcd.paged_clustered_decode_plain(
        q, k_cents, v_cents, counts, k_pool, v_pool, row_slot, row_bt,
        qpos1, tw, cov, row_wlo, row_group, scale=scale, softcap=softcap)


def flash_decode(q, k, v, t, *, scale: float, softcap: Optional[float] = None,
                 chunk: int = 512):
    """One-token exact GQA attention over a (B, S, Hkv, Dh) cache, positions
    < t: q (B, Hq, Dh) → (B, Hq, Dh).  Nothing in the model calls it, as
    nothing in the reference's does."""
    if use_kernel_for(q):
        flash_decode.launches += 1
        return _fd.flash_decode_cuda(q, k, v, t, scale=scale,
                                     softcap=softcap, chunk=chunk)
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
