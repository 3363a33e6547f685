"""Public wrappers of the kernels and the backend choice (port of
``repro.kernels.ops``).

The backend follows the tensors: a CPU tensor takes the kernel's plain
PyTorch version (what the tests run), a CUDA tensor launches the
hand-written kernel — built at first use — or raises.  There is no
fallback from the card to the plain version.  This is the counterpart of
the reference's ``interpret_default``.

Each wrapper carries a plain integer ``launches`` that it bumps where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels (``reset_launches`` / ``launch_counts``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import clustered_decode as _cd
from repro_torch.kernels import distance_argmin as _da
from repro_torch.kernels import paged_clustered_decode as _pcd


def use_kernel_for(x: torch.Tensor) -> bool:
    """True when ``x`` lies on a CUDA device: the kernel runs; False on
    the CPU: the plain version runs."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel backend for device {x.device}")


def distance_argmin(x: torch.Tensor, cents: torch.Tensor, *,
                    metric: str = "l2"):
    """Closest-centroid assignment: (assign (N,) int32, mindist (N,))."""
    if use_kernel_for(x):
        distance_argmin.launches += 1
        return _da.distance_argmin_cuda(x, cents, metric=metric)
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
                           *, scale: float, softcap: Optional[float] = None):
    """Paged clustered-KV decode over packed ragged rows.

    q (N, Hq, Dh) packed (slot, position) rows; k/v_pool (nb, bs, Hkv, Dh)
    tail block pools; row_bt (N, T) physical block per ring block (every
    entry valid: unmapped blocks point at a garbage block the masks
    exclude); qpos1 / tw / cov per row: position + 1 (0: padding row),
    ring watermark, coverage frontier; ``row_wlo`` (N,) the retention
    window floor (None: zeros, frontier-only masking) → (N, Hq, Dh)."""
    if use_kernel_for(q):
        paged_clustered_decode.launches += 1
        return _pcd.paged_clustered_decode_cuda(
            q, k_cents, v_cents, counts, k_pool, v_pool, row_slot, row_bt,
            qpos1, tw, cov, row_wlo, scale=scale, softcap=softcap)
    return _pcd.paged_clustered_decode_plain(
        q, k_cents, v_cents, counts, k_pool, v_pool, row_slot, row_bt,
        qpos1, tw, cov, row_wlo, scale=scale, softcap=softcap)


distance_argmin.launches = 0
clustered_decode.launches = 0
paged_clustered_decode.launches = 0
_WRAPPERS = {"clustered_decode": clustered_decode,
             "paged_clustered_decode": paged_clustered_decode,
             "distance_argmin": distance_argmin}


def reset_launches() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}
