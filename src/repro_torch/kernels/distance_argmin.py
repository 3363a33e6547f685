"""Blocked distance + argmin (the clustering assignment step): the CUDA
kernel's wrapper and its plain PyTorch version (port of
``repro.kernels.distance_argmin``; kernel source
``csrc/distance_argmin.cu``).

L2 is the squared distance by the expansion ‖x‖² − 2·x·cᵀ + ‖c‖² clamped at
0; L1 is Σ|x − c|.  Returns (assign (N,) int32, mindist (N,) f32); ties take
the first index.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

POINTS_PER_BLOCK = 256


def distance_argmin_plain(x: torch.Tensor, cents: torch.Tensor, *,
                          metric: str = "l2"):
    """Step-by-step PyTorch version of the kernel: x (N, D), cents (K, D)."""
    x = x.to(torch.float32)
    cents = cents.to(torch.float32)
    if metric == "l2":
        x2 = (x * x).sum(1, keepdim=True)
        c2 = (cents * cents).sum(1)[None, :]
        dist = torch.clamp(x2 - 2.0 * (x @ cents.T) + c2, min=0.0)
        return torch.argmin(dist, 1).to(torch.int32), dist.amin(1)
    if metric != "l1":
        raise ValueError(f"unknown metric {metric}")
    best_d = torch.full((x.shape[0],), float("inf"), dtype=torch.float32,
                        device=x.device)
    best_i = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    for i in range(cents.shape[0]):
        di = (x - cents[i][None, :]).abs().sum(1)
        better = di < best_d
        best_d = torch.where(better, di, best_d)
        best_i = torch.where(better, torch.full_like(best_i, i), best_i)
    return best_i, best_d


def shared_bytes(k: int, d: int) -> int:
    """Dynamic shared memory of one block: centroids, ‖c‖², staged points."""
    return 4 * (k * d + k + POINTS_PER_BLOCK * (d | 1))


def distance_argmin_cuda(x: torch.Tensor, cents: torch.Tensor, *,
                         metric: str = "l2"):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``."""
    if metric not in ("l1", "l2"):
        raise ValueError(f"unknown metric {metric}")
    if not (x.is_cuda and cents.is_cuda and x.device == cents.device):
        raise ValueError("distance_argmin: x and cents must be on one CUDA "
                         "device")
    if x.dtype != torch.float32 or cents.dtype != torch.float32:
        raise TypeError("distance_argmin kernel takes float32 x and cents")
    if x.dim() != 2 or cents.dim() != 2 or x.shape[1] != cents.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, cents "
                         f"{tuple(cents.shape)}: want (N, D) and (K, D)")
    if not (x.is_contiguous() and cents.is_contiguous()):
        raise ValueError("distance_argmin kernel needs contiguous inputs")
    n, d = x.shape
    k = cents.shape[0]
    if shared_bytes(k, d) > _build.MAX_SHARED_BYTES:
        raise ValueError(f"centroid bank K={k} x D={d} does not fit the "
                         f"{_build.MAX_SHARED_BYTES}-byte shared memory of a "
                         "block")
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    mind = torch.empty((n,), dtype=torch.float32, device=x.device)
    _build.launch("distance_argmin", 1 if metric == "l1" else 0,
                  x.data_ptr(), cents.data_ptr(), n, k, d, assign.data_ptr(),
                  mind.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return assign, mind
