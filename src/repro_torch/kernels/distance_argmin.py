"""Blocked distance + argmin (the clustering assignment step): the CUDA
kernel's wrapper, its plain PyTorch version and a sequential twin of its
arithmetic (port of ``repro.kernels.distance_argmin``; kernel source
``csrc/distance_argmin.cu``).

L2 is the squared distance by the expansion ‖x‖² − 2·x·cᵀ + ‖c‖² clamped at
0; L1 is Σ|x − c|.  Returns (assign (N,) int32, mindist (N,) f32); ties take
the first index.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


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


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) of f32 tensors: the product is exact in f64, then one
    rounding to f64 and one to f32 (equal to a fused multiply-add except
    where the two roundings meet a tie)."""
    return (a.double() * b.double() + c.double()).float()


def distance_argmin_sequential(x: torch.Tensor, cents: torch.Tensor, *,
                               metric: str = "l2"):
    """Plain twin of the kernel's arithmetic, for the tests: each (point,
    centroid) distance is one chain over d = 0 … D−1 in order, of
    elementwise f32 operations — L1 ``dist += |x − c|``; L2 x·c, ‖x‖² and
    ‖c‖² as multiply-add chains (``_fma``), then max(‖x‖² − 2·x·c + ‖c‖², 0)
    — and the first strictly smaller distance wins: ties keep the first
    index, a NaN never wins (L2's clamp turns it into 0 first, as the
    kernel's ``fmaxf`` does), and a row with no finite distance gives (inf,
    0).  L1 takes only IEEE subtract, abs and add, so on either device it
    equals the kernel bit for bit."""
    x = x.to(torch.float32)
    cents = cents.to(torch.float32)
    n, d = x.shape
    dist = torch.zeros((n, cents.shape[0]), dtype=torch.float32,
                       device=x.device)
    if metric == "l1":
        for j in range(d):
            dist = dist + (x[:, j, None] - cents[None, :, j]).abs()
    elif metric == "l2":
        x2 = torch.zeros((n, 1), dtype=torch.float32, device=x.device)
        c2 = torch.zeros((1, cents.shape[0]), dtype=torch.float32,
                         device=x.device)
        for j in range(d):
            xj, cj = x[:, j, None], cents[None, :, j]
            dist = _fma(xj, cj, dist)
            x2 = _fma(xj, xj, x2)
            c2 = _fma(cj, cj, c2)
        # fmax, as the kernel's fmaxf: a NaN becomes 0
        dist = torch.fmax((x2 - 2.0 * dist) + c2, dist.new_zeros(()))
    else:
        raise ValueError(f"unknown metric {metric}")
    # a NaN never wins: it is no smaller than the starting inf
    dist = torch.where(torch.isnan(dist), float("inf"), dist)
    first = torch.argmin(dist, 1)          # the first of equal minima
    return first.to(torch.int32), dist.gather(1, first[:, None])[:, 0]


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
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    mind = torch.empty((n,), dtype=torch.float32, device=x.device)
    _build.launch("distance_argmin", 1 if metric == "l1" else 0,
                  x.data_ptr(), cents.data_ptr(), n, k, d, assign.data_ptr(),
                  mind.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return assign, mind
