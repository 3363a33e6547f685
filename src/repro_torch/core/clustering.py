"""K-means / k-medians ("aggregations") clustering engine (port of
``repro.core.clustering``).

The paper's Algorithm 1 loop — assign → recompute centroids until
convergence — with arithmetic-mean (k-means) or bit-serial-median
(k-medians) centroids, L1 or L2 assignment, weighted points, and random or
k-means++ initialisation.

Every function takes optional leading batch dimensions, which stand for the
reference's ``vmap`` over (slot, head): x (..., N, D), centroids
(..., K, D), weights (..., N).  A batched :func:`fit` freezes each member
once it converges, exactly as ``jax.lax.while_loop`` does under ``vmap``,
so a member's result never depends on the batch it ran in.

Random initialisation draws from a ``torch.Generator``; those draws are not
``jax.random``'s threefry draws, so a fit without ``init_centroids`` starts
elsewhere than the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import bitserial, quantizer


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    k: int
    metric: str = "l1"            # "l1" | "l2"
    centroid: str = "median"      # "median" (paper) | "mean" (k-means)
    max_iters: int = 50
    tol: float = 1e-4
    init: str = "kmeanspp"        # "kmeanspp" | "random"
    bits: int = 32                # fixed-point width for the bit-serial scan
    seed: int = 0


class ClusterResult(NamedTuple):
    centroids: torch.Tensor
    assign: torch.Tensor
    inertia: torch.Tensor
    n_iters: torch.Tensor
    counts: torch.Tensor


# ---------------------------------------------------------------------------
# Distances / assignment
# ---------------------------------------------------------------------------


def pairwise_dist(x: torch.Tensor, cents: torch.Tensor,
                  metric: str) -> torch.Tensor:
    """x (..., n, D), cents (..., K, D) → (..., n, K) distances (L2 is
    squared L2, by the same expansion and clamp as the reference)."""
    if metric == "l2":
        x2 = (x * x).sum(-1, keepdim=True)                  # (..., n, 1)
        c2 = (cents * cents).sum(-1).unsqueeze(-2)          # (..., 1, K)
        xc = torch.matmul(x, cents.transpose(-1, -2))
        return torch.clamp(x2 - 2.0 * xc + c2, min=0.0)
    if metric == "l1":
        # one centroid at a time: no (n, K, D) intermediate
        return torch.stack(
            [(x - cents[..., i:i + 1, :]).abs().sum(-1)
             for i in range(cents.shape[-2])], dim=-1)
    raise ValueError(f"unknown metric {metric}")


def assign_points(x: torch.Tensor, cents: torch.Tensor, metric: str,
                  use_kernel: bool = True):
    """Closest centroid: returns (assign (..., N) int32, mindist (..., N)).

    ``use_kernel`` routes through ``kernels.ops.distance_argmin`` (the CUDA
    kernel for tensors on the card, its plain version on the CPU), one
    launch per batch member."""
    if use_kernel:
        from repro_torch.kernels import ops as kops

        if x.dim() == 2:
            return kops.distance_argmin(x, cents, metric=metric)
        lead = x.shape[:-2]
        xf = x.reshape((-1,) + x.shape[-2:])
        cf = cents.reshape((-1,) + cents.shape[-2:])
        outs = [kops.distance_argmin(xf[i], cf[i], metric=metric)
                for i in range(xf.shape[0])]
        a = torch.stack([o[0] for o in outs]).reshape(lead + x.shape[-2:-1])
        m = torch.stack([o[1] for o in outs]).reshape(lead + x.shape[-2:-1])
        return a, m
    dist = pairwise_dist(x, cents, metric)
    # argmin takes the first of equal values, as jnp.argmin does
    return torch.argmin(dist, -1).to(torch.int32), dist.amin(-1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_random(generator: torch.Generator, x: torch.Tensor, k: int):
    idx = torch.randperm(x.shape[0], generator=generator)[:k]
    return x[idx.to(x.device)]


def init_kmeanspp(generator: torch.Generator, x: torch.Tensor, k: int,
                  metric: str = "l2", weights=None):
    """k-means++ (D^2 sampling; D^1 for L1/k-medians) on one point set
    (N, D).  Optional point ``weights`` scale the sampling probabilities —
    zero-weight points are never chosen as seeds."""
    n, d = x.shape

    def draw(probs):
        return int(torch.multinomial(probs.detach().double().cpu(), 1,
                                     generator=generator))

    if weights is None:
        first = x[int(torch.randint(0, n, (1,), generator=generator))]
    else:
        wsum = weights.sum()
        probs0 = (weights / wsum if float(wsum) > 0
                  else torch.full((n,), 1.0 / n, device=x.device))
        first = x[draw(probs0)]
    cents = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    cents[0] = first
    mind = pairwise_dist(x, first[None, :], metric)[:, 0]
    for i in range(1, k):
        w = mind if metric == "l2" else torch.clamp(mind, min=0.0)
        if weights is not None:
            w = w * weights
        wsum = w.sum()
        probs = (w / wsum if float(wsum) > 0
                 else torch.full((n,), 1.0 / n, device=x.device))
        c = x[draw(probs)]
        cents[i] = c
        mind = torch.minimum(mind, pairwise_dist(x, c[None, :], metric)[:, 0])
    return cents


# ---------------------------------------------------------------------------
# Centroid updates
# ---------------------------------------------------------------------------


def seed_empty_centroids(x: torch.Tensor, cents: torch.Tensor,
                         live: torch.Tensor, metric: str, weights=None):
    """Deterministically re-seed dead centroid rows by greedy farthest-point
    (maximin) selection over the weighted point set.

    Rows with ``live`` False are replaced one at a time by the point
    farthest from every centroid placed so far; live rows keep their values
    and shape the distance field.  Zero-weight points are never chosen.
    x (..., n, D), cents (..., K, D), live (..., K), weights (..., n)."""
    k = cents.shape[-2]
    w = (torch.ones(x.shape[:-1], dtype=torch.float32, device=x.device)
         if weights is None else weights.to(torch.float32))
    dist0 = pairwise_dist(x, cents, metric)                  # (..., n, K)
    mind = torch.where(live.unsqueeze(-2), dist0,
                       torch.full_like(dist0, float("inf"))).amin(-1)
    # no live row yet → flat field: the first dead row takes the first
    # positively-weighted point, the rest spread by maximin from there
    mind = torch.where(torch.isfinite(mind), mind, torch.ones_like(mind))
    cents = cents.clone()
    for i in range(k):
        score = torch.where(w > 0, mind, torch.full_like(mind, -1.0))
        idx = torch.argmax(score, -1)                        # (...,)
        c_new = torch.gather(
            x, -2, idx[..., None, None].expand(idx.shape + (1, x.shape[-1])))
        c_i = torch.where(live[..., i, None, None], cents[..., i:i + 1, :],
                          c_new)                             # (..., 1, D)
        cents[..., i:i + 1, :] = c_i
        mind = torch.minimum(mind, pairwise_dist(x, c_i, metric)[..., 0])
    return cents


def _onehot(assign, k, weights):
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    if weights is not None:
        onehot = onehot * weights.to(torch.float32).unsqueeze(-1)
    return onehot


def update_mean(x, assign, k: int, prev, *, weights=None):
    """Weighted mean centroids; empty clusters keep ``prev``."""
    onehot = _onehot(assign, k, weights)
    sums = torch.matmul(onehot.transpose(-1, -2), x)
    counts = onehot.sum(-2)
    mean = sums / torch.clamp(counts, min=1.0).unsqueeze(-1)
    return torch.where(counts.unsqueeze(-1) > 0, mean, prev), counts


def update_median(x, assign, k: int, prev, *, bits: int = 32, scale=None,
                  weights=None):
    """Bit-serial median centroids; empty clusters keep ``prev``."""
    med, counts = bitserial.grouped_median(x, assign, k, bits=bits,
                                           scale=scale, weights=weights)
    return torch.where(counts.unsqueeze(-1) > 0, med, prev), counts


# ---------------------------------------------------------------------------
# Lloyd driver
# ---------------------------------------------------------------------------


def _one_iter(cfg: ClusterConfig, x, cents, scale, use_kernel=True,
              weights=None):
    assign, mind = assign_points(x, cents, cfg.metric, use_kernel=use_kernel)
    if cfg.centroid == "mean":
        new, counts = update_mean(x, assign, cfg.k, cents, weights=weights)
    else:
        new, counts = update_median(x, assign, cfg.k, cents, bits=cfg.bits,
                                    scale=scale, weights=weights)
    inertia = (mind.sum(-1) if weights is None
               else (mind * weights).sum(-1))
    return new, assign, counts, inertia


def fit(x: torch.Tensor, cfg: ClusterConfig, init_centroids=None, *,
        use_kernel: bool = True, weights=None) -> ClusterResult:
    """Full-batch Lloyd iterations until convergence.

    Optional ``weights`` (..., N) ≥ 0 make this a weighted clustering:
    zero-weight points never influence centroids, counts, inertia or the
    fixed-point scale; integer weights > 1 treat a point as a summary of
    that many originals.  Without ``init_centroids`` the start is drawn by
    ``cfg.init`` from a ``torch.Generator`` seeded with ``cfg.seed``;
    batched inputs need ``init_centroids``.
    """
    if init_centroids is None:
        if x.dim() != 2:
            raise ValueError("a batched fit needs init_centroids")
        gen = torch.Generator().manual_seed(cfg.seed)
        init_centroids = (
            init_kmeanspp(gen, x, cfg.k, cfg.metric, weights=weights)
            if cfg.init == "kmeanspp" else init_random(gen, x, cfg.k))
    # one shared fixed-point scale for the whole run (paper: single 2^f);
    # zero-weight (masked) points must not widen the scale
    x_scale = x if weights is None else x * (weights > 0).unsqueeze(-1).to(
        x.dtype)
    scale = quantizer.auto_scale(x_scale, cfg.bits)

    lead = x.shape[:-2]
    dev = x.device
    cents = init_centroids
    assign = torch.zeros(x.shape[:-1], dtype=torch.int32, device=dev)
    it = torch.zeros(lead, dtype=torch.int32, device=dev)
    moved = torch.full(lead, float("inf"), dtype=torch.float32, device=dev)
    counts = torch.zeros(lead + (cfg.k,), dtype=torch.float32, device=dev)
    inertia = torch.zeros(lead, dtype=torch.float32, device=dev)
    while True:
        run = (it < cfg.max_iters) & (moved > cfg.tol)
        if not bool(run.any()):
            break
        new, new_assign, new_counts, new_inertia = _one_iter(
            cfg, x, cents, scale, use_kernel=use_kernel, weights=weights)
        new_moved = (new - cents).abs().amax((-1, -2))
        # a converged member keeps its state, as under vmap'd while_loop
        cents = torch.where(run[..., None, None], new, cents)
        assign = torch.where(run[..., None], new_assign, assign)
        counts = torch.where(run[..., None], new_counts, counts)
        inertia = torch.where(run, new_inertia, inertia)
        moved = torch.where(run, new_moved, moved)
        it = it + run.to(torch.int32)
    return ClusterResult(cents, assign, inertia, it, counts)
