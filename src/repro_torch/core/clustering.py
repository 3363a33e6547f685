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

Random starts draw from ``core.prng``, a bit-exact port of ``jax.random``'s
threefry, so a fit without ``init_centroids`` picks the reference's points
for the same seed (k-means++ probabilities are computed by the port, so a
last-ulp difference at a cumsum boundary could pick another point; ROADMAP
Queue C).  The quality metrics (simplified silhouette, the optimal-k sweep,
recognition rate) and the mini-batch fit follow the reference.

Under ``group=`` (a ``torch.distributed`` process group, where the
reference takes ``axis_name=`` under ``shard_map``) x is this rank's shard
of the points: centroid sums, counts, median votes and inertia are summed
across the group and the scale is its minimum, so every rank converges on
the same centroids.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import bitserial, prng, quantizer


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


def _take(x: torch.Tensor, idx) -> torch.Tensor:
    """Row ``idx`` of every member: x (..., n, D), idx an int or (...,)
    → (..., D)."""
    lead, d = x.shape[:-2], x.shape[-1]
    idx = torch.as_tensor(idx, device=x.device).long().expand(lead)
    return torch.gather(x, -2, idx[..., None, None].expand(lead + (1, d))
                        )[..., 0, :]


def init_random(rng: torch.Tensor, x: torch.Tensor, k: int):
    """k distinct points drawn by the ``prng`` key ``rng``; x (..., n, D),
    every member taking the same indices (a vmap over one key)."""
    idx = prng.choice(rng, x.shape[-2], (k,), replace=False)
    return x[..., idx.to(x.device).long(), :]


def init_kmeanspp(rng: torch.Tensor, x: torch.Tensor, k: int,
                  metric: str = "l2", weights=None):
    """k-means++ (D^2 sampling; D^1 for L1/k-medians) drawn by the
    ``prng`` key ``rng``.  Optional point ``weights`` scale the sampling
    probabilities — zero-weight points are never chosen as seeds.

    x (..., n, D), weights (..., n): leading axes are members drawn with
    the one key, as the reference's fit is when vmapped over members (its
    batched compaction calls every member with seed 0).  Picks stay on
    the device: no host sync per draw."""
    n, d = x.shape[-2:]
    r0, key = prng.split(rng)

    def probs_of(w):
        wsum = w.sum(-1, keepdim=True)
        return torch.where(wsum > 0, w / torch.clamp(wsum, min=1e-30),
                           torch.full_like(w, 1.0 / n))

    if weights is None:
        first = _take(x, prng.randint(r0, (), 0, n))
    else:
        first = _take(x, prng.choice(r0, n, p=probs_of(weights)))
    cents = torch.zeros(x.shape[:-2] + (k, d), dtype=x.dtype, device=x.device)
    cents[..., 0, :] = first
    mind = pairwise_dist(x, first[..., None, :], metric)[..., 0]
    for i in range(1, k):
        key, sub = prng.split(key)
        w = mind if metric == "l2" else torch.clamp(mind, min=0.0)
        if weights is not None:
            w = w * weights
        c = _take(x, prng.choice(sub, n, p=probs_of(w)))
        cents[..., i, :] = c
        mind = torch.minimum(mind,
                             pairwise_dist(x, c[..., None, :], metric)[..., 0])
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


def update_mean(x, assign, k: int, prev, *, weights=None, group=None):
    """Weighted mean centroids; empty clusters keep ``prev``.  With
    ``group`` the per-cluster sums and counts are summed across its ranks,
    the reduction tree of the median's votes."""
    onehot = _onehot(assign, k, weights)
    sums = bitserial.psum(torch.matmul(onehot.transpose(-1, -2), x), group)
    counts = bitserial.psum(onehot.sum(-2), group)
    mean = sums / torch.clamp(counts, min=1.0).unsqueeze(-1)
    return torch.where(counts.unsqueeze(-1) > 0, mean, prev), counts


def update_median(x, assign, k: int, prev, *, bits: int = 32, scale=None,
                  weights=None, group=None):
    """Bit-serial median centroids; empty clusters keep ``prev``.  With
    ``group`` the votes are summed across its ranks bit by bit."""
    med, counts = bitserial.grouped_median(x, assign, k, bits=bits,
                                           scale=scale, weights=weights,
                                           group=group)
    return torch.where(counts.unsqueeze(-1) > 0, med, prev), counts


# ---------------------------------------------------------------------------
# Lloyd driver
# ---------------------------------------------------------------------------


def _one_iter(cfg: ClusterConfig, x, cents, scale, use_kernel=True,
              weights=None, group=None):
    assign, mind = assign_points(x, cents, cfg.metric, use_kernel=use_kernel)
    if cfg.centroid == "mean":
        new, counts = update_mean(x, assign, cfg.k, cents, weights=weights,
                                  group=group)
    else:
        new, counts = update_median(x, assign, cfg.k, cents, bits=cfg.bits,
                                    scale=scale, weights=weights,
                                    group=group)
    inertia = (mind.sum(-1) if weights is None
               else (mind * weights).sum(-1))
    return new, assign, counts, bitserial.psum(inertia, group)


def fit(x: torch.Tensor, cfg: ClusterConfig, init_centroids=None, *,
        use_kernel: bool = True, weights=None, group=None) -> ClusterResult:
    """Full-batch Lloyd iterations until convergence.

    Optional ``weights`` (..., N) ≥ 0 make this a weighted clustering:
    zero-weight points never influence centroids, counts, inertia or the
    fixed-point scale; integer weights > 1 treat a point as a summary of
    that many originals.  Without ``init_centroids`` the start is drawn by
    ``cfg.init`` from ``prng.PRNGKey(cfg.seed)``, as the reference draws it
    — for batched inputs (..., N, D) with that one key for every member, as
    the reference's vmapped fits do.

    With ``group`` (a process group) x is this rank's shard of the points
    and ``init_centroids`` must be given, the same on every rank: the
    scale is the group's smallest, the centroid updates and the inertia
    are summed across it, and the loop makes the reference's fixed trip of
    ``max_iters`` that freezes a converged member, so that every rank runs
    the same collectives.  ``assign`` is this rank's points'.
    """
    if init_centroids is None:
        if group is not None:
            raise ValueError("distributed fit requires init_centroids")
        rng = prng.PRNGKey(cfg.seed)
        init_centroids = (
            init_kmeanspp(rng, x, cfg.k, cfg.metric, weights=weights)
            if cfg.init == "kmeanspp" else init_random(rng, x, cfg.k))
    # one shared fixed-point scale for the whole run (paper: single 2^f);
    # zero-weight (masked) points must not widen the scale
    x_scale = x if weights is None else x * (weights > 0).unsqueeze(-1).to(
        x.dtype)
    # global per-feature scale: the smallest, so the largest |x| fits
    scale = bitserial.pmin(quantizer.auto_scale(x_scale, cfg.bits), group)

    lead = x.shape[:-2]
    dev = x.device
    cents = init_centroids
    assign = torch.zeros(x.shape[:-1], dtype=torch.int32, device=dev)
    it = torch.zeros(lead, dtype=torch.int32, device=dev)
    moved = torch.full(lead, float("inf"), dtype=torch.float32, device=dev)
    counts = torch.zeros(lead + (cfg.k,), dtype=torch.float32, device=dev)
    inertia = torch.zeros(lead, dtype=torch.float32, device=dev)
    trip = 0
    while True:
        run = (it < cfg.max_iters) & (moved > cfg.tol)
        if (trip >= cfg.max_iters if group is not None
                else not bool(run.any())):
            break
        trip += 1
        new, new_assign, new_counts, new_inertia = _one_iter(
            cfg, x, cents, scale, use_kernel=use_kernel, weights=weights,
            group=group)
        new_moved = (new - cents).abs().amax((-1, -2))
        # a converged member keeps its state, as under vmap'd while_loop
        cents = torch.where(run[..., None, None], new, cents)
        assign = torch.where(run[..., None], new_assign, assign)
        counts = torch.where(run[..., None], new_counts, counts)
        inertia = torch.where(run, new_inertia, inertia)
        moved = torch.where(run, new_moved, moved)
        it = it + run.to(torch.int32)
    return ClusterResult(cents, assign, inertia, it, counts)


def fit_minibatch(rng: torch.Tensor, x: torch.Tensor, cfg: ClusterConfig,
                  batch_size: int, n_steps: int,
                  init_centroids=None) -> ClusterResult:
    """Mini-batch variant: per step sample a batch, assign, and blend the
    batch centroid (mean or bit-serial median) into the running centroid
    with a per-cluster learning rate 1/visit-count (Sculley-style)."""
    if init_centroids is None:
        r0, rng = prng.split(rng)
        init_centroids = init_kmeanspp(r0, x, cfg.k, cfg.metric)
    scale = quantizer.auto_scale(x, cfg.bits)
    cents = init_centroids
    visits = torch.zeros((cfg.k,), dtype=torch.float32, device=x.device)
    for key in prng.split(rng, n_steps):
        idx = prng.randint(key, (batch_size,), 0, x.shape[0])
        xb = x[idx.to(x.device).long()]
        assign, _ = assign_points(xb, cents, cfg.metric)
        if cfg.centroid == "mean":
            batch_c, counts = update_mean(xb, assign, cfg.k, cents)
        else:
            batch_c, counts = update_median(xb, assign, cfg.k, cents,
                                            bits=cfg.bits, scale=scale)
        visits = visits + counts
        lr = torch.where(counts > 0, counts / torch.clamp(visits, min=1.0),
                         torch.zeros_like(counts))
        cents = cents + lr[:, None] * (batch_c - cents)
    assign, mind = assign_points(x, cents, cfg.metric)
    return ClusterResult(cents, assign, mind.sum(),
                         torch.tensor(n_steps, dtype=torch.int32), visits)


# ---------------------------------------------------------------------------
# Quality metrics / model selection (paper §4, Table 3)
# ---------------------------------------------------------------------------


def simplified_silhouette(x, cents, assign):
    """Simplified silhouette (centroid-based): mean of (b - a) / max(a, b),
    a the squared L2 distance to the own centroid, b to the nearest other
    one — the 'avgBMP' score the paper's optimal-k loop averages."""
    dist = pairwise_dist(x, cents, "l2")
    own = assign.long()[:, None]
    a = torch.gather(dist, 1, own)[:, 0]
    b = dist.scatter(1, own, float("inf")).amin(1)
    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30)
    return s.mean()


def select_k(x, kmin: int, kmax: int, cfg: ClusterConfig):
    """Paper §4: sweep k in [kmin, kmax], fit each, score avgBMP(k); return
    (k_opt, scores), k_opt the first k of the highest score."""
    scores = []
    for k in range(kmin, kmax + 1):
        res = fit(x, dataclasses.replace(cfg, k=k))
        scores.append(float(simplified_silhouette(x, res.centroids,
                                                  res.assign)))
    return kmin + scores.index(max(scores)), scores


def recognition_rate(assign, labels, k: int, n_classes: int):
    """Paper Table 3 protocol: each cluster adopts its majority true label;
    the fraction of points whose cluster's label is their own."""
    assign, labels = assign.long(), labels.long()
    conf = torch.zeros((k, n_classes), dtype=torch.float32,
                       device=assign.device)
    conf.index_put_((assign, labels), torch.ones_like(assign,
                                                      dtype=torch.float32),
                    accumulate=True)
    pred = torch.argmax(conf, 1)[assign]
    return (pred == labels).to(torch.float32).mean()
