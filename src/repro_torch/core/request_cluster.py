"""Request processing: clustering-based batch formation for serving (port
of ``repro.core.request_cluster``).

Queued requests are clustered by (prompt_len, expected_new_tokens) with the
paper's bit-serial k-medians and batched within clusters, minimizing
padded-token waste.  A small queue is simply sorted by length.  Large
queues run a k-means++ ``fit`` whose draws come from the port of
``jax.random``'s threefry (``core.prng``), so they start where the
reference's start for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import clustering
from repro_torch.core.clustering import ClusterConfig


@dataclasses.dataclass(frozen=True)
class Request:
    uid: int
    prompt_len: int
    max_new_tokens: int
    priority: int = 0          # SLO class (runtime/scheduler.py)
    deadline_ms: float = 0.0   # soft TTFT deadline (0 = none)


class BatchPlan(NamedTuple):
    batches: List[List[int]]      # request uids per batch
    waste: float                  # padded-token fraction


def features(reqs: Sequence[Request]) -> np.ndarray:
    return np.array([[r.prompt_len, r.max_new_tokens] for r in reqs],
                    np.float32)


def plan_batches(reqs: Sequence[Request], batch_size: int,
                 n_clusters: int = 4, seed: int = 0) -> BatchPlan:
    """Cluster by (len, gen) with bit-serial k-medians, then fill batches
    cluster by cluster in sorted-length order.  Mixed priority classes are
    planned independently, highest first."""
    if not reqs:
        return BatchPlan([], 0.0)
    prios = sorted({r.priority for r in reqs}, reverse=True)
    if len(prios) > 1:
        by_uid = {r.uid: r for r in reqs}
        batches: List[List[int]] = []
        for p in prios:
            sub = [r for r in reqs if r.priority == p]
            batches.extend(plan_batches(sub, batch_size, n_clusters,
                                        seed).batches)
        waste = padding_waste([[by_uid[u] for u in b] for b in batches])
        return BatchPlan(batches, waste)
    x = features(reqs)
    if len(reqs) < max(4 * batch_size, n_clusters * batch_size):
        # small queue: a global length sort is optimal
        order = np.argsort(x[:, 0], kind="stable").tolist()
        batches = [order[i:i + batch_size]
                   for i in range(0, len(order), batch_size)]
        waste = padding_waste([[reqs[i] for i in b] for b in batches])
        return BatchPlan([[reqs[i].uid for i in b] for b in batches], waste)
    k = min(n_clusters, len(reqs))
    cfg = ClusterConfig(k=k, metric="l1", centroid="median", max_iters=10,
                        bits=16, seed=seed)
    res = clustering.fit(torch.from_numpy(x), cfg, use_kernel=False)
    assign = res.assign.numpy()

    # inside a cluster sort by length; order clusters by median prompt length
    clusters = []
    for c in range(k):
        idx = np.where(assign == c)[0]
        if len(idx) == 0:
            continue
        clusters.append(idx[np.argsort(x[idx, 0], kind="stable")])
    clusters.sort(key=lambda idx: float(np.median(x[idx, 0])))

    # full batches within each cluster; remainders merged in length order
    batches: List[List[int]] = []
    leftover: List[int] = []
    for idx in clusters:
        n_full = (len(idx) // batch_size) * batch_size
        batches.extend(idx[i:i + batch_size].tolist()
                       for i in range(0, n_full, batch_size))
        leftover.extend(idx[n_full:].tolist())
    leftover.sort(key=lambda i: (x[i, 0], i))
    batches.extend(leftover[i:i + batch_size]
                   for i in range(0, len(leftover), batch_size))
    waste = padding_waste([[reqs[i] for i in b] for b in batches])
    return BatchPlan([[reqs[i].uid for i in b] for b in batches], waste)


def plan_fifo(reqs: Sequence[Request], batch_size: int) -> BatchPlan:
    batches = [list(range(len(reqs)))[i:i + batch_size]
               for i in range(0, len(reqs), batch_size)]
    waste = padding_waste([[reqs[i] for i in b] for b in batches])
    return BatchPlan([[reqs[i].uid for i in b] for b in batches], waste)


def padding_waste(batches: List[List[Request]]) -> float:
    """Fraction of padded prompt tokens across all batches."""
    padded, useful = 0, 0
    for b in batches:
        if not b:
            continue
        mx = max(r.prompt_len for r in b)
        for r in b:
            useful += r.prompt_len
            padded += mx - r.prompt_len
    return padded / max(padded + useful, 1)
