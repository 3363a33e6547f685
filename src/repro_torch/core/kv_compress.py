"""KV-cache memory management via bit-serial k-medians clustering (port of
the serving subset of ``repro.core.kv_compress``).

A slot's KV is kept as C key centroids per head (bit-serial medians of the
keys, weighted by how many keys each stands for), the mean value of each
cluster, per-centroid counts, and an exact tail ring of the most recent
keys.  Centroids summarize positions [0, cov); the ring is exact for
[cov, t).

Cache-layout leaves: k/v_cents (B, C, H, Dh), counts (B, C, H), k/v_tail
(B, R, H, Dh) in ring order (position p at slot p % R), cov (B,) int32.
The (slot, head) members are batch dimensions of one k-medians fit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import clustering
from repro_torch.core.clustering import ClusterConfig


@dataclasses.dataclass(frozen=True)
class KVCompressConfig:
    n_clusters: int = 256
    iters: int = 6
    metric: str = "l2"        # assignment metric for keys
    bits: int = 16            # fixed-point width for median centroids
    keep_recent: int = 128    # exact tail (recency window kept uncompressed)
    refresh_every: int = 0    # serving: decode steps between compactions,
                              # effectively clamped to keep_recent
    prompt_clusters: int = 0  # chunked admission: centroid budget while a
                              # prompt streams in (0 = n_clusters)

    @property
    def refresh(self) -> int:
        return min(self.refresh_every, self.keep_recent)

    @property
    def prompt_budget(self) -> int:
        return self.prompt_clusters or self.n_clusters


def coverage_frontier(pos: int, cfg: KVCompressConfig) -> int:
    """Loss-free coverage frontier for a stream at absolute length ``pos``:
    positions below it are absorbed into centroids, the ring keeps
    [frontier, pos) with ``refresh`` steps of headroom."""
    pos = int(pos)
    return max(0, min(pos, pos - cfg.keep_recent + cfg.refresh))


def ring_positions(r: int, t) -> torch.Tensor:
    """Absolute position held by each of the r ring slots at time t (next
    write goes to slot t % r).  t scalar or (B,) → (..., r).  The mod is a
    floor mod (``torch.remainder``), as ``jnp.mod`` is."""
    t = torch.as_tensor(t)
    s = torch.arange(r, device=t.device)
    tb = t[..., None]
    wrapped = tb - r + torch.remainder(s - tb, r)
    return torch.where(tb <= r, torch.broadcast_to(s, wrapped.shape), wrapped)


def compress_head(keys, values, cfg: KVCompressConfig, seed: int = 0,
                  weights=None, init_centroids=None):
    """keys/values (..., S, Dh) → (k_cents, v_cents, counts) per member.

    ``weights`` (..., S) ≥ 0 mask padded positions (weight 0) or carry the
    counts of pre-aggregated summaries; ``init_centroids`` warm-starts
    Lloyd for incremental re-compaction."""
    ccfg = ClusterConfig(k=cfg.n_clusters, metric=cfg.metric,
                         centroid="median", max_iters=cfg.iters,
                         bits=cfg.bits, init="kmeanspp", seed=seed)
    res = clustering.fit(keys.to(torch.float32), ccfg, init_centroids,
                         use_kernel=False, weights=weights)
    onehot = torch.nn.functional.one_hot(res.assign.long(),
                                         cfg.n_clusters).to(torch.float32)
    if weights is not None:
        onehot = onehot * weights.to(torch.float32).unsqueeze(-1)
    vsum = torch.matmul(onehot.transpose(-1, -2), values.to(torch.float32))
    counts = onehot.sum(-2)
    v_cents = vsum / torch.clamp(counts, min=1.0).unsqueeze(-1)
    return res.centroids, v_cents, counts


def _members(cache):
    """Clustered leaves as f32 (slot, head)-major members:
    (B, H, C|R, Dh) and counts (B, H, C)."""
    f32 = torch.float32
    return (cache["k_cents"].to(f32).permute(0, 2, 1, 3),
            cache["v_cents"].to(f32).permute(0, 2, 1, 3),
            cache["counts"].permute(0, 2, 1),
            cache["k_tail"].to(f32).permute(0, 2, 1, 3),
            cache["v_tail"].to(f32).permute(0, 2, 1, 3))


def _merge(cache, changed, nk, nv, ncnt, new_cov):
    """Write the new banks of slots whose frontier advanced back into the
    cache layout (contiguous (B, C, H, Dh) leaves); the other slots keep
    theirs bit-identical."""
    changed = changed[:, None, None]

    def pick(new, key):
        old = cache[key]
        out = torch.where(changed[..., None] if new.dim() == 4 else changed,
                          new, old.to(new.dtype))
        return out.to(old.dtype).contiguous()

    return dict(cache,
                k_cents=pick(nk.permute(0, 2, 1, 3), "k_cents"),
                v_cents=pick(nv.permute(0, 2, 1, 3), "v_cents"),
                counts=pick(ncnt.permute(0, 2, 1), "counts"),
                cov=new_cov.to(torch.int32))


def recompact_clustered(cache, lengths, cfg: KVCompressConfig):
    """Incremental re-compaction of an already-clustered cache.

    The points to recluster are the old centroids (weighted by their
    counts) plus the ring entries aged past the new coverage frontier,
    warm-started from the old centroids.  Slots whose frontier does not
    advance (``new_cov == cov``) keep their centroid bank BIT-IDENTICAL, so
    a compaction triggered by one slot never perturbs another.  Returns a
    new cache dict (the input is not modified)."""
    kc, vc, cnt, kt, vt = _members(cache)
    cov = cache["cov"]
    r = cache["k_tail"].shape[1]
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=cov.device)
    # the frontier is monotone even for drained slots (length 0)
    new_cov = torch.maximum(cov, torch.minimum(
        torch.clamp(lengths - r + cfg.refresh, min=0), lengths))
    ring_pos = ring_positions(r, lengths)                    # (B, R)
    w_tail = ((ring_pos >= cov[:, None])
              & (ring_pos < new_cov[:, None])).to(torch.float32)
    h = kc.shape[1]
    x = torch.cat([kc, kt], dim=2)                           # (B, H, C+R, Dh)
    vals = torch.cat([vc, vt], dim=2)
    wgt = torch.cat([cnt, w_tail[:, None, :].expand(-1, h, -1)], dim=2)
    nk, nv, ncnt = compress_head(x, vals, cfg, weights=wgt, init_centroids=kc)
    return _merge(cache, new_cov > cov, nk, nv, ncnt, new_cov)


def absorb_chunk(cache, lengths, target_cov, cfg: KVCompressConfig):
    """Streaming admission-time compaction: advance each slot's coverage
    frontier to ``target_cov`` by folding the ring entries aged past it
    into centroids, so a prompt longer than the ring is admitted chunk by
    chunk.

    Only the first ``cfg.prompt_budget`` centroid rows are written; all
    rows still take part as weighted points, so mass outside the budget
    migrates in and is never dropped (total counts == new_cov per head).
    Dead rows are re-seeded by farthest-point selection before the
    warm-started weighted k-medians.  Slots with target_cov <= cov keep
    their rows bit-identical.  Returns a new cache dict."""
    budget = cfg.prompt_budget
    kc, vc, cnt, kt, vt = _members(cache)
    cov = cache["cov"]
    b, h, c, _ = kc.shape
    r = cache["k_tail"].shape[1]
    dev = cov.device
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    target = torch.as_tensor(target_cov, dtype=torch.int32, device=dev)
    new_cov = torch.minimum(torch.clamp(torch.maximum(cov, target), min=0),
                            lengths)
    ring_pos = ring_positions(r, lengths)                    # (B, R)
    w_tail = ((ring_pos >= cov[:, None])
              & (ring_pos < new_cov[:, None])).to(torch.float32)
    bcfg = dataclasses.replace(cfg, n_clusters=budget)
    x = torch.cat([kc, kt], dim=2)                           # (B, H, C+R, Dh)
    vals = torch.cat([vc, vt], dim=2)
    wgt = torch.cat([cnt, w_tail[:, None, :].expand(-1, h, -1)], dim=2)
    # fresh gates the seeding pool so unchanged slots can't be perturbed
    # even by reseeding a zero-count row onto a live point
    fresh = (new_cov > cov).to(torch.float32)[:, None, None]
    init = clustering.seed_empty_centroids(
        x, kc[:, :, :budget], cnt[:, :, :budget] > 0, cfg.metric,
        weights=wgt * fresh)
    nk, nv, ncnt = compress_head(x, vals, bcfg, weights=wgt,
                                 init_centroids=init)
    nk = torch.cat([nk, kc[:, :, budget:]], dim=2)
    nv = torch.cat([nv, vc[:, :, budget:]], dim=2)
    ncnt = torch.cat([ncnt, torch.zeros((b, h, c - budget),
                                        dtype=ncnt.dtype, device=dev)], dim=2)
    return _merge(cache, new_cov > cov, nk, nv, ncnt, new_cov)
