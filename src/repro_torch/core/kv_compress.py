"""KV-cache memory management via bit-serial k-medians clustering (port of
``repro.core.kv_compress``).

A slot's KV is kept as C key centroids per head (bit-serial medians of the
keys, weighted by how many keys each stands for), the mean value of each
cluster, per-centroid counts, and an exact tail ring of the most recent
keys.  Centroids summarize positions [0, cov); the ring is exact for
[cov, t).

Cache-layout leaves: k/v_cents (B, C, H, Dh), counts (B, C, H), k/v_tail
(B, R, H, Dh) in ring order (position p at slot p % R), cov (B,) int32.
The (slot, head) members are batch dimensions of one k-medians fit.

``group=`` (the reference's ``axis_name=``): when a member's points span
the ranks of a process group, each rank passes its shard, and the weighted
k-medians sums its votes, value sums and counts across the group, so every
rank ends with the same centroids.  Mesh serving partitions slots and
heads, so no member spans ranks there and absorb and compaction stay
rank-local.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import bitserial, clustering
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


class CompressedKV(NamedTuple):
    k_cents: torch.Tensor     # (H, C, Dh) key centroids (bit-serial medians)
    v_cents: torch.Tensor     # (H, C, Dh) mean value per cluster
    counts: torch.Tensor      # (H, C)
    k_tail: torch.Tensor      # (H, R, Dh) exact recent keys
    v_tail: torch.Tensor      # (H, R, Dh)


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
                  weights=None, init_centroids=None, group=None):
    """keys/values (..., S, Dh) → (k_cents, v_cents, counts) per member.

    ``weights`` (..., S) ≥ 0 mask padded positions (weight 0) or carry the
    counts of pre-aggregated summaries; ``init_centroids`` warm-starts
    Lloyd for incremental re-compaction.  With ``group`` the S points are
    this rank's shard (``init_centroids`` required, the same on every
    rank) and the fit, the value sums and the counts are summed across
    the group."""
    ccfg = ClusterConfig(k=cfg.n_clusters, metric=cfg.metric,
                         centroid="median", max_iters=cfg.iters,
                         bits=cfg.bits, init="kmeanspp", seed=seed)
    res = clustering.fit(keys.to(torch.float32), ccfg, init_centroids,
                         use_kernel=False, weights=weights, group=group)
    onehot = torch.nn.functional.one_hot(res.assign.long(),
                                         cfg.n_clusters).to(torch.float32)
    if weights is not None:
        onehot = onehot * weights.to(torch.float32).unsqueeze(-1)
    vsum = bitserial.psum(
        torch.matmul(onehot.transpose(-1, -2), values.to(torch.float32)),
        group)
    counts = bitserial.psum(onehot.sum(-2), group)
    v_cents = vsum / torch.clamp(counts, min=1.0).unsqueeze(-1)
    return res.centroids, v_cents, counts


def compress_cache(k_cache, v_cache, cfg: KVCompressConfig) -> CompressedKV:
    """k/v (S, H, Dh) → CompressedKV.  The most recent ``keep_recent``
    positions stay exact; the older ones are clustered per head (the heads
    are members of one fit)."""
    s = k_cache.shape[0]
    r = min(cfg.keep_recent, s)
    head = s - r
    k_cents, v_cents, counts = compress_head(
        k_cache[:head].permute(1, 0, 2), v_cache[:head].permute(1, 0, 2), cfg)
    return CompressedKV(k_cents=k_cents, v_cents=v_cents, counts=counts,
                        k_tail=k_cache[head:].permute(1, 0, 2),
                        v_tail=v_cache[head:].permute(1, 0, 2))


def _tail_ring_slice(kb, vb, lb, r: int):
    """Last r positions of a slot's chronological cache, laid out in ring
    order (position p at slot p % r).  kb/vb (..., S, H, Dh), lb the valid
    length: a scalar, or (...,) for a batch of slots."""
    lb = torch.as_tensor(lb, device=kb.device)
    start = torch.clamp(lb - r, min=0)[..., None]
    s = torch.arange(r, device=kb.device)
    src = start + torch.remainder(s - start, r)             # (..., r)
    idx = src.long()[..., None, None].expand(src.shape + kb.shape[-2:])
    return torch.gather(kb, -3, idx), torch.gather(vb, -3, idx)


def compress_cache_batched(k, v, lengths, cfg: KVCompressConfig):
    """Exact slot caches → clustered layout in one batched fit.

    k/v (B, S, H, Dh) chronological slot buffers, lengths (B,) valid
    counts.  Every (slot, head) is a member of one k-medians fit started
    by k-means++ from seed 0, as the reference's vmap over batch ⊕ head
    starts each; positions at or past a slot's frontier (its tail, and
    padding) carry weight 0."""
    b, s, h, _ = k.shape
    r = min(cfg.keep_recent, s)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=k.device)
    cov = torch.minimum(torch.clamp(lengths - r + cfg.refresh, min=0),
                        lengths)
    pos = torch.arange(s, device=k.device)
    w = (pos[None, :] < cov[:, None]).to(torch.float32)      # (B, S)
    f32 = torch.float32
    k_cents, v_cents, counts = compress_head(
        k.to(f32).permute(0, 2, 1, 3), v.to(f32).permute(0, 2, 1, 3), cfg,
        weights=w[:, None, :].expand(b, h, s))
    k_tail, v_tail = _tail_ring_slice(k, v, lengths, r)
    return {
        "k_cents": k_cents.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
        "v_cents": v_cents.permute(0, 2, 1, 3).to(v.dtype).contiguous(),
        "counts": counts.permute(0, 2, 1).contiguous(),      # (B, C, H)
        "k_tail": k_tail.to(k.dtype),
        "v_tail": v_tail.to(v.dtype),
        "cov": cov.to(torch.int32),
    }


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


def recompact_clustered(cache, lengths, cfg: KVCompressConfig, group=None):
    """Incremental re-compaction of an already-clustered cache.

    The points to recluster are the old centroids (weighted by their
    counts) plus the ring entries aged past the new coverage frontier,
    warm-started from the old centroids.  Slots whose frontier does not
    advance (``new_cov == cov``) keep their centroid bank BIT-IDENTICAL, so
    a compaction triggered by one slot never perturbs another.  Returns a
    new cache dict (the input is not modified).  ``group``: the members'
    C + R points are sharded across its ranks (``compress_head``)."""
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
    nk, nv, ncnt = compress_head(x, vals, cfg, weights=wgt, init_centroids=kc,
                                 group=group)
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


def clustered_attention(q, ckv: CompressedKV, *, scale: float):
    """q (H, Dh) → out (H, Dh) by attention over [centroids ⊕ exact tail]:
    centroid c with m keys gets a +log(m) logit bias (it stands for m
    keys of the same score); empty centroids are masked."""
    f32 = torch.float32
    qf = q.to(f32)
    s_c = torch.einsum("hd,hcd->hc", qf, ckv.k_cents.to(f32))
    s_c = s_c * scale + torch.log(torch.clamp(ckv.counts, min=1e-9))
    s_c = torch.where(ckv.counts > 0, s_c, torch.full_like(s_c, -1e30))
    s_t = torch.einsum("hd,hrd->hr", qf, ckv.k_tail.to(f32)) * scale
    s = torch.cat([s_c, s_t], dim=1)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    v_all = torch.cat([ckv.v_cents.to(f32), ckv.v_tail.to(f32)], dim=1)
    return torch.einsum("hc,hcd->hd", p, v_all).to(q.dtype)


def exact_attention(q, k_cache, v_cache, *, scale: float):
    """Oracle for quality evaluation: q (H, Dh), caches (S, H, Dh)."""
    qf = q.to(torch.float32)
    s = torch.einsum("hd,shd->hs", qf, k_cache.to(torch.float32)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hs,shd->hd", p,
                        v_cache.to(torch.float32)).to(q.dtype)


def memory_ratio(s: int, cfg: KVCompressConfig) -> float:
    return s / float(cfg.n_clusters + cfg.keep_recent)
