"""Attention for the decoder-only GQA serving path (port of the 'G' subset
of ``repro.models.attention``): the exact decode cache and the clustered
[median centroids ⊕ exact tail ring] cache of the paper's memory manager.

Cache leaves keep the reference's layouts: exact k/v (B, Sc, Hkv, Dh);
clustered k/v_cents (B, C, Hkv, Dh), counts (B, C, Hkv) f32, k/v_tail
(B, R, Hkv, Dh) in ring order, cov (B,) int32.  Decode writes the new keys
and values into the cache IN PLACE (and returns the cache): an engine step
must not copy every layer's KV.  Paged serving keeps the tails in a
shared block pool (nb, bs, Hkv, Dh) read through block tables.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.kv_compress import ring_positions
from repro_torch.kernels import ops as kops
from repro_torch.kernels.clustered_decode import per_slot
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, cdtype, dense_init,
                                       rms_head_norm)

NEG = -1e30


def _softcap(s, cap: Optional[float]):
    if cap is None:
        return s
    return torch.tanh(s / cap) * cap


def decode_attention(q, k_cache, v_cache, *, t, scale: float,
                     softcap: Optional[float] = None, chunk_len=None):
    """One-token (or chunked mixed-mode) attention over an exact cache
    (position p at index p).

    Decode form — q (B, Hq, Dh), caches (B, Sc, Hkv, Dh); ``t`` = the
    query's position + 1 (entries with position < t participate).  Mixed
    form — q (B, L, Hq, Dh) with per-slot ``chunk_len`` and ``t`` = cache
    length before the chunk: row i sees positions < t + i + 1.  Rows at
    index >= chunk_len are garbage.  Returns like q."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, l, hq, dh = q.shape
    sc, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    dev = q.device
    qh = q.to(torch.float32).reshape(b, l, hkv, g, dh)
    s = torch.einsum("blhgd,bshd->bhlgs", qh,
                     k_cache.to(torch.float32)) * scale
    s = _softcap(s, softcap)
    tb = per_slot(t, b, dev)
    if squeeze:
        qpos1 = tb[:, None]
    else:
        qpos1 = tb[:, None] + torch.arange(l, device=dev)[None, :] + 1
    pos = torch.arange(sc, device=dev)[None, :]
    ok = pos[:, None, :] < qpos1[:, :, None]                 # (B, L, Sc)
    s = torch.where(ok[:, None, :, None, :], s, torch.full_like(s, NEG))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(-1, keepdim=True)
    out = torch.einsum("bhlgs,bshd->blhgd", p / torch.clamp(lsum, min=1e-30),
                       v_cache.to(torch.float32))
    out = out.reshape(b, l, hq, -1).to(q.dtype)
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# GQA attention layer (self-attention)
# ---------------------------------------------------------------------------


def init_attn(generator, cfg: ModelConfig, device=None):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cdtype(cfg)
    p = {
        "wq": dense_init(generator, (d, hq * dh), dtype=dt, device=device),
        "wk": dense_init(generator, (d, hkv * dh), dtype=dt, device=device),
        "wv": dense_init(generator, (d, hkv * dh), dtype=dt, device=device),
        "wo": dense_init(generator, (hq * dh, d), dtype=dt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, device=device)
        p["k_norm"] = torch.ones(dh, device=device)
    return p


def _qkv(p, x, cfg: ModelConfig, positions, kv_repeat: int):
    """Projections, qk-norm and RoPE (global-attention theta)."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, hq, dh)
    k = (x @ p["wk"]).reshape(b, s, hkv, dh)
    v = (x @ p["wv"]).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_repeat > 1:
        k = torch.repeat_interleave(k, kv_repeat, dim=2)
        v = torch.repeat_interleave(v, kv_repeat, dim=2)
    return q, k, v


def _scale(cfg: ModelConfig) -> float:
    return (cfg.query_scale if cfg.query_scale is not None
            else cfg.head_dim ** -0.5)


def init_cache_attn(cfg: ModelConfig, batch: int, max_seq: int,
                    kv_repeat: int = 1, device=None):
    """Exact KV cache of a global-attention layer."""
    dt = cdtype(cfg)
    shape = (batch, max_seq, cfg.n_kv_heads * kv_repeat, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _ring_write_(buf: torch.Tensor, new: torch.Tensor,
                 slot: torch.Tensor) -> None:
    """In place: buf[b, slot[b, i]] = new[b, i] for every in-range slot;
    rows whose slot lies outside [0, Sc) are dropped (the reference's
    ``.at[rows, slot].set(mode="drop")``).

    ``index_put_`` raises on an out-of-range index, and masking rows out
    by boolean indexing would stall on a host sync, so a dropped row
    instead repeats a kept row of its slot (same index, same value, so the
    duplicate write is harmless), or rewrites ring slot 0 with its own
    value when the slot keeps no row."""
    b = new.shape[0]
    sc = buf.shape[1]
    slot = slot.long()
    keep = (slot >= 0) & (slot < sc)                             # (B, L)
    anchor = torch.argmax(keep.to(torch.int32), dim=1)           # first kept
    has = keep.any(1)
    rows = torch.arange(b, device=buf.device)
    a_slot = torch.where(has, slot[rows, anchor], torch.zeros_like(anchor))
    a_val = torch.where(has[:, None, None], new[rows, anchor].to(buf.dtype),
                        buf[rows, 0])
    slot = torch.where(keep, slot, a_slot[:, None])
    val = torch.where(keep[..., None, None], new.to(buf.dtype),
                      a_val[:, None])
    buf[rows[:, None].expand_as(slot), slot] = val


def _cache_write(cache, k_new, v_new, slot):
    """k/v_new (B, L, Hkv, Dh) into the exact cache at ``slot`` (B, L),
    in place; out-of-range slots (masked chunk rows) are dropped."""
    _ring_write_(cache["k"], k_new, slot)
    _ring_write_(cache["v"], v_new, slot)
    return cache["k"], cache["v"]


def init_cache_attn_clustered(cfg: ModelConfig, batch: int, *,
                              n_clusters: int = 512, tail: int = 256,
                              kv_repeat: int = 1, device=None,
                              pool_blocks: int = 0, block_size: int = 0):
    """Clustered KV cache for global-attention layers (the paper's memory
    manager): C median centroids (+ per-centroid counts) stand in for the
    compressed prefix; the most recent ``tail`` keys stay exact in a ring.
    Centroids summarize positions [0, cov); the ring is exact for
    [cov, t).

    With ``pool_blocks``/``block_size`` set (paged serving), the tail
    leaves are a shared block pool ``(pool_blocks, block_size, H, Dh)``:
    ring offset ``r`` of a slot lives at offset ``r % block_size`` of the
    block its block table maps for ring block ``r // block_size``
    (runtime/kv_pool.py).  The pool starts zeroed, never uninitialised:
    unmapped table entries read a real block whose masked entries reach
    P·V as probability 0 times the payload, and 0 × NaN is NaN."""
    dt = cdtype(cfg)
    hkv = cfg.n_kv_heads * kv_repeat
    dh = cfg.head_dim
    z = lambda shape, d=dt: torch.zeros(shape, dtype=d, device=device)  # noqa: E731
    tail_shape = ((pool_blocks, block_size, hkv, dh) if pool_blocks
                  else (batch, tail, hkv, dh))
    return {
        "k_cents": z((batch, n_clusters, hkv, dh)),
        "v_cents": z((batch, n_clusters, hkv, dh)),
        "counts": z((batch, n_clusters, hkv), torch.float32),
        "k_tail": z(tail_shape),
        "v_tail": z(tail_shape),
        "cov": z((batch,), torch.int32),
    }


def attn_decode_clustered(p, x, cfg: ModelConfig, *, cache, t,
                          kv_repeat: int = 1, use_kernel: bool = True,
                          chunk_len=None):
    """Attention over [median centroids ⊕ exact tail ring] — one token per
    slot (decode), or mixed mode with a prompt chunk in flight.

    ``t`` scalar or (B,): each slot's cache length before this step.  With
    ``chunk_len`` (B,) and x (B, L, d), slot rows [0, chunk_len) are the
    consecutive positions t..t+chunk_len-1; their K/V go into the ring
    before scoring, so intra-chunk causality falls out of the ring mask.
    The ring is written in place.  Scores through the fused
    ``clustered_decode`` kernel wrapper, or with ``use_kernel=False``
    through the reference's einsum formulation."""
    b, l = x.shape[0], x.shape[1]
    dev = x.device
    tb = per_slot(t, b, dev)
    chunked = chunk_len is not None
    cl = per_slot(chunk_len, b, dev, fill=1)
    ri = torch.arange(l, device=dev)[None, :]                # (1, L)
    positions = tb[:, None] + ri
    q, k, v = _qkv(p, x, cfg, positions, kv_repeat)
    tail = cache["k_tail"].shape[1]
    # masked chunk rows write out of range (dropped)
    slot = torch.where(ri < cl[:, None], torch.remainder(positions, tail),
                       torch.full_like(positions, tail))
    _ring_write_(cache["k_tail"], k, slot)
    _ring_write_(cache["v_tail"], v, slot)
    k_tail, v_tail = cache["k_tail"], cache["v_tail"]
    cov = cache["cov"]

    hq = cfg.n_heads
    hkv = k_tail.shape[2]
    g = hq // hkv
    scale = _scale(cfg)
    if use_kernel:
        out = kops.clustered_decode(
            q if chunked else q[:, 0], cache["k_cents"], cache["v_cents"],
            cache["counts"], k_tail, v_tail, tb, cov, cl, scale=scale,
            softcap=cfg.attn_logit_softcap)
        out = out.reshape(b, l, hkv, g, cfg.head_dim)
    else:
        f32 = torch.float32
        qh = q.to(f32).reshape(b, l, hkv, g, -1)
        s_c = torch.einsum("blhgd,bchd->bhlgc", qh,
                           cache["k_cents"].to(f32)) * scale
        s_c = _softcap(s_c, cfg.attn_logit_softcap)
        cnt = cache["counts"].permute(0, 2, 1)[:, :, None, None, :]
        s_c = torch.where(cnt > 0, s_c + torch.log(torch.clamp(cnt, min=1e-9)),
                          torch.full_like(s_c, NEG))
        s_t = torch.einsum("blhgd,bshd->bhlgs", qh, k_tail.to(f32)) * scale
        s_t = _softcap(s_t, cfg.attn_logit_softcap)
        pos = ring_positions(tail, tb + cl)                      # (B, R)
        qpos1 = tb[:, None] + ri + 1                             # (B, L)
        ok = ((pos[:, None, :] >= 0)
              & (pos[:, None, :] < qpos1[:, :, None])
              & (pos[:, None, :] >= cov[:, None, None])
              & (ri < cl[:, None])[:, :, None])                  # (B, L, R)
        s_t = torch.where(ok[:, None, :, None, :], s_t,
                          torch.full_like(s_t, NEG))
        s = torch.cat([s_c, s_t], dim=-1)
        m = s.amax(-1, keepdim=True)
        pw = torch.exp(s - m)
        pw = pw / torch.clamp(pw.sum(-1, keepdim=True), min=1e-30)
        nc = cache["k_cents"].shape[1]
        out = (torch.einsum("bhlgc,bchd->blhgd", pw[..., :nc],
                            cache["v_cents"].to(f32))
               + torch.einsum("bhlgs,bshd->blhgd", pw[..., nc:],
                              v_tail.to(f32)))
    y = out.reshape(b, l, hq * cfg.head_dim).to(x.dtype) @ p["wo"]
    return y, cache


def attn_decode_clustered_packed(p, x, cfg: ModelConfig, *, cache,
                                 row_slot, row_pos, row_tw, block_tables,
                                 block_size: int, kv_repeat: int = 1,
                                 row_wlo=None):
    """Paged clustered-KV attention over packed ragged rows.

    x (N, 1, d): one embedding per real (slot, position) pair this step,
    padded to the row bucket.  row_slot (N,) slot; row_pos (N,) absolute
    position (−1: padding row, output garbage by contract); row_tw (N,)
    the slot's ring watermark t + chunk_len (all of a chunk's rows are
    written before any row scores, so intra-chunk causality falls out of
    the per-row position mask as in the dense mixed launch); block_tables
    (B, T) global block ids, every entry valid, with every block written
    this step owned by its slot alone (``kv_pool.ensure``).

    Each row's K/V go into its slot's pool block at the ring offset the
    dense path uses (in place; padding rows drop), so the pool holds the
    dense ring's live bytes and the outputs equal the dense engine's."""
    n = x.shape[0]
    positions = row_pos[:, None]                          # (N, 1)
    q, k, v = _qkv(p, x, cfg, positions, kv_repeat)
    t_blocks = block_tables.shape[1]
    nb = cache["k_tail"].shape[0]
    rs = row_slot.long()
    row_bt = block_tables[rs]                             # (N, T)
    roff = torch.remainder(row_pos, t_blocks * block_size).long()
    blk = torch.gather(row_bt, 1, (roff // block_size)[:, None])[:, 0]
    # flat pool index blk * bs + off of each row's ring offset; padding
    # rows point past the pool and drop
    flat = torch.where(row_pos >= 0, blk * block_size + roff % block_size,
                       nb * block_size)
    for key, new in (("k_tail", k), ("v_tail", v)):
        pool = cache[key]
        _ring_write_(pool.view(1, nb * block_size, *pool.shape[2:]),
                     new[:, 0][None], flat[None])

    valid = row_pos >= 0
    qpos1 = torch.where(valid, row_pos + 1, torch.zeros_like(row_pos))
    row_cov = cache["cov"][rs]
    if row_wlo is None:
        # no retention window: the cov frontier is the only lower bound
        row_wlo = torch.zeros_like(qpos1)
    out = kops.paged_clustered_decode(
        q[:, 0], cache["k_cents"], cache["v_cents"], cache["counts"],
        cache["k_tail"], cache["v_tail"], row_slot, row_bt, qpos1, row_tw,
        row_cov, row_wlo, scale=_scale(cfg),
        softcap=cfg.attn_logit_softcap)
    y = out.reshape(n, 1, cfg.n_heads * cfg.head_dim).to(x.dtype) @ p["wo"]
    return y, cache


def attn_decode(p, x, cfg: ModelConfig, *, layer_kind: str, cache, t,
                kv_repeat: int = 1, chunk_len=None):
    """x (B, 1, d) decode, or (B, L, d) mixed mode with per-slot
    ``chunk_len`` valid rows; ``t`` scalar or (B,): the slot's cache
    length before this step.  The cache is written in place."""
    if "k_cents" in cache:
        return attn_decode_clustered(p, x, cfg, cache=cache, t=t,
                                     kv_repeat=kv_repeat,
                                     chunk_len=chunk_len)
    if layer_kind != "G":
        raise NotImplementedError(
            f"layer kind {layer_kind!r}: only global attention ('G') is "
            "ported (ROADMAP Queue A item 9)")
    b, l = x.shape[0], x.shape[1]
    dev = x.device
    tb = per_slot(t, b, dev)
    chunked = chunk_len is not None
    cl = per_slot(chunk_len, b, dev, fill=1)
    ri = torch.arange(l, device=dev)[None, :]
    positions = tb[:, None] + ri                          # (B, L)
    q, k, v = _qkv(p, x, cfg, positions, kv_repeat)
    sc = cache["k"].shape[1]
    slot = torch.clamp(positions, max=sc - 1)
    slot = torch.where(ri < cl[:, None], slot, torch.full_like(slot, sc))
    _cache_write(cache, k, v, slot)
    if chunked:
        out = decode_attention(q, cache["k"], cache["v"], t=tb, chunk_len=cl,
                               scale=_scale(cfg),
                               softcap=cfg.attn_logit_softcap)
    else:
        out = decode_attention(q[:, 0], cache["k"], cache["v"], t=tb + 1,
                               scale=_scale(cfg),
                               softcap=cfg.attn_logit_softcap)
    y = out.reshape(b, l, -1) @ p["wo"]
    return y, cache
