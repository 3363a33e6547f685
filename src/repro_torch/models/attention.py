"""Attention for serving (port of the serving subset of
``repro.models.attention``): chunked online-softmax prefill, the exact
decode cache (optionally int8 with per-head scales), the sliding-window
ring of 'L' layers, the clustered [median centroids ⊕ exact tail ring]
cache of the paper's memory manager, the encoder-decoder's
cross-attention, and MLA (DeepSeek-V3), which caches only its compressed
latent (ckv, kpe) and decodes in the absorbed form.

Cache leaves keep the reference's layouts: exact k/v (B, Sc, Hkv, Dh)
(int8: plus k/v_scale (Hkv,) f32), where an 'L' layer's Sc is
min(max_seq, window) and position p sits at ring slot p % Sc;
clustered k/v_cents (B, C, Hkv, Dh), counts (B, C, Hkv) f32, k/v_tail
(B, R, Hkv, Dh) in ring order, cov (B,) int32.  Decode writes the new keys
and values into the cache IN PLACE (and returns the cache): an engine step
must not copy every layer's KV.  Paged serving keeps the tails in a
shared block pool (nb, bs, Hkv, Dh) read through block tables.  An MLA
leaf is {"ckv" (B, Sc, kv_lora_rank), "kpe" (B, Sc, rope)}, exact in every
mode.

Under mesh serving a 'G' or 'L' layer's decode is the reference's island
(``kernels.ops.head_island``): the projections run in full on every model
rank, the rank writes and scores only its block of kv heads (its cache
holds no other), and the heads' outputs are gathered back in head order
before ``wo``, where the reference annotates them replicated, so no float
reduction is reordered.  An MLA layer's latent has no head axis: each
rank decodes its data shard's slots in full.
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


def chunked_attention(q, k, v, *, causal: bool, scale: float,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      q_offset: int = 0, chunk_kv: int = 1024):
    """Online-softmax attention over ``chunk_kv``-key chunks, in the
    reference's f32 order: no (Sq, Skv) score tensor is ever built.

    q (B, Sq, Hq, Dh), k (B, Skv, Hkv, Dh), v (B, Skv, Hkv, Dv)
    → (B, Sq, Hq, Dv).  Hq must be a multiple of Hkv (GQA grouping)."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    chunk_kv = min(chunk_kv, skv)
    dev = q.device
    f32 = torch.float32
    qh = q.to(f32).reshape(b, sq, hkv, g, dh).permute(0, 2, 3, 1, 4)
    qpos = q_offset + torch.arange(sq, device=dev)              # (Sq,)
    m = torch.full((b, hkv, g, sq), NEG, dtype=f32, device=dev)
    lsum = torch.zeros((b, hkv, g, sq), dtype=f32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=f32, device=dev)
    for c0 in range(0, skv, chunk_kv):
        # the reference zero-pads the last chunk; its pad keys are masked
        kb = k[:, c0:c0 + chunk_kv].to(f32).permute(0, 2, 1, 3)
        vb = v[:, c0:c0 + chunk_kv].to(f32).permute(0, 2, 1, 3)
        s = torch.matmul(qh, kb[:, :, None].transpose(-1, -2)) * scale
        s = _softcap(s, softcap)
        kpos = c0 + torch.arange(kb.shape[2], device=dev)        # (C,)
        ok = torch.ones((sq, kpos.shape[0]), dtype=torch.bool, device=dev)
        if causal:
            ok = ok & (qpos[:, None] >= kpos[None, :])
        if window is not None:
            ok = ok & (qpos[:, None] - kpos[None, :] < window)
        s = torch.where(ok, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p, vb[:, :, None])
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(q.dtype)


def ring_slot_positions(cache_size: int, t):
    """Absolute position stored in each ring slot at time t (next write =
    t); t scalar → (W,), or (B,) → (B, W).  Delegates to the canonical
    ring math in core.kv_compress."""
    return ring_positions(cache_size, t)


def decode_attention(q, k_cache, v_cache, *, t, scale: float,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     ring: bool = False, chunk_len=None):
    """One-token (or chunked mixed-mode) attention over an exact cache:
    position p at index p, or with ``ring`` at slot p % Sc (the ring's
    positions at its watermark come from ``ring_slot_positions``).

    Decode form — q (B, Hq, Dh), caches (B, Sc, Hkv, Dh); ``t`` = the
    query's position + 1 (entries with position < t participate).  Mixed
    form — q (B, L, Hq, Dh) with per-slot ``chunk_len`` and ``t`` = cache
    length before the chunk: row i sees positions < t + i + 1.  With
    ``window`` a row also drops positions below its qpos1 - window.  Rows
    at index >= chunk_len are garbage.  Returns like q."""
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
        tw = tb                                          # writes included
    else:
        qpos1 = tb[:, None] + torch.arange(l, device=dev)[None, :] + 1
        tw = tb + per_slot(chunk_len, b, dev)            # ring holds t + cl
    pos = (ring_slot_positions(sc, tw) if ring
           else torch.arange(sc, device=dev)[None, :].expand(b, sc))
    ok = ((pos >= 0)[:, None, :]
          & (pos[:, None, :] < qpos1[:, :, None]))        # (B, L, Sc)
    if window is not None:
        # the query sits at qpos1 - 1; the training mask qpos - kpos <
        # window keeps kpos >= qpos1 - window
        ok = ok & (pos[:, None, :] >= qpos1[:, :, None] - window)
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


def _theta(cfg: ModelConfig, layer_kind: str) -> float:
    if layer_kind == "L" and cfg.rope_theta_local is not None:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _qkv(p, x, cfg: ModelConfig, positions, layer_kind: str,
         kv_repeat: int):
    """Projections, qk-norm and RoPE (local layers take
    ``rope_theta_local`` where the config has one; a model with absolute
    sinusoidal positions adds them at the embedding and rotates
    nothing)."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, hq, dh)
    k = (x @ p["wk"]).reshape(b, s, hkv, dh)
    v = (x @ p["wv"]).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if cfg.pos_kind == "rope":
        th = _theta(cfg, layer_kind)
        q = apply_rope(q, positions, th)
        k = apply_rope(k, positions, th)
    if kv_repeat > 1:
        k = torch.repeat_interleave(k, kv_repeat, dim=2)
        v = torch.repeat_interleave(v, kv_repeat, dim=2)
    return q, k, v


def _head_block(q, k, v, cfg: ModelConfig, kv_repeat: int):
    """(island, q, k, v): under mesh serving this rank's block of heads
    (``kernels.ops.head_island``; q contiguous, as the kernels read whole
    rows) and the island that gathers the outputs back; (None, q, k, v)
    on one device or when the heads replicate."""
    isl = kops.head_island(cfg.n_heads, cfg.n_kv_heads * kv_repeat)
    if isl is None:
        return None, q, k, v
    return isl, q[:, :, isl.q].contiguous(), k[:, :, isl.kv], v[:, :, isl.kv]


def _scale(cfg: ModelConfig) -> float:
    return (cfg.query_scale if cfg.query_scale is not None
            else cfg.head_dim ** -0.5)


def attn_train(p, x, cfg: ModelConfig, *, layer_kind: str, positions,
               kv_repeat: int = 1, causal: bool = True,
               chunk_kv: int = 1024):
    """Full-sequence self-attention without a cache; ``causal=False`` is
    the encoder's bidirectional form."""
    q, k, v = _qkv(p, x, cfg, positions, layer_kind, kv_repeat)
    window = cfg.sliding_window if layer_kind == "L" else None
    out = chunked_attention(q, k, v, causal=causal, scale=_scale(cfg),
                            window=window, softcap=cfg.attn_logit_softcap,
                            chunk_kv=chunk_kv)
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ p["wo"]


def attn_prefill(p, x, cfg: ModelConfig, *, layer_kind: str, positions,
                 kv_repeat: int = 1, chunk_kv: int = 1024):
    """Causal prefill: returns (y, cache).  A 'G' layer's cache holds the
    exact k/v of every position, (B, S, Hkv, Dh); an 'L' layer's holds
    only the last ``window`` keys at their ring slots p % window (zero
    padded up to ``window`` when S is shorter)."""
    q, k, v = _qkv(p, x, cfg, positions, layer_kind, kv_repeat)
    window = cfg.sliding_window if layer_kind == "L" else None
    out = chunked_attention(q, k, v, causal=True, scale=_scale(cfg),
                            window=window, softcap=cfg.attn_logit_softcap,
                            chunk_kv=chunk_kv)
    b, s = out.shape[:2]
    y = out.reshape(b, s, -1) @ p["wo"]
    if window is not None and s > window:
        # tail key j (0-based) is position s - window + j, at ring slot
        # (s - window + j) % window: a rotation of the last window keys
        shift = (s - window) % window
        inv = torch.remainder(torch.arange(window, device=k.device) - shift,
                              window)
        return y, {"k": k[:, -window:][:, inv], "v": v[:, -window:][:, inv]}
    if window is not None and s < window:
        pad = (0, 0, 0, 0, 0, window - s)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    return y, {"k": k, "v": v}


def init_cache_attn(cfg: ModelConfig, layer_kind: str, batch: int,
                    max_seq: int, kv_repeat: int = 1, device=None,
                    quantized: bool = False):
    """Exact KV cache of an attention layer: ``max_seq`` positions for
    'G', a ring of min(max_seq, window) for 'L'; ``quantized``: int8 with
    a static per-head scale (the reference starts it at 1; a caller
    calibrates it)."""
    dt = cdtype(cfg)
    window = cfg.sliding_window if layer_kind == "L" else None
    sc = min(max_seq, window) if window else max_seq
    hkv = cfg.n_kv_heads * kv_repeat
    shape = (batch, sc, hkv, cfg.head_dim)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.ones(hkv, device=device),
                "v_scale": torch.ones(hkv, device=device)}
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _cache_read(cache, cfg: ModelConfig):
    """Dequantize-on-read for int8 caches; identity otherwise."""
    if "k_scale" not in cache:
        return cache["k"], cache["v"]
    dt = cdtype(cfg)
    k = cache["k"].to(dt) * cache["k_scale"][None, None, :, None].to(dt)
    v = cache["v"].to(dt) * cache["v_scale"][None, None, :, None].to(dt)
    return k, v


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
    in place; out-of-range slots (masked chunk rows) are dropped.  An int8
    cache takes round(x / scale) clipped to ±127 (``torch.round`` rounds
    half to even, as ``jnp.round`` does)."""
    if "k_scale" in cache:
        def quant(x, sc):
            x = x.to(torch.float32) / sc[None, None, :, None]
            return torch.clamp(torch.round(x), -127, 127).to(torch.int8)

        k_new = quant(k_new, cache["k_scale"])
        v_new = quant(v_new, cache["v_scale"])
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


# The per-slot summary state of a clustered cache leaf: everything a slot
# owns beyond its tail-ring payload, which prefix-shared admission
# snapshots at chunk boundaries and restores into a fresh slot
# (runtime/prefix_cache.py); the tail bytes are shared through the block
# pool instead.
CLUSTERED_SLOT_KEYS = ("k_cents", "v_cents", "counts", "cov")


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
    q, k, v = _qkv(p, x, cfg, positions, "G", kv_repeat)
    isl, q, k, v = _head_block(q, k, v, cfg, kv_repeat)
    tail = cache["k_tail"].shape[1]
    # masked chunk rows write out of range (dropped)
    slot = torch.where(ri < cl[:, None], torch.remainder(positions, tail),
                       torch.full_like(positions, tail))
    _ring_write_(cache["k_tail"], k, slot)
    _ring_write_(cache["v_tail"], v, slot)
    k_tail, v_tail = cache["k_tail"], cache["v_tail"]
    cov = cache["cov"]

    hq = q.shape[2]
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
    out = out.reshape(b, l, hq, cfg.head_dim)
    if isl is not None:
        out = isl.gather(out)
    y = out.reshape(b, l, -1).to(x.dtype) @ p["wo"]
    return y, cache


def attn_decode_clustered_packed(p, x, cfg: ModelConfig, *, cache,
                                 row_slot, row_pos, row_tw, block_tables,
                                 block_size: int, kv_repeat: int = 1,
                                 row_wlo=None, row_group=None):
    """Paged clustered-KV attention over packed ragged rows.

    x (N, 1, d): one embedding per real (slot, position) pair this step,
    padded to the row bucket.  row_slot (N,) slot; row_pos (N,) absolute
    position (−1: padding row, output garbage by contract); row_tw (N,)
    the slot's ring watermark t + chunk_len (all of a chunk's rows are
    written before any row scores, so intra-chunk causality falls out of
    the per-row position mask as in the dense mixed launch); block_tables
    (B, T) global block ids, every entry valid, with every block written
    this step owned by its slot alone (``kv_pool.ensure``); row_group
    (N,) the kernel's row groups (``paged_clustered_decode.group_rows``),
    or None.

    Each row's K/V go into its slot's pool block at the ring offset the
    dense path uses (in place; padding rows drop), so the pool holds the
    dense ring's live bytes and the outputs equal the dense engine's."""
    n = x.shape[0]
    positions = row_pos[:, None]                          # (N, 1)
    q, k, v = _qkv(p, x, cfg, positions, "G", kv_repeat)
    isl, q, k, v = _head_block(q, k, v, cfg, kv_repeat)
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
        row_cov, row_wlo, row_group, scale=_scale(cfg),
        softcap=cfg.attn_logit_softcap)
    if isl is not None:
        out = isl.gather(out)
    y = out.reshape(n, 1, cfg.n_heads * cfg.head_dim).to(x.dtype) @ p["wo"]
    return y, cache


def attn_decode_window_packed(p, x, cfg: ModelConfig, *, cache, row_slot,
                              row_pos, row_cidx, width: int,
                              kv_repeat: int = 1):
    """Sliding-window ('L') attention over packed ragged rows, the local
    twin of ``attn_decode_clustered_packed``: the ring stays the dense
    per-slot {'k', 'v'} (B, W, Hkv, Dh) leaf, never in the pool.

    ``row_cidx`` (N,) is each row's index in its admission chunk (decode
    rows 0) and ``width`` the launch's longest chunk: round jj writes the
    K/V of every row with index jj into its slot's ring (in place), then
    scores those rows at watermark row_pos + 1, the blocking engine's
    one-token-at-a-time schedule.  Two rows of one slot never share an
    index, so each round's writes do not collide.  Under mesh serving the
    rank writes and scores its block of heads (``_head_block``)."""
    n = x.shape[0]
    f32 = torch.float32
    q, k, v = _qkv(p, x, cfg, row_pos[:, None], "L", kv_repeat)
    isl, q, k, v = _head_block(q, k, v, cfg, kv_repeat)
    kc, vc = cache["k"], cache["v"]
    b, sc = kc.shape[0], kc.shape[1]
    valid = row_pos >= 0
    rs = row_slot.long()
    ring_slot = rs * sc + torch.remainder(row_pos, sc).long()
    out = torch.zeros((n,) + q.shape[2:], dtype=f32, device=x.device)
    for jj in range(width):
        sel = valid & (row_cidx == jj)
        # rows outside this round point past the flattened rings and drop
        flat = torch.where(sel, ring_slot, torch.full_like(ring_slot, b * sc))
        for buf, new in ((kc, k), (vc, v)):
            _ring_write_(buf.view(1, b * sc, *buf.shape[2:]),
                         new[:, 0][None], flat[None])
        out_jj = decode_attention(q[:, 0], kc[rs], vc[rs], t=row_pos + 1,
                                  scale=_scale(cfg),
                                  window=cfg.sliding_window,
                                  softcap=cfg.attn_logit_softcap, ring=True)
        out = torch.where(sel[:, None, None], out_jj.to(f32), out)
    if isl is not None:
        out = isl.gather(out)
    y = out.reshape(n, 1, -1).to(x.dtype) @ p["wo"]
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
    b, l = x.shape[0], x.shape[1]
    dev = x.device
    tb = per_slot(t, b, dev)
    chunked = chunk_len is not None
    cl = per_slot(chunk_len, b, dev, fill=1)
    ri = torch.arange(l, device=dev)[None, :]
    positions = tb[:, None] + ri                          # (B, L)
    q, k, v = _qkv(p, x, cfg, positions, layer_kind, kv_repeat)
    isl, q, k, v = _head_block(q, k, v, cfg, kv_repeat)
    window = cfg.sliding_window if layer_kind == "L" else None
    sc = cache["k"].shape[1]
    scale, softcap = _scale(cfg), cfg.attn_logit_softcap
    if chunked and window is not None:
        # WindowRetention's staging rule: a whole chunk written into a
        # W-entry ring at once would overwrite positions t + i - W still in
        # earlier rows' windows, and no frontier covers them.  So row i is
        # written at its ring slot and then scored at watermark t + i + 1,
        # the schedule the blocking engine runs one step at a time; its
        # victim (position t + i - W) is outside every later row's window.
        outs = []
        for i in range(l):
            slot_i = torch.where(i < cl, torch.remainder(tb + i, sc),
                                 torch.full_like(tb, sc))[:, None]
            _cache_write(cache, k[:, i:i + 1], v[:, i:i + 1], slot_i)
            k_read, v_read = _cache_read(cache, cfg)
            outs.append(decode_attention(q[:, i], k_read, v_read,
                                         t=tb + i + 1, scale=scale,
                                         window=window, softcap=softcap,
                                         ring=True))
        out = torch.stack(outs, dim=1)
        if isl is not None:
            out = isl.gather(out)
        return out.reshape(b, l, -1) @ p["wo"], cache
    slot = (torch.remainder(positions, sc) if window
            else torch.clamp(positions, max=sc - 1))
    slot = torch.where(ri < cl[:, None], slot, torch.full_like(slot, sc))
    _cache_write(cache, k, v, slot)
    k_read, v_read = _cache_read(cache, cfg)
    ring = window is not None
    if chunked:
        out = decode_attention(q, k_read, v_read, t=tb, chunk_len=cl,
                               scale=scale, window=window, softcap=softcap,
                               ring=ring)
    else:
        out = decode_attention(q[:, 0], k_read, v_read, t=tb + 1,
                               scale=scale, window=window, softcap=softcap,
                               ring=ring)
    if isl is not None:
        out = isl.gather(out)
    y = out.reshape(b, l, -1) @ p["wo"]
    return y, cache


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def init_cross_attn(generator, cfg: ModelConfig, device=None):
    return init_attn(generator, cfg, device)


def cross_attn_apply(p, x, enc_kv, cfg: ModelConfig):
    """x (B, Sq, d) over the encoder's ``enc_kv`` = (k, v), each (B, S_enc,
    Hkv, Dh) from :func:`cross_kv`: bidirectional, no positions, the
    config's logit softcap."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k, v = enc_kv
    out = chunked_attention(q, k, v, causal=False, scale=_scale(cfg),
                            softcap=cfg.attn_logit_softcap)
    return out.reshape(b, s, -1) @ p["wo"]


def cross_kv(p, enc_out, cfg: ModelConfig):
    """A decoder layer's cross-attention keys and values over the encoder
    output (B, S_enc, d): computed once at prefill and carried unchanged
    through every decode step."""
    b, s, _ = enc_out.shape
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    k = (enc_out @ p["wk"]).reshape(b, s, hkv, dh)
    v = (enc_out @ p["wv"]).reshape(b, s, hkv, dh)
    return k, v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): low-rank Q/KV with a compressed-latent cache
# ---------------------------------------------------------------------------


def init_mla(generator, cfg: ModelConfig, device=None):
    """The reference's MLA leaves: the low-rank query ("wdq", "q_norm",
    "wuq"), the latent ("wdkv", "kv_norm"), its up-projection to per-head
    keys and values ("wukv"), the shared rotary key ("wkr") and "wo".  The
    two norms stay f32 (``rms_head_norm`` reads them uncast)."""
    m = cfg.mla
    d, h, dt = cfg.d_model, cfg.n_heads, cdtype(cfg)
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    w = lambda shape: dense_init(generator, shape, dtype=dt,  # noqa: E731
                                 device=device)
    return {
        "wdq": w((d, m.q_lora_rank)),
        "q_norm": torch.ones(m.q_lora_rank, device=device),
        "wuq": w((m.q_lora_rank, h * qd)),
        "wdkv": w((d, m.kv_lora_rank)),
        "kv_norm": torch.ones(m.kv_lora_rank, device=device),
        "wukv": w((m.kv_lora_rank,
                   h * (m.qk_nope_head_dim + m.v_head_dim))),
        "wkr": w((d, m.qk_rope_head_dim)),
        "wo": w((h * m.v_head_dim, d)),
    }


def _mla_q(p, x, cfg: ModelConfig, positions):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope)), the rotary half
    at ``positions``."""
    m = cfg.mla
    b, s, _ = x.shape
    cq = rms_head_norm(p["q_norm"], x @ p["wdq"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(b, s, cfg.n_heads,
                                m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_rope


def _mla_latent(p, x, cfg: ModelConfig, positions):
    """(ckv (B, S, kv_lora_rank), kpe (B, S, rope)): what the cache holds
    a token, the normed latent and the rotary key every head shares."""
    ckv = rms_head_norm(p["kv_norm"], x @ p["wdkv"], cfg.norm_eps)
    kpe = (x @ p["wkr"])[:, :, None, :]                  # (B, S, 1, rope)
    kpe = apply_rope(kpe, positions, cfg.rope_theta)[:, :, 0]
    return ckv, kpe


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def _mla_expanded(p, x, cfg: ModelConfig, positions, chunk_kv: int):
    """The expanded form: per-head keys and values up-projected from the
    latent, causal chunked attention.  Returns (y, (ckv, kpe))."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, kpe = _mla_latent(p, x, cfg, positions)
    kv = (ckv @ p["wukv"]).reshape(b, s, h,
                                   m.qk_nope_head_dim + m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :m.qk_nope_head_dim],
                   kpe[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)],
                  dim=-1)
    out = chunked_attention(q, k, kv[..., m.qk_nope_head_dim:], causal=True,
                            scale=_mla_scale(cfg), chunk_kv=chunk_kv)
    return out.reshape(b, s, -1) @ p["wo"], (ckv, kpe)


def mla_train(p, x, cfg: ModelConfig, *, positions, chunk_kv: int = 1024):
    """Expanded (training / prefill) form: materializes per-head K/V."""
    return _mla_expanded(p, x, cfg, positions, chunk_kv)[0]


def init_cache_mla(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """The latent cache: {"ckv" (B, max_seq, kv_lora_rank), "kpe" (B,
    max_seq, rope)} in the compute dtype, position p at index p."""
    m, dt = cfg.mla, cdtype(cfg)
    return {"ckv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dt,
                               device=device),
            "kpe": torch.zeros((batch, max_seq, m.qk_rope_head_dim),
                               dtype=dt, device=device)}


def mla_prefill(p, x, cfg: ModelConfig, *, positions, max_seq: int,
                chunk_kv: int = 1024):
    """Causal prefill in the expanded form; the cache is the latent,
    zero-padded out to ``max_seq`` positions (a longer prompt keeps its
    S)."""
    y, (ckv, kpe) = _mla_expanded(p, x, cfg, positions, chunk_kv)
    pad = max_seq - x.shape[1]
    if pad > 0:
        ckv = torch.nn.functional.pad(ckv, (0, 0, 0, pad))
        kpe = torch.nn.functional.pad(kpe, (0, 0, 0, pad))
    return y, {"ckv": ckv, "kpe": kpe}


def mla_decode(p, x, cfg: ModelConfig, *, cache, t):
    """Absorbed one-token decode over the latent cache: W_uk is folded
    into the query, so scores hit (ckv, kpe) directly and per-head keys
    are never built.  x (B, 1, d); ``t`` scalar or (B,), each slot's
    position.  The new latent is written into the cache in place.

    The reference's casts: the absorbed query is formed in the compute
    dtype, then scores, softmax and the context are f32 (positions >= t +
    1 masked to -1e30, the sum clamped at 1e-30), and the context goes
    back to the compute dtype before W_uv."""
    m = cfg.mla
    dt = cdtype(cfg)
    b = x.shape[0]
    h = cfg.n_heads
    dev = x.device
    f32 = torch.float32
    tb = per_slot(t, b, dev)
    positions = tb[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)        # (B, 1, H, .)
    ckv_new, kpe_new = _mla_latent(p, x, cfg, positions)
    ckv, kpe = cache["ckv"], cache["kpe"]
    rows = torch.arange(b, device=dev)
    # A slot decoding past max_seq keeps its cache: the reference's
    # out-of-bounds .at[].set is dropped, so write the old entry back.
    idx = torch.clamp(tb, max=ckv.shape[1] - 1).long()
    keep = (tb >= ckv.shape[1])[:, None]
    ckv[rows, idx] = torch.where(keep, ckv[rows, idx],
                                 ckv_new[:, 0].to(ckv.dtype))
    kpe[rows, idx] = torch.where(keep, kpe[rows, idx],
                                 kpe_new[:, 0].to(kpe.dtype))

    wukv = p["wukv"].reshape(m.kv_lora_rank, h,
                             m.qk_nope_head_dim + m.v_head_dim)
    wuk = wukv[..., :m.qk_nope_head_dim]                 # (r, H, nope)
    wuv = wukv[..., m.qk_nope_head_dim:]                 # (r, H, v)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], wuk)
    ckv32 = ckv.to(f32)
    s = (torch.einsum("bhr,bsr->bhs", q_abs.to(f32), ckv32)
         + torch.einsum("bhe,bse->bhs", q_rope[:, 0].to(f32),
                        kpe.to(f32))) * _mla_scale(cfg)
    pos = torch.arange(ckv.shape[1], device=dev)
    s = torch.where((pos[None, :] < (tb + 1)[:, None])[:, None, :], s,
                    torch.full_like(s, NEG))
    w = torch.exp(s - s.amax(-1, keepdim=True))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-30)
    ctx = torch.einsum("bhs,bsr->bhr", w, ckv32)         # (B, H, r)
    out = torch.einsum("bhr,rhv->bhv", ctx.to(dt), wuv)
    return out.reshape(b, 1, -1) @ p["wo"], cache
