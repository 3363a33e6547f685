"""Model assembly for serving a decoder-only GQA stack of global ('G')
and sliding-window ('L') layers (port of the prefill and decode subset of
``repro.models.transformer``).

Parameters: ``{"embed": {"table"}, "layers": [per-layer dict], "final_norm"}``
where each layer dict has the reference's keys ("norm1", "attn", "norm2",
"mlp", and "post_attn_norm" / "post_mlp_norm" under ``post_norms``).  The reference stacks repeated layers under ``params["scan"]``
with a leading layer axis; the port keeps one entry per layer and runs a
Python loop over them (``bridge`` converts between the two).  The decode
cache is ``{"layers": [per-layer leaf]}`` with the reference's leaf
layouts; :func:`prefill` builds an exact one and :func:`decode_step`
updates a cache in place.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.kernels.clustered_decode import per_slot
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       init_embed, init_mlp, init_norm,
                                       lm_logits, resolve_device)


def layout(cfg: ModelConfig):
    """(n_prefix, n_rep, tail_kinds) for the decoder stack."""
    n_prefix = cfg.moe.n_dense_layers if cfg.moe else 0
    rest = cfg.n_layers - n_prefix
    plen = len(cfg.layer_pattern)
    n_rep = rest // plen
    tail = [cfg.layer_pattern[i % plen] for i in range(n_rep * plen, rest)]
    return n_prefix, n_rep, tail


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Kind of every layer in stack order (prefix, scan repeats, tail)."""
    n_prefix, n_rep, tail = layout(cfg)
    return ["G"] * n_prefix + list(cfg.layer_pattern) * n_rep + list(tail)


def check_supported(cfg: ModelConfig) -> None:
    """The port serves decoder-only dense stacks of 'G' layers and 'L'
    layers with a ``sliding_window``; anything else names the ROADMAP item
    that brings it."""
    kinds = set(layer_kinds(cfg))
    if "L" in kinds and not cfg.sliding_window:
        raise ValueError(f"model '{cfg.name}': 'L' layers need a "
                         "sliding_window")
    problems = []
    if kinds - {"G", "L"}:
        problems.append(f"layer pattern {cfg.layer_pattern!r} (the "
                        "recurrent kinds 'M' and 'R' are ROADMAP Queue A "
                        "item 8)")
    if cfg.moe is not None:
        problems.append("MoE layers (ROADMAP Queue A item 8)")
    if cfg.attn_kind != "gqa":
        problems.append(f"attn_kind {cfg.attn_kind!r} (ROADMAP Queue A "
                        "item 8)")
    if cfg.is_encdec or cfg.frontend is not None:
        problems.append("encoder-decoder / modality frontends (ROADMAP "
                        "Queue A item 8)")
    if cfg.pos_kind != "rope":
        problems.append(f"pos_kind {cfg.pos_kind!r} (ROADMAP Queue A "
                        "item 8)")
    if problems:
        raise NotImplementedError(f"model '{cfg.name}': " + "; ".join(problems))


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_sublayer(generator, cfg: ModelConfig, kind: str, device=None):
    """One attention sublayer's parameters, with the sandwich norms
    ("post_attn_norm", "post_mlp_norm") when ``cfg.post_norms`` is set."""
    if kind not in ("G", "L"):
        raise NotImplementedError(f"layer kind {kind!r} is not ported "
                                  "(ROADMAP Queue A item 8)")
    p = {"norm1": init_norm(cfg, cfg.d_model, device),
         "attn": attn.init_attn(generator, cfg, device)}
    if cfg.post_norms:
        p["post_attn_norm"] = init_norm(cfg, cfg.d_model, device)
    p["norm2"] = init_norm(cfg, cfg.d_model, device)
    p["mlp"] = init_mlp(generator, cfg, cfg.d_ff, device)
    if cfg.post_norms:
        p["post_mlp_norm"] = init_norm(cfg, cfg.d_model, device)
    return p


def init_params(generator, cfg: ModelConfig, device=None):
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``, or an int seed).  Weights are drawn in f32 and stored in
    ``cfg.dtype``.  ``device`` None means CUDA.  The draws are not the
    reference's ``jax.random`` draws; for parity, load the reference's
    parameters through ``bridge.params_from_numpy``."""
    check_supported(cfg)
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    return {
        "embed": init_embed(generator, cfg, dev),
        "layers": [init_sublayer(generator, cfg, k, dev)
                   for k in layer_kinds(cfg)],
        "final_norm": init_norm(cfg, cfg.d_model, dev),
    }


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _ffn(p, h, cfg: ModelConfig):
    """norm2 → mlp → residual (+sandwich norm)."""
    x = apply_norm(p["norm2"], h, cfg)
    y = apply_mlp(p["mlp"], x, cfg)
    if cfg.post_norms:
        y = apply_norm(p["post_mlp_norm"], y, cfg)
    return h + y


def init_sublayer_cache(cfg: ModelConfig, kind: str, batch: int,
                        max_seq: int, kv_repeat: int, kv_mode: str = "exact",
                        kv_clusters: int = 512, kv_tail: int = 256,
                        kv_pool_blocks: int = 0, kv_block_size: int = 0,
                        device=None):
    """A layer's decode cache.  In ``kv_mode="clustered"`` only 'G' layers
    take the clustered layout; an 'L' layer keeps its dense window ring."""
    if kind not in ("G", "L"):
        raise NotImplementedError(f"layer kind {kind!r} is not ported "
                                  "(ROADMAP Queue A item 8)")
    if kind == "G" and kv_mode == "clustered":
        return attn.init_cache_attn_clustered(
            cfg, batch, n_clusters=kv_clusters, tail=kv_tail,
            kv_repeat=kv_repeat, device=device, pool_blocks=kv_pool_blocks,
            block_size=kv_block_size)
    if kv_mode not in ("exact", "int8", "clustered"):
        raise ValueError(f"kv_mode {kv_mode!r}")
    return attn.init_cache_attn(cfg, kind, batch, max_seq, kv_repeat,
                                device=device, quantized=kv_mode == "int8")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               kv_repeat: int = 1, kv_mode: str = "exact",
               kv_clusters: int = 512, kv_tail: int = 256,
               kv_pool_blocks: int = 0, kv_block_size: int = 0, device=None):
    """``{"layers": [leaf per layer]}``; ``device`` None means CUDA.
    ``kv_pool_blocks``/``kv_block_size`` switch clustered tails to the
    paged block-pool layout (runtime/kv_pool.py): one pool per layer
    leaf, all sharing the engine's single block table."""
    check_supported(cfg)
    dev = resolve_device(device)
    return {"layers": [
        init_sublayer_cache(cfg, k, batch, max_seq, kv_repeat, kv_mode,
                            kv_clusters, kv_tail, kv_pool_blocks,
                            kv_block_size, dev)
        for k in layer_kinds(cfg)]}


def clustered_slot_state(cache, j: int):
    """Snapshot slot ``j``'s summary rows (``attention.CLUSTERED_SLOT_KEYS``:
    centroids, counts, coverage frontier) from every clustered leaf of an
    engine cache, as ``{"layers": [{key: (1, ...)} or None]}`` (None for a
    leaf that is not clustered: an 'L' window ring is in no snapshot).
    Tail payloads are not copied: in the paged engine they live in pool
    blocks that the prefix cache pins by ref count.

    The rows are cloned, not viewed: slot ``j`` goes on absorbing and
    decoding after the snapshot, and a view would follow it."""
    return {"layers": [
        {k: leaf[k][j:j + 1].clone() for k in attn.CLUSTERED_SLOT_KEYS}
        if "k_cents" in leaf else None
        for leaf in cache["layers"]]}


def restore_clustered_slot_state(cache, snap, j: int):
    """Write a ``clustered_slot_state`` snapshot into slot ``j`` of every
    clustered leaf, in place (prefix-shared admission: the reused prompt
    centroids and coverage frontier land in the fresh slot; its ring
    blocks are adopted through the block table separately).  Returns the
    cache."""
    for leaf, s in zip(cache["layers"], snap["layers"]):
        if s is not None:
            for k in attn.CLUSTERED_SLOT_KEYS:
                leaf[k][j:j + 1] = s[k].to(leaf[k].dtype)
    return cache


def sublayer_prefill(p, h, cfg: ModelConfig, kind: str, *, positions,
                     kv_repeat: int, max_seq: int):
    """h (B, S, d) → (h, cache): a 'G' layer's exact k/v zero-padded out
    to ``max_seq`` positions for decode, an 'L' layer's window ring."""
    x = apply_norm(p["norm1"], h, cfg)
    y, cache = attn.attn_prefill(p["attn"], x, cfg, layer_kind=kind,
                                 positions=positions, kv_repeat=kv_repeat)
    s = cache["k"].shape[1]
    if s < max_seq and kind == "G":
        pad = (0, 0, 0, 0, 0, max_seq - s)
        cache = {k: torch.nn.functional.pad(v, pad) for k, v in cache.items()}
    if cfg.post_norms:
        y = apply_norm(p["post_attn_norm"], y, cfg)
    h = h + y
    return _ffn(p, h, cfg), cache


def prefill(params, cfg: ModelConfig, tokens, *, max_seq: int,
            kv_repeat: int = 1, last_pos=None):
    """Full-sequence prefill of tokens (B, S).  Returns (logits (B, V) f32
    of position ``last_pos`` (default the last), cache): with prompts
    right-padded to a bucket, the causal mask keeps position last_pos
    exact whatever the padding behind it.  The cache is exact,
    ``{"layers": [{"k", "v"}]}``: (B, max(S, max_seq), Hkv, Dh) for a 'G'
    layer, the (B, window, Hkv, Dh) ring for an 'L' layer."""
    h = embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    layers = []
    for lp, kind in zip(params["layers"], layer_kinds(cfg)):
        h, c = sublayer_prefill(lp, h, cfg, kind, positions=positions,
                                kv_repeat=kv_repeat, max_seq=max_seq)
        layers.append(c)
    h = apply_norm(params["final_norm"], h, cfg)
    h_last = h[:, -1:] if last_pos is None else h[:, last_pos:last_pos + 1]
    return lm_logits(params["embed"], h_last, cfg)[:, 0], {"layers": layers}


def sublayer_decode(p, h, cfg: ModelConfig, kind: str, cache, t, *,
                    kv_repeat: int, chunk_len=None):
    """h (B, 1, d), or (B, L, d) in mixed mode with per-slot
    ``chunk_len``.  Returns (h, cache); the cache is written in place."""
    x = apply_norm(p["norm1"], h, cfg)
    y, cache = attn.attn_decode(p["attn"], x, cfg, layer_kind=kind,
                                cache=cache, t=t, kv_repeat=kv_repeat,
                                chunk_len=chunk_len)
    if cfg.post_norms:
        y = apply_norm(p["post_attn_norm"], y, cfg)
    h = h + y
    return _ffn(p, h, cfg), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, t, *,
                kv_repeat: int = 1, chunk_len=None):
    """One engine step.  tokens (B, 1) with ``t`` scalar or (B,) (each
    slot's position), or mixed mode: tokens (B, L) with per-slot
    ``chunk_len`` (B,) valid columns and ``t`` (B,) the cache length before
    the step.  Returns (logits (B, V) f32, cache) — each slot's LAST valid
    row — and writes the new keys and values into ``cache`` in place."""
    h = embed_tokens(params["embed"], tokens, cfg)
    kinds = layer_kinds(cfg)
    for lp, kind, c in zip(params["layers"], kinds, cache["layers"]):
        h, _ = sublayer_decode(lp, h, cfg, kind, c, t, kv_repeat=kv_repeat,
                               chunk_len=chunk_len)
    h = apply_norm(params["final_norm"], h, cfg)
    if chunk_len is not None:
        # gather each slot's last valid row before the vocab projection
        b = h.shape[0]
        idx = per_slot(chunk_len, b, h.device).long() - 1
        h = h[torch.arange(b, device=h.device), idx][:, None]
    logits = lm_logits(params["embed"], h, cfg)[:, 0]
    return logits, cache


def _sublayer_decode_packed(p, h, cfg: ModelConfig, cache, *, row_slot,
                            row_pos, row_tw, block_tables, block_size,
                            kv_repeat, row_group):
    """One 'G' sublayer over packed rows (paged clustered KV).  h
    (N, 1, d); every non-attention op is row-wise, so rows stand in for
    the batch axis exactly."""
    x = apply_norm(p["norm1"], h, cfg)
    y, cache = attn.attn_decode_clustered_packed(
        p["attn"], x, cfg, cache=cache, row_slot=row_slot, row_pos=row_pos,
        row_tw=row_tw, block_tables=block_tables, block_size=block_size,
        kv_repeat=kv_repeat, row_group=row_group)
    if cfg.post_norms:
        y = apply_norm(p["post_attn_norm"], y, cfg)
    h = h + y
    return _ffn(p, h, cfg), cache


def _sublayer_decode_window_packed(p, h, cfg: ModelConfig, cache, *,
                                   row_slot, row_pos, row_cidx, width,
                                   kv_repeat):
    """One 'L' sublayer over packed rows: the dense window ring, written
    in row_cidx order (``attention.attn_decode_window_packed``)."""
    x = apply_norm(p["norm1"], h, cfg)
    y, cache = attn.attn_decode_window_packed(
        p["attn"], x, cfg, cache=cache, row_slot=row_slot, row_pos=row_pos,
        row_cidx=row_cidx, width=width, kv_repeat=kv_repeat)
    if cfg.post_norms:
        y = apply_norm(p["post_attn_norm"], y, cfg)
    h = h + y
    return _ffn(p, h, cfg), cache


def decode_step_packed(params, cfg: ModelConfig, cache, tokens, row_slot,
                       row_pos, row_tw, row_cidx, block_tables, *,
                       block_size: int, width: int = 1, kv_repeat: int = 1,
                       row_group=None):
    """Packed ragged engine step for the paged clustered-KV path.

    Each real (slot, position) pair is one row: tokens (N,), row_slot (N,)
    slot, row_pos (N,) absolute position (−1: padding row), row_tw (N,)
    the slot's ring watermark t + chunk_len this step, row_cidx (N,) the
    row's index within its admission chunk and ``width`` the step's
    longest chunk (both sequence the 'L' layers' ring writes),
    block_tables (B, T) global tail-block ids,
    row_group (N,) the attention kernel's row groups
    (``kernels.paged_clustered_decode.group_rows``; None: one row each).
    Returns (logits (N, V) f32, cache), every row's next-token
    distribution, and writes the new keys and values into the cache's
    pools in place.  MLP, norms and embeddings are row-wise, so rows
    stand in for the batch exactly."""
    kinds = layer_kinds(cfg)
    tokens = torch.where(row_pos >= 0, tokens, torch.zeros_like(tokens))
    h = embed_tokens(params["embed"], tokens[:, None], cfg)   # (N, 1, d)
    for lp, kind, c in zip(params["layers"], kinds, cache["layers"]):
        if kind == "L":
            h, _ = _sublayer_decode_window_packed(
                lp, h, cfg, c, row_slot=row_slot, row_pos=row_pos,
                row_cidx=row_cidx, width=width, kv_repeat=kv_repeat)
            continue
        h, _ = _sublayer_decode_packed(
            lp, h, cfg, c, row_slot=row_slot, row_pos=row_pos,
            row_tw=row_tw, block_tables=block_tables,
            block_size=block_size, kv_repeat=kv_repeat, row_group=row_group)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = lm_logits(params["embed"], h, cfg)[:, 0]
    return logits, cache
