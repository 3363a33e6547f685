"""Model assembly (port of ``repro.models.transformer``): decoder stacks
of global ('G') and
sliding-window ('L') attention layers, GQA or MLA (DeepSeek-V3's latent
attention), Mamba2 SSD ('M') and RG-LRU ('R') recurrent layers, with dense
or MoE FFNs; encoder-decoder stacks (a bidirectional encoder, and
cross-attention in every decoder layer); the vision / audio frontend
stubs, whose projected embeddings are prepended to the text (decoder-only)
or feed the encoder (encoder-decoder); RoPE or absolute sinusoidal
positions.

Parameters: ``{"embed": {"table"}, "layers": [per-layer dict],
"final_norm"}``, plus ``"frontend": {"proj"}`` under a frontend and
``"encoder": {"layers": [...], "final_norm"}`` for an encoder-decoder.
Each layer dict has the reference's keys: "norm1", "attn" (GQA, or MLA's
leaves under ``attn_kind="mla"``), "norm2", "mlp" or "moe" (and
"post_attn_norm" / "post_mlp_norm" under ``post_norms``, "xnorm" and
"xattn" in an encoder-decoder's decoder) for an attention layer, "norm1"
and "ssm" for an 'M' layer, "norm1", "rg", "norm2" and "mlp" for an 'R'
layer.  Under ``cfg.moe`` every 'G' / 'L' layer takes a "moe" FFN, except
the first ``moe.n_dense_layers``, dense 'G' layers of width
``moe.d_ff_dense``.  Under ``cfg.mtp_depth`` > 0, DeepSeek's
multi-token-prediction module ("mtp": "proj", "norm_h", "norm_e", a 'G'
"layer" and "final_norm"), a training head that serving never reads.
The reference stacks repeated layers under
``params["scan"]`` with a leading layer axis; the port keeps one entry per
layer and runs a Python loop over them (``bridge`` converts between the
two).  The decode cache is ``{"layers": [per-layer leaf]}`` with the
reference's leaf layouts, and for an encoder-decoder ``"cross": [(k, v)
per layer]``, the encoder's keys and values, fixed after prefill;
:func:`prefill` builds an exact one and :func:`decode_step` updates a
cache in place (a recurrent leaf's entries are replaced by the stepped
state; an attention leaf's tensors are written).

Training: :func:`forward_trunk` runs every layer kind's full-sequence
form (:func:`sublayer_train`), recomputing each repeat of the layer
pattern in the backward pass under ``remat`` (the reference's
``jax.checkpoint`` over its scan group); :func:`train_loss` adds the
chunked cross-entropy (:func:`chunked_ce`, logits one chunk at a time),
DeepSeek's MTP loss and the MoE layers' auxiliary loss.  The gradient is
PyTorch autograd; no op on the training path writes a tensor that
autograd saved.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import layer_state
from repro_torch.kernels.clustered_decode import per_slot
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_frontend, apply_mlp, apply_norm,
                                       cdtype, dense_init, embed_tokens,
                                       init_embed, init_frontend, init_mlp,
                                       init_norm, lm_logits, resolve_device,
                                       sinusoidal_pos)


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
    """The port serves every layer kind of the zoo: 'G' layers (GQA or
    MLA), 'L' layers with a ``sliding_window``, 'M' / 'R' recurrent layers,
    dense or MoE FFNs, the frontend stubs, encoder-decoder stacks, and
    RoPE or absolute sinusoidal positions.  An 'L' layer without a window
    raises ValueError, an unknown layer kind or attention kind
    NotImplementedError."""
    kinds = set(layer_kinds(cfg))
    if "L" in kinds and not cfg.sliding_window:
        raise ValueError(f"model '{cfg.name}': 'L' layers need a "
                         "sliding_window")
    problems = []
    if kinds - set("GLMR"):
        problems.append(f"unknown layer kinds in {cfg.layer_pattern!r}")
    if cfg.attn_kind not in ("gqa", "mla"):
        problems.append(f"unknown attn_kind {cfg.attn_kind!r}")
    if cfg.pos_kind not in ("rope", "abs_sinusoidal"):
        problems.append(f"unknown pos_kind {cfg.pos_kind!r}")
    if problems:
        raise NotImplementedError(f"model '{cfg.name}': " + "; ".join(problems))


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_sublayer(generator, cfg: ModelConfig, kind: str,
                  use_moe: bool = False, d_ff=None, device=None,
                  cross: bool = False):
    """One sublayer's parameters: an attention layer (MLA under
    ``attn_kind="mla"``) with the sandwich norms ("post_attn_norm",
    "post_mlp_norm") when ``cfg.post_norms`` is set, cross-attention
    ("xnorm", "xattn") under ``cross``, and a "moe" FFN under
    ``use_moe``, else an MLP of width ``d_ff`` (default ``cfg.d_ff``); an
    'M' layer with no FFN, an 'R' layer with "norm2" and "mlp" (never
    MoE)."""
    p = {"norm1": init_norm(cfg, cfg.d_model, device)}
    if kind == "M":
        p["ssm"] = ssm_mod.init_ssm(generator, cfg, device)
        return p
    if kind == "R":
        p["rg"] = rg_mod.init_rglru(generator, cfg, device)
        p["norm2"] = init_norm(cfg, cfg.d_model, device)
        p["mlp"] = init_mlp(generator, cfg, d_ff or cfg.d_ff, device)
        return p
    if kind not in ("G", "L"):
        raise ValueError(kind)
    p["attn"] = (attn.init_mla(generator, cfg, device)
                 if cfg.attn_kind == "mla"
                 else attn.init_attn(generator, cfg, device))
    if cfg.post_norms:
        p["post_attn_norm"] = init_norm(cfg, cfg.d_model, device)
    if cross:
        p["xnorm"] = init_norm(cfg, cfg.d_model, device)
        p["xattn"] = attn.init_cross_attn(generator, cfg, device)
    p["norm2"] = init_norm(cfg, cfg.d_model, device)
    if use_moe:
        p["moe"] = moe_mod.init_moe(generator, cfg, device)
    else:
        p["mlp"] = init_mlp(generator, cfg, d_ff or cfg.d_ff, device)
    if cfg.post_norms:
        p["post_mlp_norm"] = init_norm(cfg, cfg.d_model, device)
    return p


def init_params(generator, cfg: ModelConfig, device=None):
    """Random parameters from ``generator`` (a ``torch.Generator``, or
    an int seed), placed on ``device`` (None means CUDA).  Weights are
    drawn in f32 on the generator's device and stored in ``cfg.dtype``.
    An int seed seeds a CPU generator, leaf by leaf moved to ``device``,
    so one seed gives one model on every device; a generator on the card
    draws there (faster at full width, another model).  The draws are not
    the reference's ``jax.random`` draws; for parity, load the
    reference's parameters through ``bridge.params_from_numpy``.  Under a frontend
    the tree has "frontend", for an encoder-decoder "encoder" (its 'G'
    layers and final norm) and cross-attention in every decoder layer;
    under ``cfg.mtp_depth`` > 0 "mtp", DeepSeek's multi-token-prediction
    head (its 'G' layer takes a "moe" FFN under ``cfg.moe``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    n_prefix = layout(cfg)[0]
    moe = cfg.moe is not None
    p = {"embed": init_embed(generator, cfg, dev)}
    fe = init_frontend(generator, cfg, dev)
    if fe is not None:
        p["frontend"] = fe
    # the dense prefix ('G', width d_ff_dense), then the stack
    p["layers"] = [init_sublayer(generator, cfg, k, moe and i >= n_prefix
                                 and k in "GL",
                                 cfg.moe.d_ff_dense if moe and i < n_prefix
                                 else None, dev, cross=cfg.is_encdec)
                   for i, k in enumerate(layer_kinds(cfg))]
    p["final_norm"] = init_norm(cfg, cfg.d_model, dev)
    if cfg.is_encdec:
        p["encoder"] = {
            "layers": [init_sublayer(generator, cfg, "G", device=dev)
                       for _ in range(cfg.enc_layers)],
            "final_norm": init_norm(cfg, cfg.d_model, dev)}
    if cfg.mtp_depth > 0:
        p["mtp"] = {
            "proj": dense_init(generator, (2 * cfg.d_model, cfg.d_model),
                               dtype=cdtype(cfg), device=dev),
            "norm_h": init_norm(cfg, cfg.d_model, dev),
            "norm_e": init_norm(cfg, cfg.d_model, dev),
            "layer": init_sublayer(generator, cfg, "G", moe, device=dev),
            "final_norm": init_norm(cfg, cfg.d_model, dev)}
    return p


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _ffn(p, h, cfg: ModelConfig):
    """norm2 → (moe|mlp) → residual (+sandwich norm).  Returns (h, aux):
    a MoE FFN's load-balancing ``aux_loss`` (f32), 0.0 for an MLP.  A MoE
    FFN routes every row of h at once, padding rows included, as the
    reference's does; serving discards aux, as the reference's does."""
    x = apply_norm(p["norm2"], h, cfg)
    aux = 0.0
    if "moe" in p:
        y, metrics = moe_mod.apply_moe(p["moe"], x, cfg)
        aux = metrics["aux_loss"]
    else:
        y = apply_mlp(p["mlp"], x, cfg)
    if cfg.post_norms:
        y = apply_norm(p["post_mlp_norm"], y, cfg)
    return h + y, aux


def init_sublayer_cache(cfg: ModelConfig, kind: str, batch: int,
                        max_seq: int, kv_repeat: int, kv_mode: str = "exact",
                        kv_clusters: int = 512, kv_tail: int = 256,
                        kv_pool_blocks: int = 0, kv_block_size: int = 0,
                        device=None):
    """A layer's decode cache.  In ``kv_mode="clustered"`` only GQA 'G'
    layers take the clustered layout; an MLA layer keeps its exact latent
    cache whatever the mode, an 'L' layer its dense window ring, an 'M' /
    'R' layer its fixed-size recurrent state."""
    if kind == "M":
        return ssm_mod.init_cache_ssm(cfg, batch, device=device)
    if kind == "R":
        return rg_mod.init_cache_rglru(cfg, batch, device=device)
    if kind not in ("G", "L"):
        raise ValueError(kind)
    if cfg.attn_kind == "mla":
        return attn.init_cache_mla(cfg, batch, max_seq, device=device)
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
    """``{"layers": [leaf per layer]}`` (an encoder-decoder's cross
    caches come from :func:`prefill`); ``device`` None means CUDA.
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
    """Snapshot slot ``j``'s per-slot state from every snapshot-bearing
    leaf of an engine cache, as ``{"layers": [{key: (1, ...)} or None]}``:

    * a clustered leaf's summary rows (``attention.CLUSTERED_SLOT_KEYS``:
      centroids, counts, coverage frontier).  Tail payloads are not
      copied: in the paged engine they live in pool blocks that the
      prefix cache pins by ref count;
    * a recurrent leaf's whole fixed-size state ("conv" and "ssm" or
      "h"): for the recurrent family the state is the checkpoint, so
      prefix sharing and the swap carry it in this same snapshot.

    Any other leaf (an 'L' window ring) is None.  The rows are cloned, not
    viewed: slot ``j`` goes on absorbing and decoding after the snapshot,
    and a view would follow it."""
    def leaf_state(leaf):
        if "k_cents" in leaf:
            keys = attn.CLUSTERED_SLOT_KEYS
        elif layer_state.is_recurrent_leaf(leaf):
            keys = tuple(leaf)
        else:
            return None
        return {k: leaf[k][j:j + 1].clone() for k in keys}

    return {"layers": [leaf_state(leaf) for leaf in cache["layers"]]}


def restore_clustered_slot_state(cache, snap, j: int):
    """Write a ``clustered_slot_state`` snapshot into slot ``j`` of every
    snapshot-bearing leaf, in place (prefix-shared admission and the
    swap's resume: the reused prompt centroids and coverage frontier, and
    a recurrent layer's whole state, land in the fresh slot; ring blocks
    are adopted through the block table separately).  Returns the
    cache."""
    for leaf, s in zip(cache["layers"], snap["layers"]):
        if s is not None:
            for k, v in s.items():
                leaf[k][j:j + 1] = v.to(leaf[k].dtype)
    return cache


def sublayer_prefill(p, h, cfg: ModelConfig, kind: str, *, positions,
                     kv_repeat: int, max_seq: int, enc_kv=None,
                     recurrent_mode: str = "sequential",
                     recurrent_rows=None):
    """h (B, S, d) → (h, cache): a 'G' layer's exact k/v (an MLA layer's
    latent) zero-padded out to ``max_seq`` positions for decode, an 'L'
    layer's window ring, an 'M' / 'R' layer's final recurrent state.
    ``enc_kv`` (a decoder layer of an encoder-decoder): the layer's
    cross-attention keys and values, attended after self-attention.

    ``recurrent_mode`` picks how a recurrent layer computes its prefill:
    "sequential" (the default, what the serving engine runs) steps the
    one-token decode position by position, so the prefill gives the bits
    of feeding the prompt through the decode path, as chunked admission
    does; "scan" runs the parallel forms (chunked SSD, the log-depth
    linear scan), equal to stepping the decode only within rounding, and
    is kept for parity with the reference's default.  ``recurrent_rows``
    (sequential only) steps the decode at that many rows, the prompts'
    rows first and zero rows after them (:func:`_recurrent_prefill_
    sequential`)."""
    if kind in ("M", "R"):
        x = apply_norm(p["norm1"], h, cfg)
        if recurrent_mode == "sequential":
            init = (ssm_mod.init_cache_ssm if kind == "M"
                    else rg_mod.init_cache_rglru)
            y, cache = _recurrent_prefill_sequential(
                _recurrent_step_fn(p, cfg, kind), x,
                init(cfg, x.shape[0], device=x.device),
                rows=recurrent_rows)
        elif kind == "M":
            y, cache = ssm_mod.ssm_prefill(p["ssm"], x, cfg)
        else:
            y, cache = rg_mod.rglru_prefill(p["rg"], x, cfg)
        h = h + y
        return (h if kind == "M" else _ffn(p, h, cfg)[0]), cache
    x = apply_norm(p["norm1"], h, cfg)
    if cfg.attn_kind == "mla":
        y, cache = attn.mla_prefill(p["attn"], x, cfg, positions=positions,
                                    max_seq=max_seq)
    else:
        y, cache = attn.attn_prefill(p["attn"], x, cfg, layer_kind=kind,
                                     positions=positions,
                                     kv_repeat=kv_repeat)
        s = cache["k"].shape[1]
        if s < max_seq and kind == "G":
            pad = (0, 0, 0, 0, 0, max_seq - s)
            cache = {k: torch.nn.functional.pad(v, pad)
                     for k, v in cache.items()}
    if cfg.post_norms:
        y = apply_norm(p["post_attn_norm"], y, cfg)
    h = _cross(p, h + y, enc_kv, cfg)
    return _ffn(p, h, cfg)[0], cache


def _cross(p, h, enc_kv, cfg: ModelConfig):
    """The decoder layer's cross-attention residual over the encoder's
    ``enc_kv`` (None: no cross-attention)."""
    if enc_kv is None:
        return h
    x = apply_norm(p["xnorm"], h, cfg)
    return h + attn.cross_attn_apply(p["xattn"], x, enc_kv, cfg)


def sublayer_train(p, h, cfg: ModelConfig, kind: str, *, positions,
                   kv_repeat: int = 1, causal: bool = True, enc_kv=None):
    """Full-sequence forward of one layer without a cache.  Returns (h,
    aux), aux the MoE FFN's auxiliary loss (0.0 without one).  A 'G' / 'L'
    layer runs GQA (``causal=False`` is the encoder's bidirectional form)
    or MLA self-attention, then cross-attention over ``enc_kv`` when
    given, then its FFN; an 'M' layer the chunked SSD; an 'R' layer the
    RG-LRU's linear scan, then its MLP."""
    x = apply_norm(p["norm1"], h, cfg)
    if kind == "M":
        return h + ssm_mod.ssm_train(p["ssm"], x, cfg), 0.0
    if kind == "R":
        return _ffn(p, h + rg_mod.rglru_train(p["rg"], x, cfg), cfg)
    if kind not in ("G", "L"):
        raise ValueError(kind)
    if cfg.attn_kind == "mla":
        y = attn.mla_train(p["attn"], x, cfg, positions=positions)
    else:
        y = attn.attn_train(p["attn"], x, cfg, layer_kind=kind,
                            positions=positions, kv_repeat=kv_repeat,
                            causal=causal)
    if cfg.post_norms:
        y = apply_norm(p["post_attn_norm"], y, cfg)
    return _ffn(p, _cross(p, h + y, enc_kv, cfg), cfg)


def _pad_rows(rows, x, state):
    """x (B, ...) and every (B, ...) leaf of a recurrent state with zero
    rows appended up to ``rows`` (None or <= B: unchanged).

    The engine steps a recurrent column at its slot count (on a mesh, the
    rank's data shard's) whatever the launch (blocking admission's
    sequential prefill, the mixed and the one-token decode after the dense
    bucket shrinks, the packed rounds), because on the card some f32 ops of the step (the RG-LRU gate GEMM,
    the SSD state read-out's batched matmul, the gated norm's row mean)
    round a row differently at another row count.  At one row count a
    row's bits do not depend on the launch, so chunked == blocking and
    paged == dense hold on the card as on the CPU (ROADMAP Queue C 10)."""
    b = x.shape[0]
    if rows is None or rows <= b:
        return x, state
    pad = lambda v: torch.cat(                            # noqa: E731
        [v, v.new_zeros((rows - b,) + v.shape[1:])])
    return pad(x), {k: pad(v) for k, v in state.items()}


def _recurrent_prefill_sequential(step_fn, x, cache, rows=None):
    """Prefill a recurrent layer by stepping its one-token decode.

    x (B, S, d) normed input; ``step_fn(xt (B, 1, d), cache) -> (y,
    cache)`` is the layer's decode recurrence.  Returns (y (B, S, d),
    cache): the per-step ops of feeding the S positions through the
    decode path one at a time, which the engine's mixed launch does.

    ``rows`` > B steps the decode at ``rows`` rows (:func:`_pad_rows`);
    only the first B rows of the outputs and the state are returned, so
    the padding reaches no slot."""
    b = x.shape[0]
    x, cache = _pad_rows(rows, x, cache)
    ys = []
    for t in range(x.shape[1]):
        y, cache = step_fn(x[:, t:t + 1], cache)
        ys.append(y[:b, 0])
    return torch.stack(ys, dim=1), {k: v[:b] for k, v in cache.items()}


def _add_positions(h, cfg: ModelConfig, offset=0):
    """h (B, S, d) plus absolute sinusoidal positions from ``offset`` (a
    scalar, or (B,) per slot) under ``pos_kind="abs_sinusoidal"``; RoPE
    models rotate q and k instead, so h is returned as it is."""
    if cfg.pos_kind != "abs_sinusoidal":
        return h
    offset = per_slot(offset, h.shape[0], h.device)
    return h + sinusoidal_pos(h.shape[1], cfg.d_model, offset).to(h.dtype)


def _embed_inputs(params, cfg: ModelConfig, tokens, frontend_embeds):
    """Token embeddings, after the projected ``frontend_embeds`` (B, F,
    d_model) when given, with positions from 0."""
    h = embed_tokens(params["embed"], tokens, cfg)
    if frontend_embeds is not None:
        fe = apply_frontend(params["frontend"], frontend_embeds, cfg)
        h = torch.cat([fe, h], dim=1)
    return _add_positions(h, cfg)


def encode(params, cfg: ModelConfig, enc_embeds):
    """The encoder stack over the frontend stub's frame embeddings (B,
    S_enc, d_model): projected, positions added, then the bidirectional
    'G' layers and the encoder's final norm."""
    enc = params["encoder"]
    h = _add_positions(apply_frontend(params["frontend"], enc_embeds, cfg),
                       cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    for lp in enc["layers"]:
        h, _ = sublayer_train(lp, h, cfg, "G", positions=positions,
                              causal=False)
    return apply_norm(enc["final_norm"], h, cfg)


def _layer_enc_kv(lp, enc_out, cfg: ModelConfig):
    if enc_out is None or "xattn" not in lp:
        return None
    return attn.cross_kv(lp["xattn"], enc_out, cfg)


# ---------------------------------------------------------------------------
# Training: trunk forward, chunked cross-entropy, loss
# ---------------------------------------------------------------------------


def forward_trunk(params, cfg: ModelConfig, tokens, *, frontend_embeds=None,
                  enc_out=None, kv_repeat: int = 1, remat: bool = True,
                  positions=None):
    """Full-sequence training forward of tokens (B, S) (after the
    projected ``frontend_embeds`` when given; ``enc_out``: an
    encoder-decoder's encoder output, which every decoder layer
    cross-attends).  Returns (h (B, S', d) after the final norm, aux_loss
    f32, the MoE layers' auxiliary losses summed in stack order).

    The reference's layout: the dense prefix, then each repeat of the
    layer pattern, then the tail.  Under ``remat``, with autograd
    recording, each repeat runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` over its scan group): the backward
    pass keeps only the hidden state between repeats and recomputes their
    interior."""
    h = _embed_inputs(params, cfg, tokens, frontend_embeds)
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    layers, kinds = params["layers"], layer_kinds(cfg)

    def run(lo, hi, h, aux):
        for lp, kind in zip(layers[lo:hi], kinds[lo:hi]):
            h, a = sublayer_train(lp, h, cfg, kind, positions=positions,
                                  kv_repeat=kv_repeat,
                                  enc_kv=_layer_enc_kv(lp, enc_out, cfg))
            aux = aux + a
        return h, aux

    n_prefix, n_rep, _ = layout(cfg)
    plen = len(cfg.layer_pattern)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h, aux = run(0, n_prefix, h, aux)
    for r in range(n_rep):
        lo = n_prefix + r * plen
        if remat and torch.is_grad_enabled():
            h, aux = checkpoint(run, lo, lo + plen, h, aux,
                                use_reentrant=False)
        else:
            h, aux = run(lo, lo + plen, h, aux)
    h, aux = run(n_prefix + n_rep * plen, len(layers), h, aux)
    return apply_norm(params["final_norm"], h, cfg), aux


def _ce_chunk(embed, cfg: ModelConfig, h, labels):
    """Summed negative log-likelihood of one chunk: h (B, C, d), labels
    (B, C), label -1 masked."""
    logits = lm_logits(embed, h, cfg)                    # (B, C, V) f32
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    return ((logz - gold) * valid).sum()


def chunked_ce(params, cfg: ModelConfig, h, labels, chunk: int = 256):
    """h (B, S, d), labels (B, S) int (-1 = masked) → (sum_nll, n_valid),
    both f32.  Frontend positions (if any) must already be stripped from
    h.  S is padded to a multiple of ``chunk`` (masked labels), and the
    logits exist one (B, chunk, V) f32 chunk at a time; with autograd
    recording each chunk runs under ``torch.utils.checkpoint``, so the
    backward pass recomputes its logits instead of keeping all of them."""
    s = h.shape[1]
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    nv = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s + pad, chunk):
        hh, ll = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_ce_chunk, params["embed"], cfg, hh, ll,
                              use_reentrant=False)
        else:
            part = _ce_chunk(params["embed"], cfg, hh, ll)
        nll = nll + part
        nv = nv + (ll >= 0).to(torch.float32).sum()
    return nll, nv


def train_loss(params, cfg: ModelConfig, batch, *, kv_repeat: int = 1,
               remat: bool = True, loss_chunk: int = 256):
    """batch: tensors {"tokens" (B, St), "labels" (B, St), and
    "frontend_embeds" (B, F, d) under a frontend or "enc_embeds" (B,
    S_enc, d) for an encoder-decoder}.  Returns (loss, metrics): the mean
    next-token NLL over unmasked labels, plus 0.3 x the MTP loss under
    ``cfg.mtp_depth``, plus the MoE auxiliary loss; metrics {"nll",
    "aux_loss", "n_valid"} (and "mtp_loss"), the reference's."""
    enc_out = None
    if cfg.is_encdec:
        enc_out = encode(params, cfg, batch["enc_embeds"])
        h, aux = forward_trunk(params, cfg, batch["tokens"], enc_out=enc_out,
                               kv_repeat=kv_repeat, remat=remat)
    else:
        h, aux = forward_trunk(params, cfg, batch["tokens"],
                               frontend_embeds=batch.get("frontend_embeds"),
                               kv_repeat=kv_repeat, remat=remat)
    if cfg.n_frontend_tokens and not cfg.is_encdec:
        h = h[:, cfg.n_frontend_tokens:]
    nll, nv = chunked_ce(params, cfg, h, batch["labels"], loss_chunk)
    loss = nll / torch.clamp(nv, min=1.0)
    metrics = {"nll": loss, "aux_loss": aux, "n_valid": nv}
    if cfg.mtp_depth > 0:
        mtp_loss = _mtp_loss(params, cfg, h, batch, kv_repeat, loss_chunk)
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    return loss + aux, metrics


def _mtp_loss(params, cfg: ModelConfig, h, batch, kv_repeat: int,
              loss_chunk: int):
    """DeepSeek MTP depth 1: position t predicts token t + 2 from (h_t,
    emb(token_{t+1})) through the "mtp" module's projection and 'G'
    layer; the mean NLL over labels[:, 1:]."""
    mtp = params["mtp"]
    tokens, labels = batch["tokens"], batch["labels"]
    h_in = apply_norm(mtp["norm_h"], h[:, :-1], cfg)
    e_in = apply_norm(mtp["norm_e"],
                      embed_tokens(params["embed"], tokens[:, 1:], cfg), cfg)
    x = torch.cat([h_in, e_in], dim=-1) @ mtp["proj"]
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = sublayer_train(mtp["layer"], x, cfg, "G", positions=positions,
                          kv_repeat=kv_repeat)
    x = apply_norm(mtp["final_norm"], x, cfg)
    nll, nv = chunked_ce(params, cfg, x, labels[:, 1:], loss_chunk)
    return nll / torch.clamp(nv, min=1.0)


def prefill(params, cfg: ModelConfig, tokens, *, max_seq: int,
            frontend_embeds=None, enc_embeds=None, kv_repeat: int = 1,
            last_pos=None, recurrent_mode: str = "sequential",
            recurrent_rows=None):
    """Full-sequence prefill of tokens (B, S).  Returns (logits (B, V) f32
    of position ``last_pos`` (default the last), cache): with prompts
    right-padded to a bucket, the causal mask keeps position last_pos
    exact whatever the padding behind it.  The cache is exact,
    ``{"layers": [leaf]}``: {"k", "v"} (B, max(S, max_seq), Hkv, Dh) for
    a 'G' layer, an MLA layer's latent {"ckv", "kpe"} likewise, the (B,
    window, Hkv, Dh) ring for an 'L' layer, the final recurrent state for
    an 'M' / 'R' layer (``recurrent_mode`` and ``recurrent_rows``: see
    :func:`sublayer_prefill`; the engine passes its slot count).

    ``frontend_embeds`` (B, F, d_model): a frontend's patch embeddings,
    prepended to the tokens, so the cache and the positions count them
    (the last position is the last token's).  An encoder-decoder needs
    ``enc_embeds`` (B, S_enc, d_model), the frames its encoder reads; its
    cache also holds ``"cross"``, each decoder layer's encoder keys and
    values."""
    enc_out = None
    if cfg.is_encdec:
        if enc_embeds is None:
            raise ValueError(
                f"model '{cfg.name}' is an encoder-decoder: prefill needs "
                "enc_embeds (B, S_enc, d_model), the frame embeddings its "
                "encoder reads")
        enc_out = encode(params, cfg, enc_embeds)
    h = _embed_inputs(params, cfg, tokens, frontend_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    layers, cross = [], []
    for lp, kind in zip(params["layers"], layer_kinds(cfg)):
        ekv = _layer_enc_kv(lp, enc_out, cfg)
        h, c = sublayer_prefill(lp, h, cfg, kind, positions=positions,
                                kv_repeat=kv_repeat, max_seq=max_seq,
                                enc_kv=ekv, recurrent_mode=recurrent_mode,
                                recurrent_rows=recurrent_rows)
        layers.append(c)
        cross.append(ekv)
    h = apply_norm(params["final_norm"], h, cfg)
    h_last = h[:, -1:] if last_pos is None else h[:, last_pos:last_pos + 1]
    cache = {"layers": layers}
    if cfg.is_encdec:
        cache["cross"] = cross
    return lm_logits(params["embed"], h_last, cfg)[:, 0], cache


def _recurrent_step_fn(p, cfg: ModelConfig, kind: str):
    """The one-token decode of an 'M' / 'R' layer as ``step(xt, state) ->
    (y, state')``."""
    if kind == "M":
        return lambda xt, c: ssm_mod.ssm_decode(p["ssm"], xt, cfg, c)
    return lambda xt, c: rg_mod.rglru_decode(p["rg"], xt, cfg, c)


def sublayer_decode(p, h, cfg: ModelConfig, kind: str, cache, t, *,
                    kv_repeat: int, chunk_len=None, recurrent_rows=None,
                    enc_kv=None):
    """h (B, 1, d), or (B, L, d) in mixed mode with per-slot
    ``chunk_len``.  Ring-family layers stream the chunk into their KV at
    exact positions (their tensors written in place); an MLA layer
    decodes one token at a time over its latent (a mixed chunk raises); an
    'M' / 'R' layer advances its state column by column with per-slot
    masking (:func:`_recurrent_mixed_advance`), at ``recurrent_rows`` rows
    when B is fewer (:func:`_pad_rows`), and the leaf's entries are
    replaced by the new state.  ``enc_kv``: a decoder layer's
    cross-attention keys and values.  Returns (h, cache)."""
    if kind in ("M", "R"):
        x = apply_norm(p["norm1"], h, cfg)
        b = x.shape[0]
        step = _recurrent_step_fn(p, cfg, kind)
        xs, st = _pad_rows(recurrent_rows, x, cache)
        if chunk_len is None:
            y, new = step(xs, st)
        else:
            cl = per_slot(chunk_len, b, x.device)
            if xs.shape[0] > b:                 # padded rows take no token
                cl = torch.cat([cl, cl.new_zeros(xs.shape[0] - b)])
            y, new = _recurrent_mixed_advance(step, xs, st, cl)
        cache.update({k: v[:b] for k, v in new.items()})
        h = h + y[:b]
        return (h if kind == "M" else _ffn(p, h, cfg)[0]), cache
    x = apply_norm(p["norm1"], h, cfg)
    if cfg.attn_kind == "mla":
        if chunk_len is not None:
            raise NotImplementedError(
                "mixed-mode chunked decode is not wired for MLA latent "
                "caches yet")
        y, cache = attn.mla_decode(p["attn"], x, cfg, cache=cache, t=t)
    else:
        y, cache = attn.attn_decode(p["attn"], x, cfg, layer_kind=kind,
                                    cache=cache, t=t, kv_repeat=kv_repeat,
                                    chunk_len=chunk_len)
    if cfg.post_norms:
        y = apply_norm(p["post_attn_norm"], y, cfg)
    h = _cross(p, h + y, enc_kv, cfg)
    return _ffn(p, h, cfg)[0], cache


def _recurrent_mixed_advance(step_fn, x, cache, chunk_len):
    """Advance recurrent state through a mixed prefill + decode launch.

    x (B, L, d) normed chunk columns; chunk_len (B,) valid columns per
    slot (decode slots carry 1).  Steps the L columns through the layer's
    one-token decode ``step_fn`` and keeps each slot's stepped state only
    while its chunk lasts (``torch.where`` against the previous state), so
    every slot advances by exactly its own tokens, in order, with the
    per-step ops of the blocking decode path.  Columns at or after
    chunk_len give outputs the caller's last-valid-row gather never
    reads.  Returns (y (B, L, d), new state); ``cache`` is not written."""
    b, L, _ = x.shape
    cl = per_slot(chunk_len, b, x.device)
    state = dict(cache)
    ys = []
    for i in range(L):
        y, new = step_fn(x[:, i:i + 1], state)
        keep = i < cl                                    # (B,)
        state = {k: torch.where(keep.reshape((-1,) + (1,) * (v.dim() - 1)),
                                v, state[k])
                 for k, v in new.items()}
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1), state


def decode_step(params, cfg: ModelConfig, cache, tokens, t, *,
                kv_repeat: int = 1, chunk_len=None, recurrent_rows=None):
    """One engine step.  tokens (B, 1) with ``t`` scalar or (B,) (each
    slot's position), or mixed mode: tokens (B, L) with per-slot
    ``chunk_len`` (B,) valid columns and ``t`` (B,) the cache length before
    the step.  Returns (logits (B, V) f32, cache) — each slot's LAST valid
    row — and writes the new keys and values into ``cache`` in place.
    ``recurrent_rows``: the rows an 'M' / 'R' layer steps at (the engine
    passes its slot count; see :func:`_pad_rows`).  Sinusoidal positions
    are added at ``t``; an encoder-decoder's cross caches are read, never
    written (a mixed chunk raises: it is decoder-only)."""
    if chunk_len is not None and cfg.is_encdec:
        raise NotImplementedError("mixed-mode chunked decode is "
                                  "decoder-only")
    h = embed_tokens(params["embed"], tokens, cfg)
    h = _add_positions(h, cfg, t)
    kinds = layer_kinds(cfg)
    cross = cache.get("cross") or [None] * len(kinds)
    for lp, kind, c, ekv in zip(params["layers"], kinds, cache["layers"],
                                cross):
        h, _ = sublayer_decode(lp, h, cfg, kind, c, t, kv_repeat=kv_repeat,
                               chunk_len=chunk_len,
                               recurrent_rows=recurrent_rows, enc_kv=ekv)
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
    return _ffn(p, h, cfg)[0], cache


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
    return _ffn(p, h, cfg)[0], cache


def recurrent_round_plan(row_slot, row_pos, row_cidx, width: int):
    """The rounds of a packed step's recurrent advance, planned on the
    host from the numpy rows the engine packs: (idx (2, n_real) int32,
    sizes), idx's first row the real rows (row_pos >= 0) sorted by chunk
    index, its second their slots, and sizes[jj] the count of rows with
    row_cidx == jj < ``width``.  A slot has at most one row in a round,
    so each round's scatter is conflict-free."""
    real = np.nonzero(row_pos >= 0)[0]
    order = real[np.argsort(row_cidx[real], kind="stable")]
    sizes = np.bincount(row_cidx[real], minlength=width).tolist()
    return np.stack([order, row_slot[order]]).astype(np.int32), sizes


def recurrent_rounds(idx, sizes):
    """[(rows, slots)] long tensors of each non-empty round, split from
    :func:`recurrent_round_plan`'s idx (on the rows' device)."""
    rows, slots = idx.long()
    return [(r, sl) for r, sl in zip(rows.split(sizes), slots.split(sizes))
            if len(r)]


def _sublayer_decode_recurrent_packed(p, h, cfg: ModelConfig, cache, kind,
                                      *, rounds):
    """One recurrent sublayer ('M' / 'R') over packed rows.

    Recurrent state is slot-indexed and fixed-size, and advances one token
    at a time in position order.  A slot's rows within a packed step carry
    distinct chunk indices, so the rounds of :func:`recurrent_rounds`
    sequence them: round jj gathers the state of its rows' slots, steps
    those rows through the one-token decode, and scatters the new state
    back to the same slots, in place.  Only a round's own rows are stepped
    and written (the reference steps every row and drops the writes of the
    others), at the cache's slot count (:func:`_pad_rows`); padding rows
    (row_pos < 0) are in no round."""
    x = apply_norm(p["norm1"], h, cfg)                   # (N, 1, d)
    step = _recurrent_step_fn(p, cfg, kind)
    n_slots = next(iter(cache.values())).shape[0]
    y = torch.zeros_like(h)
    for rows, slots in rounds:
        m = rows.shape[0]
        y_j, st_new = step(*_pad_rows(n_slots, x[rows],
                                      {k: v[slots] for k, v in cache.items()}))
        for k, v in st_new.items():
            cache[k][slots] = v[:m].to(cache[k].dtype)
        y[rows] = y_j[:m].to(y.dtype)
    h = h + y
    return (h if kind == "M" else _ffn(p, h, cfg)[0]), cache


def decode_step_packed(params, cfg: ModelConfig, cache, tokens, row_slot,
                       row_pos, row_tw, row_cidx, block_tables, *,
                       block_size: int, width: int = 1, kv_repeat: int = 1,
                       row_group=None, rounds=None):
    """Packed ragged engine step for the paged clustered-KV path.

    Each real (slot, position) pair is one row: tokens (N,), row_slot (N,)
    slot, row_pos (N,) absolute position (−1: padding row), row_tw (N,)
    the slot's ring watermark t + chunk_len this step, row_cidx (N,) the
    row's index within its admission chunk and ``width`` the step's
    longest chunk (both sequence the 'L' layers' ring writes and the 'M'
    / 'R' layers' state advance), block_tables (B, T) global tail-block
    ids, row_group (N,) the attention kernel's row groups
    (``kernels.paged_clustered_decode.group_rows``; None: one row each),
    ``rounds`` the recurrent layers' rounds (:func:`recurrent_rounds`,
    planned on the host from the rows; None: planned here from a host
    copy of the rows).  Returns (logits (N, V) f32, cache), every row's
    next-token distribution, and writes the new keys and values into the
    cache's pools and the new recurrent state into its slots, in place.
    MLP, norms and embeddings are row-wise, so rows stand in for the
    batch exactly."""
    kinds = layer_kinds(cfg)
    if rounds is None and set(kinds) & set("MR"):
        idx, sizes = recurrent_round_plan(
            *(a.cpu().numpy() for a in (row_slot, row_pos, row_cidx)), width)
        rounds = recurrent_rounds(torch.from_numpy(idx).to(row_slot.device),
                                  sizes)
    tokens = torch.where(row_pos >= 0, tokens, torch.zeros_like(tokens))
    h = _add_positions(embed_tokens(params["embed"], tokens[:, None], cfg),
                       cfg, row_pos)                          # (N, 1, d)
    for lp, kind, c in zip(params["layers"], kinds, cache["layers"]):
        if kind in ("M", "R"):
            h, _ = _sublayer_decode_recurrent_packed(lp, h, cfg, c, kind,
                                                     rounds=rounds)
        elif kind == "L":
            h, _ = _sublayer_decode_window_packed(
                lp, h, cfg, c, row_slot=row_slot, row_pos=row_pos,
                row_cidx=row_cidx, width=width, kv_repeat=kv_repeat)
        else:
            h, _ = _sublayer_decode_packed(
                lp, h, cfg, c, row_slot=row_slot, row_pos=row_pos,
                row_tw=row_tw, block_tables=block_tables,
                block_size=block_size, kv_repeat=kv_repeat,
                row_group=row_group)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = lm_logits(params["embed"], h, cfg)[:, 0]
    return logits, cache
