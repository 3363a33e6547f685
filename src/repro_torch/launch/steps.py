"""Step builders and abstract input specs (port of the single-device
part of ``repro.launch.steps``).

The training step is one autograd backward of the model's loss, then
AdamW; with ``microbatch`` > 1 the gradients of the microbatches are
summed in f32 first.  The serving steps are the plain prefill and decode
closures.  ``batch_struct`` / ``cache_struct`` give a cell's inputs and
decode cache as tensors on the ``meta`` device: shapes and dtypes,
nothing allocated.  The mesh-only helpers of the reference (``pick_*``,
``batch_pspec``, ``cache_pspecs``, ``lower_step``) wait for training on
a mesh (ROADMAP Queue A item 10d).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import tree as tree_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.models.layers import cdtype
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """The reference's training and serving-cell options; its sharding
    ones (``fsdp``, ``seq_shard``, ``mla_seq_shard``) come with item
    10."""
    kv_repeat: int = 1
    remat: bool = True
    loss_chunk: int = 256
    microbatch: int = 1
    kv_mode: str = "exact"        # "clustered" = paper's KV memory manager;
                                  # "int8" = quantized exact cache
    kv_clusters: int = 512
    kv_tail: int = 256


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``init_params`` (the MTP module included), counted on
    the meta device: nothing is allocated."""
    p = tfm.init_params(torch.Generator(), cfg, device="meta")
    return sum(t.numel() for t in tree_mod.leaves(p))


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k + shared experts only)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    _, n_rep, tail = tfm.layout(cfg)
    n_moe_layers = n_rep * len(cfg.layer_pattern) + len(tail)
    per_expert = 3 * cfg.d_model * m.d_expert
    return total - n_moe_layers * (m.n_routed - m.top_k) * per_expert


def batch_to(batch: dict, device) -> dict:
    """A numpy (or tensor) batch as tensors on ``device``."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
                ).to(device) for k, v in batch.items()}


def _loss_and_grads(loss_fn, params, batch):
    """(loss, metrics, gradient leaves in ``tree.leaves(params)`` order,
    zeros where the loss does not reach a leaf, as JAX's are): one
    backward pass."""
    leaves = tree_mod.leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), {k: (v.detach() if torch.is_tensor(v) else v)
                           for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, aw: adamw.AdamWConfig,
                    opts: StepOptions = StepOptions(), grad_transform=None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the batch (numpy or tensors) moves to the parameters' device, one
    backward pass gives the gradients (the parameters are made to require
    grad), and ``adamw.update`` writes the parameters and the moments in
    place.  metrics: the loss's ("nll", "aux_loss", "n_valid", and
    "mtp_loss" under MTP), "loss", "grad_norm" and "lr"."""
    def loss_fn(params, batch):
        return tfm.train_loss(params, cfg, batch, kv_repeat=opts.kv_repeat,
                              remat=opts.remat, loss_chunk=opts.loss_chunk)

    def step(params, opt_state, batch):
        batch = batch_to(batch, tree_mod.leaves(params)[0].device)
        if opts.microbatch > 1:
            grads, (loss, metrics) = _accum_grads(loss_fn, params, batch,
                                                  opts.microbatch)
        else:
            loss, metrics, flat = _loss_and_grads(loss_fn, params, batch)
            grads = tree_mod.unflatten(params, flat)
            del flat
        params, opt_state, om = adamw.update(grads, opt_state, params, aw,
                                             grad_transform=grad_transform)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return step


def _accum_grads(loss_fn, params, batch, n_micro: int):
    """Gradients of ``n_micro`` equal slices of the batch, summed in f32
    and averaged; (grads, (mean loss, the last microbatch's metrics))."""
    micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
             for k, v in batch.items()}
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in tree_mod.leaves(params)]
    lsum = torch.zeros((), dtype=torch.float32, device=gsum[0].device)
    metrics = None
    for i in range(n_micro):
        loss, metrics, flat = _loss_and_grads(
            loss_fn, params, {k: v[i] for k, v in micro.items()})
        for acc, g in zip(gsum, flat):
            acc.add_(g.to(torch.float32))
        lsum = lsum + loss
    grads = tree_mod.unflatten(params, [g / n_micro for g in gsum])
    return grads, (lsum / n_micro, metrics)


# ---------------------------------------------------------------------------
# Input specs (abstract: tensors on the meta device)
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """The step inputs of ``cell`` as meta tensors, in the reference's
    shapes and dtypes (tokens and labels int32, embeddings bf16; a decode
    step's ``t`` a 0-d int32)."""
    gb, s = cell.global_batch, cell.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if cell.step == "decode":
        # one new token against a seq_len cache
        return {"tokens": _meta((gb, 1), i32), "t": _meta((), i32)}
    out = {}
    if cfg.is_encdec:
        se = s // 2
        out["enc_embeds"] = _meta((gb, se, cfg.d_model), bf16)
        st = s - se
    else:
        st = s - cfg.n_frontend_tokens
        if cfg.n_frontend_tokens:
            out["frontend_embeds"] = _meta(
                (gb, cfg.n_frontend_tokens, cfg.d_model), bf16)
    out["tokens"] = _meta((gb, st), i32)
    if cell.step == "train":
        out["labels"] = _meta((gb, st), i32)
    return out


def cache_struct(cfg: ModelConfig, cell: ShapeCell,
                 opts: StepOptions = StepOptions()):
    """The decode cache of ``cell`` on the meta device (no allocation):
    ``init_cache`` in ``opts.kv_mode``.  An encoder-decoder's is the cache
    its prefill leaves over frames of half the cell's length, as the
    reference's is: exact self-attention over those positions plus each
    decoder layer's ``"cross"`` keys and values, projected here from a meta
    encoder output instead of running the encoder."""
    if cfg.is_encdec:
        se = cell.seq_len // 2
        params = tfm.init_params(torch.Generator(), cfg, device="meta")
        enc_out = _meta((cell.global_batch, se, cfg.d_model), cdtype(cfg))
        cache = tfm.init_cache(cfg, cell.global_batch, se, opts.kv_repeat,
                               device="meta")
        cache["cross"] = [tfm._layer_enc_kv(lp, enc_out, cfg)
                          for lp in params["layers"]]
        return cache
    return tfm.init_cache(cfg, cell.global_batch, cell.seq_len,
                          opts.kv_repeat, kv_mode=opts.kv_mode,
                          kv_clusters=opts.kv_clusters, kv_tail=opts.kv_tail,
                          device="meta")


def cache_bytes(cache) -> int:
    """Bytes of every leaf of a cache (``lower_step``'s
    ``info["cache_bytes"]`` in the reference)."""
    return sum(t.numel() * t.element_size() for t in tree_mod.leaves(cache))


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, cell: ShapeCell,
                      opts: StepOptions = StepOptions()):
    """``step(params, batch) -> (logits (B, V) f32, cache)``: the cell's
    prefill (an encoder-decoder's cache holds half the cell's length, its
    encoder frames the other half).  Recurrent layers take the parallel
    forms (``recurrent_mode="scan"``), the reference's prefill default;
    the serving engine steps them instead.  The batch (numpy or tensors)
    moves to the parameters' device."""
    max_seq = cell.seq_len // 2 if cfg.is_encdec else cell.seq_len

    def step(params, batch):
        batch = batch_to(batch, tree_mod.leaves(params)[0].device)
        with torch.no_grad():
            return tfm.prefill(params, cfg, batch["tokens"], max_seq=max_seq,
                               frontend_embeds=batch.get("frontend_embeds"),
                               enc_embeds=batch.get("enc_embeds"),
                               kv_repeat=opts.kv_repeat,
                               recurrent_mode="scan")

    return step


def make_decode_step(cfg: ModelConfig, opts: StepOptions = StepOptions()):
    """``step(params, cache, batch) -> (logits (B, V) f32, cache)``: one
    token a row at position ``batch["t"]``; the cache is written in
    place."""
    def step(params, cache, batch):
        batch = batch_to(batch, tree_mod.leaves(params)[0].device)
        with torch.no_grad():
            return tfm.decode_step(params, cfg, cache, batch["tokens"],
                                   batch["t"], kv_repeat=opts.kv_repeat)

    return step
