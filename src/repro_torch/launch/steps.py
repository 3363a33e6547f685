"""Step builders, abstract input specs and the mesh step (port of
``repro.launch.steps``).

The training step is one autograd backward of the model's loss, then
AdamW; with ``microbatch`` > 1 the gradients of the microbatches are
summed in f32 first.  The serving steps are the plain prefill and decode
closures.  ``batch_struct`` / ``cache_struct`` give a cell's inputs and
decode cache as tensors on the ``meta`` device: shapes and dtypes,
nothing allocated.

On a mesh (a ``DeviceMesh`` of one rank a process, or a
``launch.mesh.StandInMesh`` on ``meta``) the reference's helpers pick the
options (``pick_kv_repeat``, ``pick_microbatch``, ``pick_options``) and
the partition specs (``batch_pspec``, ``cache_pspecs``), and
:func:`lower_step` gives one rank's step of a cell, the twin of the
reference's pjit lowering.  Its design: the parameters and the AdamW
moments are stored as this rank's blocks (``rules.place_train_state``),
the step gathers each leaf whole (``rules.GatherLeaf``) and runs the
unchanged ``transformer.train_loss`` on its rows of the global batch
(``batch_pspec``'s axes); the gather's backward sums the gradients over
those axes and keeps the rank's block, and AdamW updates the blocks in
place.  The model axis shards storage only: compute is split over rows,
where the reference's partitioner also splits it over ``model`` (the
numbers are the same function's).  A serving cell's mesh step (the dry
run's count) is built the same way: its parameters and cache gathered
from the rank's blocks, its rows computed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import grad_compress
from repro_torch.core import tree as tree_mod
from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.models.layers import cdtype
from repro_torch.optim import adamw
from repro_torch.sharding import rules as shard_rules


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """The reference's step options, its defaults."""
    kv_repeat: int = 1
    fsdp: bool = False
    seq_shard: bool = False
    remat: bool = True
    loss_chunk: int = 256
    microbatch: int = 1
    kv_mode: str = "exact"        # "clustered" = paper's KV memory manager;
                                  # "int8" = quantized exact cache
    kv_clusters: int = 512
    kv_tail: int = 256
    mla_seq_shard: bool = False   # shard the MLA latent cache's seq axis
                                  # over the model axis (headless cache)


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


def pick_kv_repeat(cfg: ModelConfig, mesh) -> int:
    """KV heads repeated so that they cover the model axis, where that
    divides the query heads (MQA and MLA stay unrepeated)."""
    if cfg.attn_kind == "mla" or cfg.attention_free:
        return 1
    ms = mesh_sizes(mesh)["model"]
    kv = cfg.n_kv_heads
    if kv <= 1 or kv >= ms:
        return 1  # MQA stays un-replicated (cache size), big kv already fine
    r = ms // kv
    if kv * r == ms and cfg.n_heads % (kv * r) == 0:
        return r
    return 1


def pick_microbatch(cfg: ModelConfig, mesh, cell: ShapeCell,
                    budget_bytes: float = 9e9) -> int:
    """Smallest power-of-two microbatch count keeping the per-rank
    activation estimate under budget: the layer-boundary hidden per layer
    (remat recomputes the interior), plus the f32 logits chunk of the
    chunked CE (the reference's model)."""
    if cell.step != "train":
        return 1
    sizes = mesh_sizes(mesh)
    data_size = sizes.get("data", 1) * sizes.get("pod", 1)
    local_b = max(cell.global_batch // data_size, 1)
    s = cell.seq_len
    m = 1
    while m < local_b:
        b_eff = local_b / m
        acts = cfg.n_layers * b_eff * s * cfg.d_model * 2 * 2.5
        logits = b_eff * 256 * cfg.padded_vocab * 4 * 2
        if acts + logits < budget_bytes:
            break
        m *= 2
    return m


def pick_options(cfg: ModelConfig, mesh, cell: ShapeCell,
                 **overrides) -> StepOptions:
    """The reference's options for ``cell`` on ``mesh``: kv repeat over
    the model axis, FSDP for a train step above 2e10 parameters, the
    decode cache's sequence sharded when the batch cannot cover the data
    axes (and an MLA decode cache's over ``model``), the microbatch."""
    sizes = mesh_sizes(mesh)
    data_size = sizes.get("data", 1) * sizes.get("pod", 1)
    opts = StepOptions(
        kv_repeat=pick_kv_repeat(cfg, mesh),
        # ZeRO/FSDP pays off for optimizer+master state; serving steps keep
        # weights TP-resident (re-gathering them per token is pure waste)
        fsdp=param_count(cfg) > 2e10 and cell.step == "train",
        seq_shard=(cell.step == "decode"
                   and cell.global_batch < data_size),
        mla_seq_shard=(cfg.attn_kind == "mla" and cell.step == "decode"),
        microbatch=pick_microbatch(cfg, mesh, cell),
    )
    return dataclasses.replace(opts, **overrides)


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
        params, opt_state, om = adamw.update(
            grads, opt_state, params, aw,
            **transform_args(grad_transform, params, cfg))
        return params, opt_state, dict(metrics, loss=loss, **om)

    return step


def transform_args(grad_transform, params, cfg: ModelConfig,
                   whole=None) -> dict:
    """``adamw.update``'s transform arguments: a transform marked
    ``reference_leaves`` (``grad_compress.make_grad_transform``'s) acts on
    the reference's leaves (``bridge.stack_groups``: a scan-stacked
    group's per-layer leaves stacked); any other on each leaf.  ``whole``
    (a mesh step's): (gather, take) functions of a leaf's index that give
    the whole clipped leaf from its block, and the block back."""
    if grad_transform is None:
        return {}
    if whole is None and not getattr(grad_transform, "reference_leaves",
                                     False):
        return {"grad_transform": grad_transform}
    groups = (bridge.stack_groups(params, cfg)
              if getattr(grad_transform, "reference_leaves", False)
              else [[i] for i in range(len(tree_mod.leaves(params)))])
    gather, take = whole or (lambda _i, g: g, lambda _i, g: g)

    def fn(group, gs):
        out = grad_compress.stacked(
            grad_transform, [gather(i, g) for i, g in zip(group, gs)])
        return [take(i, g) for i, g in zip(group, out)]

    return {"grad_transform": fn, "groups": groups}


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


# ---------------------------------------------------------------------------
# Partition specs of the step inputs (``sharding.rules.P`` tuples)
# ---------------------------------------------------------------------------

P = shard_rules.P


def batch_pspec(cfg: ModelConfig, cell: ShapeCell, rules) -> dict:
    """The batch's specs: rows over the ``batch`` axes where the global
    batch divides them (else a prefix of them, else replicated)."""
    b = rules.axes_for("batch", cell.global_batch)
    if cell.step in ("train", "prefill"):
        spec = {"tokens": P(b, None)}
        if cell.step == "train":
            spec["labels"] = P(b, None)
        if cfg.is_encdec:
            spec["enc_embeds"] = P(b, None, None)
        elif cfg.n_frontend_tokens:
            spec["frontend_embeds"] = P(b, None, None)
        return spec
    return {"tokens": P(b, None), "t": P()}


def _cache_leaf_spec(path: str, shape, rules):
    b = rules.axes_for("batch", shape[0]) if len(shape) else None
    if path.endswith("_scale"):
        return P(rules.axes_for("kv_heads", shape[0]))
    if path.endswith("/k") or path.endswith("/v"):
        return P(b, rules.axes_for("kvseq", shape[1]),
                 rules.axes_for("kv_heads", shape[2]), None)
    if path.endswith("ckv") or path.endswith("kpe"):
        return P(b, rules.axes_for("kvseq", shape[1]), None)
    if path.endswith("conv"):
        return P(b, None, rules.axes_for("ssm_ch", shape[2]))
    if path.endswith("ssm"):
        return P(b, rules.axes_for("ssm_heads", shape[1]), None, None)
    if path.endswith("/h"):
        return P(b, rules.axes_for("lru", shape[1]))
    return P(*([b] + [None] * (len(shape) - 1))) if len(shape) else P()


def cache_pspecs(cache, rules):
    """The specs of a decode cache (tensors, meta or not), a tree of its
    structure: leaf paths as the reference's ("/"-joined keys and list
    indices), a scan-stacked leaf (a path through "scan") its inner spec
    after a leading None."""
    def walk(x, path):
        if isinstance(x, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v, f"{path}/{i}" if path else str(i))
                    for i, v in enumerate(x)]
        if x is None:
            return None
        shape = tuple(x.shape)
        if "scan" in path and len(shape) >= 1:
            return P(None, *_cache_leaf_spec(path, shape[1:], rules))
        return _cache_leaf_spec(path, shape, rules)

    return walk(cache, "")


# ---------------------------------------------------------------------------
# One rank's step on a mesh (the reference's ``lower_step``)
# ---------------------------------------------------------------------------


def step_rules(cfg: ModelConfig, mesh, opts: StepOptions):
    """The rules of a cell's step: the default table (multi-pod when the
    mesh has "pod"), the decode cache's sequence over the batch axes under
    ``seq_shard`` (over ``model`` under ``mla_seq_shard``), ``fsdp``."""
    table = shard_rules.default_table("pod" in mesh_sizes(mesh),
                                      seq_shard=opts.seq_shard)
    if opts.mla_seq_shard:
        table["kvseq"] = ("model",)
    return shard_rules.Rules(mesh, table, fsdp=opts.fsdp)


def param_specs(cfg: ModelConfig, rules):
    """The spec tree of ``init_params``' leaves (from the whole shapes, on
    meta); ``rules.specs_like`` lists them in any tree's leaf order."""
    p = tfm.init_params(torch.Generator(), cfg, device="meta")
    return shard_rules.tree_param_specs(p, rules)


def _row_axes(cfg: ModelConfig, cell: ShapeCell, rules) -> tuple:
    return tuple(batch_pspec(cfg, cell, rules)["tokens"][0] or ())


def _mesh_axes(rules) -> tuple:
    return tuple(mesh_sizes(rules.mesh))


class MeshTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` of one rank: ``params`` and ``opt_state`` its blocks
    (``rules.place_train_state``), ``batch`` the global batch (numpy or
    tensors), of which it takes its rows (``rows``, the axes of
    ``batch_pspec``; with microbatches, its shard of each).  The blocks
    are written in place.

    * The leaves are gathered once a step (``rules.GatherLeaf``); the
      loss's gradient with respect to the whole leaves is taken a
      microbatch at a time (summed in f32 over more than one), then each
      leaf's gather is differentiated in leaf order: the gradient summed
      over ``rows`` and this rank's block kept.
    * The loss is the global batch's: before the forward one
      ``all_reduce`` over ``rows`` gives each microbatch's label counts
      (and the MTP loss's own), and the rank's NLL is scaled by its share
      of them; the MoE layers reduce their load over ``rows`` under the
      training rules (``models.moe``).
    * The gradient norm counts a leaf once: each block's f32 sum of
      squares over the leaf's replica count, one ``all_reduce`` over the
      mesh.  A ``grad_transform`` acts on each whole clipped leaf (the
      blocks gathered, the transform, the blocks taken; the reference's
      stacked leaves as :func:`transform_args` says), as the reference's
      acts on its global arrays.
    * metrics: the reference's ("nll", "aux_loss", "n_valid", and
      "mtp_loss" under MTP, of the last microbatch), "loss", "grad_norm"
      and "lr", every one the global step's.

    On a one-rank mesh every collective is an identity, and the step is
    :func:`make_train_step`'s to the bit."""

    def __init__(self, cfg: ModelConfig, aw: adamw.AdamWConfig,
                 opts: StepOptions, rules, rows: tuple,
                 grad_transform=None):
        self.cfg, self.aw, self.opts = cfg, aw, opts
        self.rules, self.rows = rules, tuple(rows)
        self.train_rules = dataclasses.replace(rules, train_rows=self.rows)
        self.spec_tree = param_specs(cfg, rules)
        self.grad_transform = grad_transform

    def specs(self, tree) -> list:
        """The spec of each leaf of ``tree`` (parameters, or a tree of
        their layout), in ``tree.leaves`` order."""
        return shard_rules.specs_like(tree, self.spec_tree)

    def _rank_loss(self, m, cl, cg):
        """This rank's part of the global loss of one microbatch, and of
        its metrics: the NLL (and MTP loss) by the rank's share of the
        label counts ``cl`` of ``cg``, the MoE aux loss as the rank's
        part (``models.moe``)."""
        nll = m["nll"] * (cl[0] / torch.clamp(cg[0], min=1.0))
        loss, out = nll, {"nll": nll, "aux_loss": m["aux_loss"]}
        if self.cfg.mtp_depth > 0:
            mtp = m["mtp_loss"] * (cl[1] / torch.clamp(cg[1], min=1.0))
            loss = loss + 0.3 * mtp
            out["mtp_loss"] = mtp
        return loss + m["aux_loss"], out

    def _counts(self, micro):
        """Each microbatch's label counts (and the MTP loss's, labels
        from the second on), f32: this rank's and the global step's."""
        def one(mb):
            c = [(mb["labels"] >= 0).to(torch.float32).sum()]
            if self.cfg.mtp_depth > 0:
                c.append((mb["labels"][:, 1:] >= 0).to(torch.float32).sum())
            return torch.stack(c)

        local = torch.stack([one(mb) for mb in micro])
        return local, shard_rules.all_reduce(local.clone(), self.rows,
                                             self.rules)

    def __call__(self, params, opt_state, batch):
        cfg, opts, rules = self.cfg, self.opts, self.rules
        blocks = tree_mod.leaves(params)
        n = opts.microbatch
        batch = batch_to(shard_rules.take_rows(batch, self.rows, rules, n),
                         blocks[0].device)
        micro = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()} for i in range(n)]
        cl, cg = self._counts(micro)
        specs = self.specs(params)
        for b in blocks:
            if not b.requires_grad:
                b.requires_grad_(True)
        with torch.enable_grad():
            wholes = [shard_rules.GatherLeaf.apply(b, s, rules, self.rows)
                      for b, s in zip(blocks, specs)]
        whole_tree = tree_mod.unflatten(params, wholes)
        gsum, lsum = None, 0.0
        for i, mb in enumerate(micro):
            with torch.enable_grad(), shard_rules.use_rules(
                    self.train_rules):
                _, m = tfm.train_loss(whole_tree, cfg, mb,
                                      kv_repeat=opts.kv_repeat,
                                      remat=opts.remat,
                                      loss_chunk=opts.loss_chunk)
                loss, parts = self._rank_loss(m, cl[i], cg[i])
                g = torch.autograd.grad(loss, wholes, allow_unused=True)
            g = [torch.zeros_like(w) if x is None else x
                 for x, w in zip(g, wholes)]
            lsum = lsum + loss.detach()
            if n == 1:
                gsum = g
            elif gsum is None:
                gsum = [x.to(torch.float32) for x in g]
            else:
                for acc, x in zip(gsum, g):
                    acc.add_(x.to(torch.float32))
            del g
        if n > 1:
            gsum = [x / n for x in gsum]
        grads = []
        for i, (w, b) in enumerate(zip(wholes, blocks)):
            grads.append(torch.autograd.grad(w, b, grad_outputs=gsum[i])[0])
            gsum[i] = None      # a whole gradient freed once reduced
        del wholes, whole_tree, gsum
        with torch.no_grad():
            tot = torch.stack([lsum / n, parts["nll"].detach(),
                               parts["aux_loss"].detach()]
                              + ([parts["mtp_loss"].detach()]
                                 if "mtp_loss" in parts else []))
            tot = shard_rules.all_reduce(tot, self.rows, rules)
            gnorm = self._global_norm(grads, specs)
        metrics = {"nll": tot[1], "aux_loss": tot[2], "n_valid": cg[-1][0]}
        if "mtp_loss" in parts:
            metrics["mtp_loss"] = tot[3]
        whole = (lambda i, g: shard_rules.gather_block(g, specs[i], rules),
                 lambda i, g: shard_rules.take_block(g, specs[i], rules))
        params, opt_state, om = adamw.update(
            tree_mod.unflatten(params, grads), opt_state, params, self.aw,
            gnorm=gnorm, **transform_args(self.grad_transform, params, cfg,
                                          whole))
        return params, opt_state, dict(metrics, loss=tot[0], **om)

    def _global_norm(self, grads, specs):
        sq = []
        for g, s in zip(grads, specs):
            v = torch.sum(torch.square(g.to(torch.float32)))
            r = shard_rules.replicas(s, self.rules)
            sq.append(v / r if r > 1 else v)
        tot = shard_rules.all_reduce(torch.sum(torch.stack(sq)),
                                     _mesh_axes(self.rules), self.rules)
        return torch.sqrt(tot)

class MeshServingStep:
    """One rank's prefill (``step(params, batch)``) or decode
    (``step(params, cache, batch)``) of a serving cell on a mesh, as the
    dry run counts it: the parameters (blocks by ``tree_param_specs``)
    and the decode cache (blocks by :func:`cache_pspecs`) gathered whole
    but for the rows, the rank's rows computed by the plain step."""

    def __init__(self, cfg: ModelConfig, cell: ShapeCell, opts: StepOptions,
                 rules, rows: tuple):
        self.cell, self.rules, self.rows = cell, rules, tuple(rows)
        self.spec_tree = param_specs(cfg, rules)
        self.inner = (make_prefill_step(cfg, cell, opts)
                      if cell.step == "prefill"
                      else make_decode_step(cfg, opts))

    def _params(self, params):
        return tree_mod.unflatten(params, [
            shard_rules.gather_block(b, s, self.rules)
            for b, s in zip(tree_mod.leaves(params),
                            shard_rules.specs_like(params, self.spec_tree))])

    def __call__(self, params, *args):
        batch = shard_rules.take_rows(args[-1], self.rows, self.rules)
        if self.cell.step == "prefill":
            return self.inner(self._params(params), batch)
        cache = args[0]
        specs = shard_rules.specs_like(cache, cache_pspecs(cache,
                                                            self.rules))
        # the rows stay this rank's: dim 0's axes are not gathered
        whole = [shard_rules.gather_block(c, (None,) + tuple(s[1:]),
                                          self.rules)
                 for c, s in zip(tree_mod.leaves(cache), specs)]
        return self.inner(self._params(params),
                          tree_mod.unflatten(cache, whole), batch)


def lower_step(cfg: ModelConfig, mesh, cell: ShapeCell,
               opts: Optional[StepOptions] = None,
               aw: Optional[adamw.AdamWConfig] = None,
               grad_transform=None):
    """One rank's step of ``cell`` on ``mesh``: (step, info), info with
    the reference's keys ("options", "params", "active_params", and
    "cache_bytes", the whole cache's, for a serving cell).  A train cell's
    step is a :class:`MeshTrainStep`, a serving cell's a
    :class:`MeshServingStep`; both carry their ``rules`` and row axes
    ``rows``."""
    if opts is None:
        opts = pick_options(cfg, mesh, cell)
    rules = step_rules(cfg, mesh, opts)
    info = {"options": dataclasses.asdict(opts),
            "params": param_count(cfg),
            "active_params": active_param_count(cfg)}
    if cell.step in ("decode", "prefill"):
        info["cache_bytes"] = cache_bytes(cache_struct(cfg, cell, opts))
    rows = _row_axes(cfg, cell, rules)
    if cell.step == "train":
        step = MeshTrainStep(cfg, aw or adamw.AdamWConfig(), opts, rules,
                             rows, grad_transform)
    else:
        step = MeshServingStep(cfg, cell, opts, rules, rows)
    return step, info
