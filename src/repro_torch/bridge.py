"""Carry the reference's parameter and cache trees across by value.

The JAX package stacks the repeated layer group under ``["scan"]`` with a
leading layer axis (qwen3's pattern "G" puts every layer in
``params["scan"]["sub0"]``); the port keeps one entry per layer under
``["layers"]``.  These functions convert between the two through numpy,
so tests can hand both packages the same weights and caches.

Parameters are cast from the f32 masters to ``cfg.dtype`` once, here —
the reference casts at every use, and a cast is deterministic — except
the leaves the reference reads uncast, which stay f32: norm scales and
biases (``apply_norm``), an 'M' layer's ``dt_bias``, ``A_log``, ``D``
and ``norm``, an 'R' layer's gate weights and biases and ``lam``, a MoE
layer's ``router`` and selection ``bias``, and MLA's ``q_norm`` and
``kv_norm`` (``rms_head_norm``).  A model with a dense prefix
(``moe.n_dense_layers``) has its prefix layers first in the port's list,
as under the reference's ``params["prefix"]``.  A frontend's ``proj``
crosses as it is; an encoder-decoder's encoder, stacked under
``params["encoder"]["scan"]["sub0"]`` over ``enc_layers``, becomes the
port's ``params["encoder"]["layers"]``, and its cross caches
(``cross_prefix`` / ``scan["xkv{j}"]`` / ``cross_tail``) the port's
``cache["cross"]``, one (k, v) a decoder layer.  DeepSeek's MTP module
("mtp", one unstacked 'G' layer and its projection and norms) crosses
leaf for leaf.  AdamW's state crosses as ``(m, v, step)``, the moments
f32 in the parameters' layout (:func:`opt_state_from_numpy`).  bf16
arrays from JAX are ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses, so they cross as their uint16 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import map_keyed as _map_keyed
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype
from repro_torch.models.transformer import layout

#: parameter leaves kept in f32 whatever the config dtype
F32_KEYS = frozenset({"scale", "bias", "q_norm", "k_norm",
                      # models/attention.py (MLA; q_norm above)
                      "kv_norm",
                      # models/ssm.py
                      "dt_bias", "A_log", "D", "norm",
                      # models/rglru.py
                      "wa_gate", "wi_gate", "ba_gate", "bi_gate", "lam",
                      # models/moe.py ("bias" above)
                      "router"})


def to_torch(a, device=None) -> torch.Tensor:
    """A numpy array (bf16 included), or a tensor, as a tensor on
    ``device``."""
    if torch.is_tensor(a):       # a copy: never a view of a stacked leaf
        return a.to(a.device if device is None else device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device) if device is not None else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 comes back as ml_dtypes.bfloat16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # bf16 numpy arrays exist only through ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _unstack(tree, cfg: ModelConfig):
    """Reference tree → list of per-layer subtrees in stack order."""
    _, n_rep, _ = layout(cfg)
    layers = list(tree.get("prefix", []))
    for rep in range(n_rep):
        for j in range(len(cfg.layer_pattern)):
            layers.append(_map_keyed(lambda a, _k, r=rep: a[r],
                               tree["scan"][f"sub{j}"]))
    layers.extend(tree.get("tail", []))
    return layers


def _restack(layers, cfg: ModelConfig, conv, stack=None):
    """List of per-layer subtrees → the reference's prefix/scan/tail, each
    leaf through ``conv``, each repeated group through ``stack`` (default
    :func:`_stack`)."""
    stack = stack or _stack
    n_prefix, n_rep, tail = layout(cfg)
    plen = len(cfg.layer_pattern)
    out = {"prefix": [_map_keyed(conv, lp) for lp in layers[:n_prefix]],
           "tail": [_map_keyed(conv, lp) for lp in layers[n_prefix + n_rep * plen:]]}
    if n_rep > 0:
        out["scan"] = {}
        for j in range(plen):
            group = [layers[n_prefix + rep * plen + j] for rep in range(n_rep)]
            out["scan"][f"sub{j}"] = stack(group, conv)
    return out


def _stack(trees, conv):
    """Stack matching subtrees along a new leading axis, each leaf through
    ``conv``, into one preallocated array a leaf: the host holds the
    stacked tree and one converted leaf, never a second copy of the
    stack (a full-width model's moments are tens of GB)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], conv) for k in first}
    out = None
    for i, t in enumerate(trees):
        a = conv(t, None)
        if out is None:
            shape = (len(trees),) + tuple(a.shape)
            out = (torch.empty(shape, dtype=a.dtype, device=a.device)
                   if torch.is_tensor(a) else np.empty(shape, a.dtype))
        out[i] = a
    return out


def _fetch(t) -> torch.Tensor:
    """A leaf's CPU tensor: a tensor copied to the host, or a callable's
    result (a mesh checkpoint's leaf gathers itself)."""
    return t() if callable(t) else t.detach().cpu()


def _stack_lazy(trees):
    """Host stacks of matching subtrees of tensors (or of callables that
    give one), deferred: each stacked leaf a callable that copies the
    layers straight into one CPU tensor when called."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_lazy([t[k] for t in trees]) for k in first}

    def build():
        out = None
        for i, t in enumerate(trees):
            a = t() if callable(t) else t.detach()
            if out is None:
                out = torch.empty((len(trees),) + tuple(a.shape),
                                  dtype=a.dtype)
            out[i].copy_(a)
        return out

    return build


def _encoder_layers(enc, cfg: ModelConfig):
    """The reference's encoder stack (``scan["sub0"]``, a leading layer
    axis of ``enc_layers``) as a list of per-layer subtrees."""
    return [_map_keyed(lambda a, _k, i=i: a[i], enc["scan"]["sub0"])
            for i in range(cfg.enc_layers)]


def params_from_numpy(tree, cfg: ModelConfig, device=None, *,
                      cast: bool = True):
    """Reference params (numpy leaves) → the port's parameter dict, each
    leaf in ``cfg.dtype`` except ``F32_KEYS`` (``cast`` False: every leaf
    keeps its dtype, as AdamW's f32 moments do)."""
    dt = cdtype(cfg)

    def leaf(a, key):
        t = to_torch(a, device)
        return t if key in F32_KEYS or not cast else t.to(dt)

    out = {"embed": _map_keyed(leaf, tree["embed"])}
    if "frontend" in tree:
        out["frontend"] = _map_keyed(leaf, tree["frontend"])
    out["layers"] = [_map_keyed(leaf, lp) for lp in _unstack(tree, cfg)]
    out["final_norm"] = _map_keyed(leaf, tree["final_norm"])
    if "encoder" in tree:
        out["encoder"] = {
            "layers": [_map_keyed(leaf, lp)
                       for lp in _encoder_layers(tree["encoder"], cfg)],
            "final_norm": _map_keyed(leaf, tree["encoder"]["final_norm"])}
    if "mtp" in tree:
        out["mtp"] = _map_keyed(leaf, tree["mtp"])
    return out


def _to_reference(params, cfg: ModelConfig, conv, stack=None):
    stack = stack or _stack
    out = {"embed": _map_keyed(conv, params["embed"])}
    if "frontend" in params:
        out["frontend"] = _map_keyed(conv, params["frontend"])
    out.update(_restack(params["layers"], cfg, conv, stack))
    out["final_norm"] = _map_keyed(conv, params["final_norm"])
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"scan": {"sub0": stack(enc["layers"], conv)},
                          "final_norm": _map_keyed(conv, enc["final_norm"])}
    if "mtp" in params:
        out["mtp"] = _map_keyed(conv, params["mtp"])
    return out


def params_to_numpy(params, cfg: ModelConfig):
    """The port's parameters → the reference's tree layout (numpy)."""
    return _to_reference(params, cfg, lambda t, _k: to_numpy(t))


def params_to_host(params, cfg: ModelConfig):
    """The port's parameters (tensors, or callables that give one) → the
    reference's tree layout, each leaf a callable that makes its CPU copy
    (bf16 included, with no numpy bf16 type needed) when called: what the
    Trainer checkpoints
    (``checkpoint.ckpt.save`` calls each leaf as it writes it, or all of
    them at once for an async save's snapshot)."""
    return _to_reference(params, cfg,
                         lambda t, _k: (lambda: _fetch(t)),
                         lambda trees, _c: _stack_lazy(trees))


def params_to_meta(params, cfg: ModelConfig):
    """The reference's tree layout of the port's parameters as meta
    tensors: shapes and dtypes, no storage (a restore's template)."""
    return _to_reference(params, cfg, lambda t, _k: torch.empty(
        t.shape, dtype=t.dtype, device="meta"))


def stack_groups(params, cfg: ModelConfig) -> list:
    """The leaves of the port's ``params`` that are one leaf of the
    reference's tree, as lists of indices into ``core.tree.leaves(params)``
    in stack order: a leaf of each scan-stacked layer group (pattern
    position j over the repeats, and the encoder's layers) together, every
    other leaf alone; sorted by first index.  A transform whose result
    depends on the whole leaf (the k-means gradient compression) acts on
    these."""
    from repro_torch.core import tree as tree_mod

    idx = tree_mod.unflatten(params, range(len(tree_mod.leaves(params))))
    n_prefix, n_rep, _ = layout(cfg)
    plen = len(cfg.layer_pattern)
    stacks = [[idx["layers"][n_prefix + rep * plen + j]
               for rep in range(n_rep)] for j in range(plen)] if n_rep else []
    if "encoder" in idx:
        stacks.append(idx["encoder"]["layers"])
    groups, grouped = [], set()
    for members in stacks:
        for leaf in zip(*(tree_mod.leaves(m) for m in members)):
            groups.append(list(leaf))
            grouped.update(leaf)
    groups += [[i] for i in tree_mod.leaves(idx) if i not in grouped]
    return sorted(groups)


def opt_state_from_numpy(state, cfg: ModelConfig, device=None):
    """The reference's AdamW state ``(m, v, step)`` (numpy leaves, the
    moments in the reference's parameter layout) → the port's
    ``optim.adamw.OptState``: f32 moments in the port's layout and step a
    0-d int32 tensor."""
    from repro_torch.optim.adamw import OptState

    m, v, step = state
    return OptState(params_from_numpy(m, cfg, device, cast=False),
                    params_from_numpy(v, cfg, device, cast=False),
                    to_torch(np.asarray(step, np.int32), device))


def opt_state_to_numpy(state, cfg: ModelConfig):
    """The port's AdamW state → ``OptState(m, v, step)`` with numpy
    leaves in the reference's layout (``OptState`` is a named tuple with
    the reference's field names, so its checkpoint keys are the
    reference's)."""
    return type(state)(params_to_numpy(state.m, cfg),
                       params_to_numpy(state.v, cfg),
                       np.asarray(to_numpy(state.step), np.int32))


def opt_state_to_host(state, cfg: ModelConfig):
    """:func:`opt_state_to_numpy` with :func:`params_to_host`'s leaves."""
    return type(state)(params_to_host(state.m, cfg),
                       params_to_host(state.v, cfg),
                       state.step.detach().cpu())


def cache_from_numpy(tree, cfg: ModelConfig, device=None):
    """Reference cache (numpy leaves) → ``{"layers": [leaf per layer]}``
    (and ``"cross": [(k, v) per layer]`` for an encoder-decoder), dtypes
    kept."""
    conv = lambda a, _k: to_torch(a, device)  # noqa: E731
    out = {"layers": [_map_keyed(conv, leaf) for leaf in _unstack(tree, cfg)]}
    if "cross_prefix" in tree:
        _, n_rep, _ = layout(cfg)
        cross = [tuple(_map_keyed(conv, kv)) for kv in tree["cross_prefix"]]
        for rep in range(n_rep):
            for j in range(len(cfg.layer_pattern)):
                cross.append(tuple(to_torch(a[rep], device)
                                   for a in tree["scan"][f"xkv{j}"]))
        cross.extend(tuple(_map_keyed(conv, kv)) for kv in tree["cross_tail"])
        out["cross"] = cross
    return out


def cache_to_numpy(cache, cfg: ModelConfig):
    """The port's cache → the reference's prefix/scan/tail tree (with its
    ``cross_prefix`` / ``scan["xkv{j}"]`` / ``cross_tail`` for an
    encoder-decoder)."""
    out = _restack(cache["layers"], cfg, lambda t, _k: to_numpy(t))
    if "cross" in cache:
        n_prefix, n_rep, _ = layout(cfg)
        plen = len(cfg.layer_pattern)
        cross = [tuple(to_numpy(t) for t in kv) for kv in cache["cross"]]
        out["cross_prefix"] = cross[:n_prefix]
        out["cross_tail"] = cross[n_prefix + n_rep * plen:]
        for j in range(plen if n_rep > 0 else 0):
            group = [cross[n_prefix + rep * plen + j] for rep in range(n_rep)]
            out["scan"][f"xkv{j}"] = (np.stack([k for k, _ in group]),
                                      np.stack([v for _, v in group]))
    return out
