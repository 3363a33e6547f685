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
``cache["cross"]``, one (k, v) a decoder layer.  The reference's MTP
module ("mtp") is left out: serving never reads it.  bf16
arrays from JAX are ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses, so they cross as their uint16 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

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
    """A numpy array (bf16 included) as a tensor on ``device``."""
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


def _map(fn, tree, key=None):
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, key) for v in tree]
    return fn(tree, key)


def _unstack(tree, cfg: ModelConfig):
    """Reference tree → list of per-layer subtrees in stack order."""
    _, n_rep, _ = layout(cfg)
    layers = list(tree.get("prefix", []))
    for rep in range(n_rep):
        for j in range(len(cfg.layer_pattern)):
            layers.append(_map(lambda a, _k, r=rep: a[r],
                               tree["scan"][f"sub{j}"]))
    layers.extend(tree.get("tail", []))
    return layers


def _restack(layers, cfg: ModelConfig):
    """List of per-layer subtrees → the reference's prefix/scan/tail."""
    n_prefix, n_rep, tail = layout(cfg)
    plen = len(cfg.layer_pattern)
    out = {"prefix": layers[:n_prefix],
           "tail": layers[n_prefix + n_rep * plen:]}
    if n_rep > 0:
        out["scan"] = {}
        for j in range(plen):
            group = [layers[n_prefix + rep * plen + j] for rep in range(n_rep)]
            out["scan"][f"sub{j}"] = _stack(group)
    return out


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def _encoder_layers(enc, cfg: ModelConfig):
    """The reference's encoder stack (``scan["sub0"]``, a leading layer
    axis of ``enc_layers``) as a list of per-layer subtrees."""
    return [_map(lambda a, _k, i=i: a[i], enc["scan"]["sub0"])
            for i in range(cfg.enc_layers)]


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """Reference params (numpy leaves) → the port's parameter dict."""
    dt = cdtype(cfg)

    def leaf(a, key):
        t = to_torch(a, device)
        return t if key in F32_KEYS else t.to(dt)

    out = {"embed": _map(leaf, tree["embed"])}
    if "frontend" in tree:
        out["frontend"] = _map(leaf, tree["frontend"])
    out["layers"] = [_map(leaf, lp) for lp in _unstack(tree, cfg)]
    out["final_norm"] = _map(leaf, tree["final_norm"])
    if "encoder" in tree:
        out["encoder"] = {
            "layers": [_map(leaf, lp)
                       for lp in _encoder_layers(tree["encoder"], cfg)],
            "final_norm": _map(leaf, tree["encoder"]["final_norm"])}
    return out


def params_to_numpy(params, cfg: ModelConfig):
    """The port's parameters → the reference's tree layout (numpy)."""
    conv = lambda t, _k: to_numpy(t)  # noqa: E731
    out = {"embed": _map(conv, params["embed"])}
    if "frontend" in params:
        out["frontend"] = _map(conv, params["frontend"])
    out.update(_restack([_map(conv, lp) for lp in params["layers"]], cfg))
    out["final_norm"] = _map(conv, params["final_norm"])
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "scan": {"sub0": _stack([_map(conv, lp)
                                     for lp in enc["layers"]])},
            "final_norm": _map(conv, enc["final_norm"])}
    return out


def cache_from_numpy(tree, cfg: ModelConfig, device=None):
    """Reference cache (numpy leaves) → ``{"layers": [leaf per layer]}``
    (and ``"cross": [(k, v) per layer]`` for an encoder-decoder), dtypes
    kept."""
    conv = lambda a, _k: to_torch(a, device)  # noqa: E731
    out = {"layers": [_map(conv, leaf) for leaf in _unstack(tree, cfg)]}
    if "cross_prefix" in tree:
        _, n_rep, _ = layout(cfg)
        cross = [tuple(_map(conv, kv)) for kv in tree["cross_prefix"]]
        for rep in range(n_rep):
            for j in range(len(cfg.layer_pattern)):
                cross.append(tuple(to_torch(a[rep], device)
                                   for a in tree["scan"][f"xkv{j}"]))
        cross.extend(tuple(_map(conv, kv)) for kv in tree["cross_tail"])
        out["cross"] = cross
    return out


def cache_to_numpy(cache, cfg: ModelConfig):
    """The port's cache → the reference's prefix/scan/tail tree (with its
    ``cross_prefix`` / ``scan["xkv{j}"]`` / ``cross_tail`` for an
    encoder-decoder)."""
    out = _restack([_map(lambda t, _k: to_numpy(t), leaf)
                    for leaf in cache["layers"]], cfg)
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
