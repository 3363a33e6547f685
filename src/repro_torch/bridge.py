"""Carry the reference's parameter and cache trees across by value.

The JAX package stacks the repeated layer group under ``["scan"]`` with a
leading layer axis (qwen3's pattern "G" puts every layer in
``params["scan"]["sub0"]``); the port keeps one entry per layer under
``["layers"]``.  These functions convert between the two through numpy,
so tests can hand both packages the same weights and caches.

Parameters are cast from the f32 masters to ``cfg.dtype`` once, here —
the reference casts at every use, and a cast is deterministic — except
norm scales and biases, which stay f32 as ``apply_norm`` uses them.  bf16
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
F32_KEYS = frozenset({"scale", "bias", "q_norm", "k_norm"})


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


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """Reference params (numpy leaves) → the port's parameter dict."""
    dt = cdtype(cfg)

    def leaf(a, key):
        t = to_torch(a, device)
        return t if key in F32_KEYS else t.to(dt)

    return {
        "embed": _map(leaf, tree["embed"]),
        "layers": [_map(leaf, lp) for lp in _unstack(tree, cfg)],
        "final_norm": _map(leaf, tree["final_norm"]),
    }


def params_to_numpy(params, cfg: ModelConfig):
    """The port's parameters → the reference's tree layout (numpy)."""
    conv = lambda t, _k: to_numpy(t)  # noqa: E731
    out = {"embed": _map(conv, params["embed"])}
    out.update(_restack([_map(conv, lp) for lp in params["layers"]], cfg))
    out["final_norm"] = _map(conv, params["final_norm"])
    return out


def cache_from_numpy(tree, cfg: ModelConfig, device=None):
    """Reference cache (numpy leaves) → ``{"layers": [leaf per layer]}``,
    dtypes kept."""
    return {"layers": [_map(lambda a, _k: to_torch(a, device), leaf)
                       for leaf in _unstack(tree, cfg)]}


def cache_to_numpy(cache, cfg: ModelConfig):
    """The port's cache → the reference's prefix/scan/tail tree."""
    return _restack([_map(lambda t, _k: to_numpy(t), leaf)
                     for leaf in cache["layers"]], cfg)
