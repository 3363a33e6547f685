"""AdamW with global-norm clipping and a warmup + cosine schedule (port of
``repro.optim.adamw``).

Moments are f32 trees in the parameters' layout; the math is f32 and each
parameter is cast back to its own dtype, as in the reference.  The
reference clips by building an f32 copy of the whole gradient tree; here
the clip factor comes from the global norm first and is applied leaf by
leaf inside the update, so at most one leaf's f32 gradient exists at a
time (a full-width qwen3-4b's f32 gradient tree would be 16 GB).  The
update runs under ``torch.no_grad()`` and writes the parameters and the
moments in place.  An optional gradient transform (the paper's k-means
codebook compression, ``core.grad_compress``) acts on each clipped f32
gradient leaf before the update, or on each group of leaves that the
reference holds as one scan-stacked leaf (one group's f32 gradients at a
time).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import tree as tree_mod


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: object
    v: object
    step: torch.Tensor      # 0-d int32, the number of updates taken


def init(params) -> OptState:
    """Zero f32 moments shaped like ``params``, on each leaf's device, and
    step 0 on the first leaf's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_mod.leaves(params)[0].device
    return OptState(tree_mod.map_(zeros, params),
                    tree_mod.map_(zeros, params),
                    torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in the reference's f32
    arithmetic: a linear warmup to ``lr``, then a cosine decay to
    ``min_lr_frac`` x ``lr`` at ``total_steps``."""
    f32 = torch.float32
    step = torch.as_tensor(step).to(f32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(torch.tensor(math.pi, dtype=f32,
                                              device=step.device) * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (one leaf's f32
    copy at a time)."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in tree_mod.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that scales a tree of global norm ``norm`` to at most
    ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(the tree in f32 scaled to global norm <= ``max_norm``, the norm);
    the reference's form, which holds an f32 copy of every leaf
    (:func:`update` applies the factor leaf by leaf instead)."""
    norm = global_norm(tree)
    factor = clip_factor(norm, max_norm)
    return tree_mod.map_(lambda g: g.to(torch.float32) * factor, tree), norm


def update(grads, state: OptState, params, cfg: AdamWConfig,
           grad_transform=None, *, gnorm: Optional[torch.Tensor] = None,
           groups: Optional[list] = None):
    """One AdamW step.  ``grads`` is a tree shaped like ``params``.  Each
    gradient leaf is clipped by the global-norm factor in f32, then passed
    through ``grad_transform`` when given: a function of one f32 leaf, or
    with ``groups`` (lists of leaf indices in ``tree.leaves`` order,
    covering every leaf: ``bridge.stack_groups``) a function ``(group,
    leaves)`` of a group and the list of its clipped leaves that returns
    the list transformed.
    ``gnorm``: the global norm when the caller has it (a mesh step's, over
    every rank's blocks), else that of ``grads``.  Writes ``params`` and
    the moments in place and returns (params, the new OptState, metrics
    {"grad_norm", "lr"})."""
    flat_p = tree_mod.leaves(params)
    flat_m = tree_mod.leaves(state.m)
    flat_v = tree_mod.leaves(state.v)
    flat_g = tree_mod.leaves(grads)
    if groups is None:
        groups = [[i] for i in range(len(flat_g))]
        if grad_transform is not None:
            tf = grad_transform
            grad_transform = lambda _grp, gs: [tf(gs[0])]   # noqa: E731
    with torch.no_grad():
        if gnorm is None:
            gnorm = global_norm(flat_g)
        factor = clip_factor(gnorm, cfg.clip_norm)
        step = state.step + 1
        lr = schedule(cfg, step)
        stepf = step.to(torch.float32)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
        for group in groups:
            gs = [flat_g[i].to(torch.float32) * factor for i in group]
            if grad_transform is not None:
                gs = grad_transform(group, gs)
            for i, g in zip(group, gs):
                m, v, p = flat_m[i], flat_v[i], flat_p[i]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p32 = p.to(torch.float32)
                delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
                    + cfg.weight_decay * p32
                p.copy_(p32 - lr * delta)
            del gs
    return (params, OptState(state.m, state.v, step),
            {"grad_norm": gnorm, "lr": lr})
