"""Gradient compression through a k-means codebook (port of
``repro.core.grad_compress``).

Each gradient tensor is quantized to a k-entry codebook (the paper's
clustering engine applied 1-D to gradient values) and 4-bit indices, with
error feedback so that the quantization error is carried to the next step
instead of lost.  Compression model (k = 16): 4 bits an element plus k
floats, about 8x fewer bytes than f32 on the wire.  The codebook fit is a
few Lloyd iterations over a strided subsample.

The reference assigns every element to its nearest entry through one (n,
k) distance matrix; here the argmin runs over chunks of the flat tensor
(qwen3-4b's embedding alone would need a 25 GB matrix).  The argmin is per
element, so chunking changes no index; ties go to the lower index, as
``jnp.argmin``'s do.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import tree as tree_mod

#: elements a chunk of the assignment argmin (a (chunk, k) f32 distance
#: block: 256 MB at k = 16)
ARGMIN_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    k: int = 16              # codebook entries (4-bit indices)
    iters: int = 8           # Lloyd iterations for the 1-D codebook
    sample: int = 4096       # subsample size for the fit
    error_feedback: bool = True


class EFState(NamedTuple):
    residual: object  # a tree like the gradients, f32


def _fit_codebook_1d(x_flat: torch.Tensor, k: int, iters: int,
                     sample: int) -> torch.Tensor:
    """1-D k-means codebook (k,) f32 over a strided subsample of x_flat:
    entries start evenly spread over the sample's range, and an entry no
    sample value picks keeps its place."""
    n = x_flat.shape[0]
    dev = x_flat.device
    idx = (torch.arange(sample, device=dev) * max(n // sample, 1)) % max(n, 1)
    xs = x_flat[idx]
    lo, hi = xs.min(), xs.max()
    c = lo + (hi - lo) * (torch.arange(k, dtype=torch.float32, device=dev)
                          + 0.5) / k
    for _ in range(iters):
        a = torch.argmin(torch.abs(xs[:, None] - c[None, :]), dim=1)
        onehot = F.one_hot(a, k).to(torch.float32)
        sums = onehot.T @ xs
        counts = onehot.sum(0)
        c = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), c)
    return c


def _nearest(flat: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Each element's nearest codebook entry (uint8), ties to the lower
    index, ``ARGMIN_CHUNK`` elements at a time."""
    out = torch.empty(flat.shape, dtype=torch.uint8, device=flat.device)
    for c0 in range(0, flat.shape[0], ARGMIN_CHUNK):
        d = torch.abs(flat[c0:c0 + ARGMIN_CHUNK, None] - cents[None, :])
        out[c0:c0 + ARGMIN_CHUNK] = torch.argmin(d, dim=1).to(torch.uint8)
    return out


def quantize_tensor(g: torch.Tensor, cfg: CompressConfig):
    """Returns (indices uint8 shaped like g, codebook (k,) f32)."""
    flat = g.reshape(-1).to(torch.float32)
    cents = _fit_codebook_1d(flat, cfg.k, cfg.iters,
                             min(cfg.sample, flat.shape[0]))
    return _nearest(flat, cents).reshape(g.shape), cents


def dequantize_tensor(idx: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Each index's codebook entry, gathered by int32 indices (a stacked
    qwen3-4b leaf has 0.9 G elements: int64 indices would take 7 GB)."""
    flat = idx.reshape(-1).to(torch.int32)
    return torch.index_select(cents, 0, flat).reshape(idx.shape)


def compress_decompress(g: torch.Tensor, cfg: CompressConfig):
    """The round trip the wire sees: (g_hat f32, err = g - g_hat)."""
    idx, cents = quantize_tensor(g, cfg)
    g_hat = dequantize_tensor(idx, cents)
    return g_hat, g - g_hat


def make_grad_transform(cfg: CompressConfig, axis_name: str = None):
    """The optimizer's gradient transform: every leaf of 1,024 elements or
    more through :func:`compress_decompress`, cast back to its dtype
    (smaller ones unchanged).  It takes a tree or one tensor (``adamw.
    update`` passes one clipped leaf at a time).  Without error feedback
    this is a pure transform; with it the caller threads ``EFState``
    through :func:`apply_ef`.  ``axis_name`` names the mesh axis of the
    cross-pod reduction ("pod"), as in the reference, where it changes
    nothing: the transform models the quantize -> reduce -> dequantize
    round trip on the reduced gradient, and :func:`wire_bytes` gives the
    saving.  On a mesh the step sums the gradient over the row axes
    (``pod`` among them) and hands the transform each whole clipped leaf
    (``launch.steps.MeshTrainStep``).  The returned transform is marked
    ``reference_leaves``: the train steps apply it to the reference's
    leaves (:func:`stacked` over ``bridge.stack_groups``), since a
    codebook fitted over one layer of a scan-stacked leaf is another
    codebook."""
    del axis_name  # the reduction is the step's; the round trip is this

    def one(g):
        if g.numel() < 1024:  # tiny tensors aren't worth compressing
            return g
        return dequantize_tensor(*quantize_tensor(g, cfg)).to(g.dtype)

    def transform(grads):
        return tree_mod.map_(one, grads)

    # a leaf's codebook is fitted over the whole leaf: the train steps
    # hand it the reference's leaves (``stacked``)
    transform.reference_leaves = True
    return transform


def stacked(transform, leaves: list) -> list:
    """``transform`` of the reference's leaf made of ``leaves`` (a group of
    ``bridge.stack_groups``: the per-layer leaves of one scan-stacked
    leaf, stacked along a new leading dim, or one leaf alone), split back
    into the group's leaves."""
    if len(leaves) == 1:
        return [transform(leaves[0])]
    return list(torch.unbind(transform(torch.stack(leaves))))


def apply_ef(grads, ef: EFState, cfg: CompressConfig):
    """Error-feedback round: compress (grads + residual) leaf by leaf and
    carry the new residual.  Returns (g_hat tree, EFState)."""
    def one(g, r):
        if g.numel() < 1024:
            return g, torch.zeros_like(g)
        g_hat, err = compress_decompress(g.to(torch.float32) + r, cfg)
        return g_hat.to(g.dtype), err

    pairs = tree_mod.map_(one, grads, ef.residual)
    return (tree_mod.map_(lambda _g, pair: pair[0], grads, pairs),
            EFState(tree_mod.map_(lambda _g, pair: pair[1], grads, pairs)))


def init_ef(params) -> EFState:
    return EFState(tree_mod.map_(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def wire_bytes(params_tree, cfg: CompressConfig) -> dict:
    """Analytic wire bytes of one all-reduce, f32 against compressed."""
    sizes = [p.numel() for p in tree_mod.leaves(params_tree)]
    fp32 = sum(n * 4 for n in sizes)
    comp = sum((n // 2 + cfg.k * 4) if n >= 1024 else n * 4 for n in sizes)
    return {"fp32_bytes": fp32, "compressed_bytes": comp,
            "ratio": fp32 / max(comp, 1)}
