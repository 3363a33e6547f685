"""The ranks of tests/test_torch_distributed.py's gloo world (run through
``_torch_world.run_world``; imports neither JAX nor the reference).

Each rank takes its contiguous block of the points of
tests/test_distributed.py's three scenarios (the same numpy draws) over a
one-axis "data" mesh of the whole world, runs the port's distributed
reduction tree on it, and returns what it computed.  Last, the median runs
again with a planted fault: all_reduce call ``skip_call`` (counted from 0
within that run) is skipped on every rank.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core import bitserial, clustering, kv_compress, quantizer
from repro_torch.core.clustering import ClusterConfig


def median_inputs():
    rng = np.random.default_rng(0)
    x = rng.integers(-2**20, 2**20, size=(128, 16)).astype(np.int32)
    assign = rng.integers(0, 4, size=(128,)).astype(np.int32)
    return x, assign


def fit_inputs():
    rng = np.random.default_rng(1)
    centers = np.array([[0, 0], [6, 6], [-6, 6]], np.float32)
    xs = np.concatenate([
        rng.normal(size=(64, 2)).astype(np.float32) * 0.3 + c
        for c in centers])
    return xs[rng.permutation(len(xs))]


def limb_inputs():
    """Two uint32 limbs of 64-bit words (128, 4), as int64."""
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 2**32, size=(128, 4), dtype=np.uint64)
    lo = rng.integers(0, 2**32, size=(128, 4), dtype=np.uint64)
    hi[::5] = hi[0]            # ties on the high limb
    return hi.astype(np.int64), lo.astype(np.int64)


COMPRESS = dict(S=128, Dh=16, C=8)


def compress_inputs():
    rng = np.random.default_rng(2)
    s, dh = COMPRESS["S"], COMPRESS["Dh"]
    keys = rng.normal(size=(s, dh)).astype(np.float32)
    vals = rng.normal(size=(s, dh)).astype(np.float32)
    # mixed weights: masked rows (0) and pre-aggregated summaries (>1)
    w = ((rng.random(s) < 0.8) * rng.integers(1, 4, size=s)).astype(
        np.float32)
    return keys, vals, w


def compress_config():
    return kv_compress.KVCompressConfig(n_clusters=COMPRESS["C"], iters=6,
                                        keep_recent=16)


def _block(a, rank, world):
    n = a.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1) * n]))


def _median(rank, world, group):
    x, assign = median_inputs()
    u = quantizer.to_unsigned_order(_block(x, rank, world))
    med, tot = bitserial.grouped_median_bits(u, _block(assign, rank, world),
                                             4, group=group)
    return med.numpy(), tot.numpy()


def main(rank, world, skip_call):
    group = init_device_mesh("cpu", (world,),
                             mesh_dim_names=("data",)).get_group("data")
    out = {"median": _median(rank, world, group)}

    xs = fit_inputs()
    cfg = ClusterConfig(k=3, centroid="median", metric="l1", max_iters=20)
    res = clustering.fit(_block(xs, rank, world), cfg,
                         torch.from_numpy(xs[:3]), use_kernel=False,
                         group=group)
    out["fit"] = (res.centroids.numpy(), res.assign.numpy(),
                  res.counts.numpy(), float(res.inertia))

    keys, vals, w = compress_inputs()
    kc, vc, cnt = kv_compress.compress_head(
        _block(keys, rank, world), _block(vals, rank, world),
        compress_config(), weights=_block(w, rank, world),
        init_centroids=torch.from_numpy(keys[:COMPRESS["C"]]), group=group)
    out["compress"] = (kc.numpy(), vc.numpy(), cnt.numpy())

    # the other entry points of the tree: the plain median along axis 0
    # (unit and count weights), its 64-bit two-limb form, the float
    # median, and a k-means (mean centroid) fit
    x, _ = median_inputs()
    u = quantizer.to_unsigned_order(_block(x, rank, world))
    w = _block(np.arange(128, dtype=np.float32) % 3, rank, world)
    out["median_bits"] = (
        bitserial.median_bits(u, group=group).numpy(),
        bitserial.median_bits(u, weights=w[:, None], group=group).numpy())
    hi, lo = limb_inputs()
    out["median_bits64"] = tuple(a.numpy() for a in bitserial.median_bits64(
        _block(hi, rank, world), _block(lo, rank, world), group=group))
    out["median_float"] = bitserial.median(
        _block(fit_inputs(), rank, world), group=group).numpy()
    res = clustering.fit(_block(xs, rank, world),
                         ClusterConfig(k=3, centroid="mean", metric="l2",
                                       max_iters=20),
                         torch.from_numpy(xs[:3]), use_kernel=False,
                         group=group)
    out["fit_mean"] = (res.centroids.numpy(), res.assign.numpy())

    # the planted fault, last: one bit's vote count is never summed
    real, calls = dist.all_reduce, [0]

    def planted(t, *a, **kw):
        calls[0] += 1
        if calls[0] - 1 == skip_call:
            return None
        return real(t, *a, **kw)

    dist.all_reduce = planted
    try:
        out["median_planted"] = _median(rank, world, group)
    finally:
        dist.all_reduce = real
    out["median_calls"] = calls[0]
    return out
