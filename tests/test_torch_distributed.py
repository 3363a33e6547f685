"""The port's distributed reduction tree (``group=``) against the
reference on one device: the twins of tests/test_distributed.py's three
pins, in one 8-rank gloo world of spawned CPU processes, each rank holding
a contiguous block of the points over a one-axis "data" mesh.

* the grouped bit-serial median, whose per-bit vote counts are summed
  across the ranks, equals the port's single-device median and the
  reference's bit for bit, on every rank;
* the L1 k-medians fit matches within the reference test's atol 1e-5,
  with equal assignments;
* the weighted ``compress_head`` matches within the reference test's
  tolerances;
* the tree's other entry points (``median_bits``, ``median_bits64``, the
  float ``median``, a k-means fit) match the port on one device;
* a planted fault, one bit's all_reduce skipped on every rank, changes
  the median: the check above would catch it.

The reference's results are computed here, in the test process
(``auto_scale`` patched to exact powers of two, ``_torch_ref``); the
ranks run ``_torch_dist_ranks.main``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitserial as bitserial_ref
from repro.core import clustering as clustering_ref
from repro.core import kv_compress as kv_ref
from repro.core import quantizer as quantizer_ref
from repro.core.clustering import ClusterConfig as ClusterConfigRef
from repro_torch.core import bitserial as bitserial_t
from repro_torch.core import clustering as clustering_t
from repro_torch.core import kv_compress as kv_t
from repro_torch.core import quantizer as quantizer_t
from repro_torch.core.clustering import ClusterConfig

import _torch_dist_ranks as ranks
import _torch_ref
from _torch_world import run_world

WORLD = 8
# the median's all_reduce calls: the totals, then bits 31..0; skip bit 5's
SKIP_CALL = 1 + (31 - 5)


@pytest.fixture(scope="module")
def world():
    return run_world("_torch_dist_ranks:main", WORLD, skip_call=SKIP_CALL)


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quantizer_ref, "auto_scale", _torch_ref._auto_scale_exact)
        x, assign = ranks.median_inputs()
        u = quantizer_ref.to_unsigned_order(jnp.asarray(x))
        med, tot = bitserial_ref.grouped_median_bits(u, jnp.asarray(assign),
                                                     4)
        xs = ranks.fit_inputs()
        cfg = ClusterConfigRef(k=3, centroid="median", metric="l1",
                               max_iters=20)
        fit = clustering_ref.fit(jnp.asarray(xs), cfg, jnp.asarray(xs[:3]),
                                 use_kernel=False)
        keys, vals, w = ranks.compress_inputs()
        cfg_kv = kv_ref.KVCompressConfig(n_clusters=ranks.COMPRESS["C"],
                                         iters=6, keep_recent=16)
        comp = kv_ref.compress_head(jnp.asarray(keys), jnp.asarray(vals),
                                    cfg_kv, weights=jnp.asarray(w),
                                    init_centroids=jnp.asarray(
                                        keys[:ranks.COMPRESS["C"]]))
    return {"median": (np.asarray(med).astype(np.int64), np.asarray(tot)),
            "fit": (np.asarray(fit.centroids), np.asarray(fit.assign)),
            "compress": tuple(np.asarray(a) for a in comp)}


@pytest.fixture(scope="module")
def single():
    """The port on one device, no group."""
    x, assign = ranks.median_inputs()
    med, tot = bitserial_t.grouped_median_bits(
        quantizer_t.to_unsigned_order(torch.from_numpy(x)),
        torch.from_numpy(assign), 4)
    xs = ranks.fit_inputs()
    fit = clustering_t.fit(torch.from_numpy(xs),
                           ClusterConfig(k=3, centroid="median", metric="l1",
                                         max_iters=20),
                           torch.from_numpy(xs[:3]), use_kernel=False)
    keys, vals, w = ranks.compress_inputs()
    comp = kv_t.compress_head(
        torch.from_numpy(keys), torch.from_numpy(vals),
        ranks.compress_config(), weights=torch.from_numpy(w),
        init_centroids=torch.from_numpy(keys[:ranks.COMPRESS["C"]]))
    return {"median": (med.numpy(), tot.numpy()),
            "fit": (fit.centroids.numpy(), fit.assign.numpy()),
            "compress": tuple(a.numpy() for a in comp)}


def test_distributed_median_matches_single_device(world, reference, single):
    med_ref, tot_ref = reference["median"]
    np.testing.assert_array_equal(single["median"][0], med_ref)
    for r, out in enumerate(world):
        med, tot = out["median"]
        np.testing.assert_array_equal(med, med_ref, err_msg=f"rank {r}")
        np.testing.assert_array_equal(med, single["median"][0])
        np.testing.assert_allclose(tot, tot_ref)


def test_distributed_kmedians_fit_matches_single_device(world, reference,
                                                        single):
    cents_ref, assign_ref = reference["fit"]
    np.testing.assert_allclose(single["fit"][0], cents_ref, atol=1e-5)
    assign = np.concatenate([out["fit"][1] for out in world])
    np.testing.assert_array_equal(assign, assign_ref)
    np.testing.assert_array_equal(assign, single["fit"][1])
    for r, out in enumerate(world):
        np.testing.assert_allclose(out["fit"][0], cents_ref, atol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(out["fit"][0], world[0]["fit"][0])


def test_distributed_weighted_compress_head_matches_single_device(
        world, reference, single):
    kc_ref, vc_ref, cnt_ref = reference["compress"]
    for got in [single["compress"]] + [out["compress"] for out in world]:
        kc, vc, cnt = got
        np.testing.assert_allclose(kc, kc_ref, atol=1e-5)
        np.testing.assert_allclose(vc, vc_ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(cnt, cnt_ref, rtol=1e-5)


def test_the_other_tree_entry_points_match_single_device(world):
    """``median_bits`` (unit and count weights), ``median_bits64``, the
    float ``median`` and a k-means fit, each with ``group=`` on the 8
    ranks: the medians bit for bit the port's on one device, the mean
    centroids within 1e-5 (their sums are added in another order) with
    equal assignments."""
    x, _ = ranks.median_inputs()
    u = quantizer_t.to_unsigned_order(torch.from_numpy(x))
    w = torch.from_numpy(np.arange(128, dtype=np.float32) % 3)
    want_bits = (bitserial_t.median_bits(u).numpy(),
                 bitserial_t.median_bits(u, weights=w[:, None]).numpy())
    hi, lo = ranks.limb_inputs()
    want64 = [a.numpy() for a in bitserial_t.median_bits64(
        torch.from_numpy(hi), torch.from_numpy(lo))]
    xs = ranks.fit_inputs()
    want_float = bitserial_t.median(torch.from_numpy(xs)).numpy()
    fit = clustering_t.fit(torch.from_numpy(xs),
                           ClusterConfig(k=3, centroid="mean", metric="l2",
                                         max_iters=20),
                           torch.from_numpy(xs[:3]), use_kernel=False)
    for out in world:
        for got, want in zip(out["median_bits"], want_bits):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(out["median_bits64"], want64):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(out["median_float"], want_float)
        np.testing.assert_allclose(out["fit_mean"][0], fit.centroids.numpy(),
                                   atol=1e-5)
    np.testing.assert_array_equal(
        np.concatenate([out["fit_mean"][1] for out in world]),
        fit.assign.numpy())


def test_planted_missing_all_reduce_fails(world, reference):
    """Skipping bit 5's vote-count all_reduce on every rank (the median's
    33 collectives: the totals, then one a bit) gives medians that differ
    from the reference, so the median pin above would fail."""
    med_ref = reference["median"][0]
    for out in world:
        assert out["median_calls"] == 33
        assert not np.array_equal(out["median_planted"][0], med_ref)
