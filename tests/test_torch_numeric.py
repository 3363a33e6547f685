"""The port's numeric core against the reference: fixed-point
quantization and bit-serial medians bit for bit, weighted k-medians /
k-means fits with explicit initial centroids (batched members included),
and the distance-argmin assignment (the plain version of the CUDA kernel)
against the reference's interpret-mode Pallas kernel and numpy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitserial, clustering, quantizer
from repro.kernels import ops, ref
from repro_torch.core import bitserial as bitserial_t
from repro_torch.core import clustering as clustering_t
from repro_torch.core import quantizer as quantizer_t
from repro_torch.kernels import distance_argmin as da_t
from repro_torch.kernels import ops as ops_t

from _torch_ref import exact_pow2_reference  # noqa: F401  (fixture)

T = torch.from_numpy


def make_blobs(rng, n_per, centers, std=0.3):
    """The blob generator of tests/test_clustering.py."""
    centers = np.asarray(centers, np.float32)
    k, d = centers.shape
    xs = [rng.normal(size=(n_per, d)).astype(np.float32) * std + centers[c]
          for c in range(k)]
    x = np.concatenate(xs)
    return x[rng.permutation(len(x))]


CENTERS = [[0.0, 0.0], [5.0, 5.0], [-5.0, 5.0], [5.0, -5.0]]


# ---------------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("absmax", [4.0, 0.5, 2.0 ** -10, 3.7, 1000.0])
def test_auto_scale_same_exponent(absmax):
    """Both floor the same log2, so the exponent f agrees (power-of-two
    absmax included).  The port's scale is exactly 2^f; the reference's
    jnp.exp2 misses it by up to a few ulps on the CPU (ROADMAP Queue C)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(50, 6)).astype(np.float32) * absmax
    x[0] = absmax          # pin the max exactly (power of two or not)
    for bits in (16, 32):
        want = np.asarray(quantizer.auto_scale(jnp.asarray(x), bits))
        got = quantizer_t.auto_scale(T(x), bits).numpy()
        f = np.round(np.log2(want.astype(np.float64)))
        np.testing.assert_array_equal(got, np.exp2(f).astype(np.float32))
        np.testing.assert_allclose(want, got, rtol=2e-6)


def test_reference_exp2_is_inexact():
    """The divergence recorded in ROADMAP Queue C, pinned."""
    assert float(jnp.exp2(jnp.float32(27.0))) == 134217672.0
    assert float(quantizer_t.pow2(torch.tensor(27.0))) == 2.0 ** 27


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_quantize_and_unsigned_order_bit_exact(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(64, 5)).astype(np.float32) * 3
    x[0, 0] = 0.5 / 2 ** 10                     # a half-way rounding case
    scale_t = quantizer_t.auto_scale(T(x), bits)
    spec = quantizer.FixedPointSpec(bits=bits,
                                    scale=jnp.asarray(scale_t.numpy()))
    spec_t = quantizer_t.FixedPointSpec(bits=bits, scale=scale_t)
    q = quantizer.quantize(jnp.asarray(x), spec)
    q_t = quantizer_t.quantize(T(x), spec_t)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q))
    u = quantizer.to_unsigned_order(q, bits)
    u_t = quantizer_t.to_unsigned_order(q_t, bits)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u).astype(np.int64))
    back = quantizer_t.from_unsigned_order(u_t, bits)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(quantizer.from_unsigned_order(u, bits)))
    np.testing.assert_array_equal(
        quantizer_t.dequantize(back, spec_t).numpy(),
        np.asarray(quantizer.dequantize(q, spec)))


# ---------------------------------------------------------------------------
# bit-serial medians
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("weighted", [False, True])
def test_grouped_median_bits_bit_exact(bits, weighted):
    rng = np.random.default_rng(bits + weighted)
    n, d, k = 40, 7, 5          # even N per cluster occurs: lower median
    q = rng.integers(-(2 ** 10), 2 ** 10, size=(n, d)).astype(np.int32)
    assign = rng.integers(0, k, size=(n,)).astype(np.int32)
    w = rng.integers(0, 4, size=(n,)).astype(np.float32) if weighted else None
    u = quantizer.to_unsigned_order(jnp.asarray(q), bits)
    med, tot = bitserial.grouped_median_bits(
        u, jnp.asarray(assign), k, bits=bits,
        weights=None if w is None else jnp.asarray(w))
    u_t = T(np.asarray(u).astype(np.int64))
    med_t, tot_t = bitserial_t.grouped_median_bits(
        u_t, T(assign), k, bits=bits, weights=None if w is None else T(w))
    np.testing.assert_array_equal(med_t.numpy(),
                                  np.asarray(med).astype(np.int64))
    np.testing.assert_array_equal(tot_t.numpy(), np.asarray(tot))
    if not weighted:
        # kernels/ref.py oracle on the fixed-point grid
        want, counts = ref.grouped_median_ref(q, assign, k)
        got = quantizer_t.from_unsigned_order(med_t, bits).numpy()
        live = counts > 0
        np.testing.assert_array_equal(got[live], want[live])


def test_weighted_median_bits_matches_oracle():
    rng = np.random.default_rng(3)
    q = rng.integers(-500, 500, size=(31, 4)).astype(np.int32)
    w = rng.integers(0, 5, size=(31,)).astype(np.float32)
    u_t = quantizer_t.to_unsigned_order(T(q.astype(np.int64)), 16)
    med = bitserial_t.median_bits(u_t, weights=T(w)[:, None], bits=16)
    got = quantizer_t.from_unsigned_order(med, 16).numpy()
    want = ref.weighted_lower_median_ref(q.astype(np.float64), w)
    np.testing.assert_array_equal(got.astype(np.float64), want)


@pytest.mark.parametrize("n", [10, 11])
def test_float_median_matches_reference(n, exact_pow2_reference):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    want = np.asarray(bitserial.median(jnp.asarray(x), bits=32))
    got = bitserial_t.median(T(x), bits=32).numpy()
    np.testing.assert_array_equal(got, want)
    # quantization is monotone, so it commutes with the lower median:
    # the oracle is dequantize(quantize(sort-based lower median))
    spec = quantizer_t.FixedPointSpec(
        bits=32, scale=quantizer_t.auto_scale(T(x), 32))
    oracle = quantizer_t.dequantize(quantizer_t.quantize(
        bitserial_t.sort_median_ref(T(x)), spec), spec)
    np.testing.assert_array_equal(got, oracle.numpy())


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("centroid,metric", [("mean", "l2"),
                                             ("median", "l1"),
                                             ("median", "l2")])
def test_fit_with_init_matches(centroid, metric, exact_pow2_reference):
    rng = np.random.default_rng(0)
    x = make_blobs(rng, 64, CENTERS)
    init = x[rng.choice(len(x), 4, replace=False)]
    cfg = clustering.ClusterConfig(k=4, centroid=centroid, metric=metric)
    cfg_t = clustering_t.ClusterConfig(k=4, centroid=centroid, metric=metric)
    res = clustering.fit(jnp.asarray(x), cfg, jnp.asarray(init),
                         use_kernel=False)
    res_t = clustering_t.fit(T(x), cfg_t, T(init), use_kernel=False)
    np.testing.assert_array_equal(res_t.assign.numpy(), np.asarray(res.assign))
    np.testing.assert_allclose(res_t.centroids.numpy(),
                               np.asarray(res.centroids), rtol=1e-6,
                               atol=1e-6)
    assert int(res_t.n_iters) == int(res.n_iters)
    np.testing.assert_array_equal(res_t.counts.numpy(), np.asarray(res.counts))
    np.testing.assert_allclose(float(res_t.inertia), float(res.inertia),
                               rtol=1e-5)


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_fit_matches_unpatched_reference(metric):
    """Against the reference as it stands, with its jnp.exp2 scale a few
    ulps off 2^f: at 32 bits one step of the fixed-point grid is ~1e-8
    here, so the medians still agree to 1e-6 and the assignments exactly."""
    rng = np.random.default_rng(0)
    x = make_blobs(rng, 64, CENTERS)
    init = x[rng.choice(len(x), 4, replace=False)]
    cfg = clustering.ClusterConfig(k=4, centroid="median", metric=metric)
    cfg_t = clustering_t.ClusterConfig(k=4, centroid="median", metric=metric)
    res = clustering.fit(jnp.asarray(x), cfg, jnp.asarray(init),
                         use_kernel=False)
    res_t = clustering_t.fit(T(x), cfg_t, T(init), use_kernel=False)
    np.testing.assert_array_equal(res_t.assign.numpy(), np.asarray(res.assign))
    np.testing.assert_allclose(res_t.centroids.numpy(),
                               np.asarray(res.centroids), rtol=1e-6,
                               atol=1e-6)
    assert int(res_t.n_iters) == int(res.n_iters)


def test_fit_default_kernel_path_matches(exact_pow2_reference):
    """The default use_kernel=True reaches distance_argmin in both
    packages (Pallas in interpret mode; the port's plain version)."""
    rng = np.random.default_rng(1)
    x = make_blobs(rng, 40, CENTERS)
    init = x[:4]
    cfg = clustering.ClusterConfig(k=4, metric="l1", max_iters=6)
    cfg_t = clustering_t.ClusterConfig(k=4, metric="l1", max_iters=6)
    res = clustering.fit(jnp.asarray(x), cfg, jnp.asarray(init))
    res_t = clustering_t.fit(T(x), cfg_t, T(init))
    np.testing.assert_array_equal(res_t.assign.numpy(), np.asarray(res.assign))
    np.testing.assert_array_equal(res_t.centroids.numpy(),
                                  np.asarray(res.centroids))


def test_batched_fit_freezes_converged_members(exact_pow2_reference):
    """A batched fit equals the reference's vmap'd while_loop: members
    converge at different iterations and each keeps its own fixpoint."""
    rng = np.random.default_rng(2)
    xs = np.stack([make_blobs(rng, 30, CENTERS, std=s) for s in
                   (0.1, 0.8, 2.5)])                    # (3, 120, 2)
    w = (rng.uniform(size=xs.shape[:2]) > 0.2).astype(np.float32) * \
        rng.integers(1, 4, size=xs.shape[:2]).astype(np.float32)
    init = xs[:, :4]
    cfg = clustering.ClusterConfig(k=4, metric="l2", bits=16, max_iters=12)
    cfg_t = clustering_t.ClusterConfig(k=4, metric="l2", bits=16, max_iters=12)
    res = jax.vmap(lambda xx, ww, ii: clustering.fit(
        xx, cfg, ii, use_kernel=False, weights=ww))(
        jnp.asarray(xs), jnp.asarray(w), jnp.asarray(init))
    res_t = clustering_t.fit(T(xs), cfg_t, T(init), use_kernel=False,
                             weights=T(w))
    its = np.asarray(res.n_iters)
    assert len(set(its.tolist())) > 1, its      # members stop at different its
    np.testing.assert_array_equal(res_t.n_iters.numpy(), its)
    np.testing.assert_array_equal(res_t.assign.numpy(), np.asarray(res.assign))
    np.testing.assert_array_equal(res_t.centroids.numpy(),
                                  np.asarray(res.centroids))
    np.testing.assert_array_equal(res_t.counts.numpy(), np.asarray(res.counts))


def test_seed_empty_centroids_matches():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 30, 5)).astype(np.float32)
    cents = rng.normal(size=(2, 6, 5)).astype(np.float32)
    live = rng.uniform(size=(2, 6)) > 0.5
    w = (rng.uniform(size=(2, 30)) > 0.3).astype(np.float32)
    want = jax.vmap(lambda a, b, c, d: clustering.seed_empty_centroids(
        a, b, c, "l2", weights=d))(jnp.asarray(x), jnp.asarray(cents),
                                   jnp.asarray(live), jnp.asarray(w))
    got = clustering_t.seed_empty_centroids(T(x), T(cents), T(live), "l2",
                                            weights=T(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kmeanspp_fit_without_init_runs():
    """Without init_centroids the port draws k-means++ from its threefry
    port (``core.prng``); the fit finds the four blobs.  Equality with the
    reference's draws is held in tests/test_torch_pipeline.py."""
    rng = np.random.default_rng(5)
    x = make_blobs(rng, 50, CENTERS)
    res = clustering_t.fit(T(x), clustering_t.ClusterConfig(k=4, seed=3))
    c = np.sort(res.centroids.numpy(), axis=0)
    np.testing.assert_allclose(c, np.sort(np.asarray(CENTERS), axis=0),
                               atol=0.3)


# ---------------------------------------------------------------------------
# distance_argmin (plain version of the CUDA kernel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("n,d,k", [(7, 2, 2), (100, 3, 16), (257, 8, 4)])
def test_distance_argmin_matches(metric, n, d, k):
    rng = np.random.default_rng(n + d + k)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    a, m = ops.distance_argmin(jnp.asarray(x), jnp.asarray(c), metric=metric,
                               interpret=True)
    a_t, m_t = ops_t.distance_argmin(T(x), T(c), metric=metric)
    assert a_t.dtype == torch.int32
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m), rtol=1e-5,
                               atol=1e-5)
    ea, em = ref.distance_argmin_ref(x, c, metric)
    np.testing.assert_array_equal(a_t.numpy(), ea)
    np.testing.assert_allclose(m_t.numpy(), em, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_distance_argmin_tie_takes_first(metric):
    x = np.zeros((4, 2), np.float32)
    c = np.zeros((3, 2), np.float32)            # all centroids identical
    a, _ = da_t.distance_argmin_plain(T(x), T(c), metric=metric)
    np.testing.assert_array_equal(a.numpy(), np.zeros((4,), np.int32))


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_cpu_tensors_never_launch_the_kernel(metric):
    ops_t.reset_launches()
    ops_t.distance_argmin(torch.zeros(3, 2), torch.zeros(2, 2), metric=metric)
    counts = ops_t.launch_counts()
    assert counts["distance_argmin"] == 0
    assert counts["distance_argmin l1"] == counts["distance_argmin l2"] == 0
