"""The paper's clustering pipeline in the port against the reference:
fits without ``init_centroids`` (threefry k-means++ and random starts),
the quality metrics and the optimal-k sweep, the mini-batch fit, the
64-bit medians and host limbs, and the quickstart twin
(examples/quickstart_torch.py) against examples/quickstart.py.

The reference's ``auto_scale`` is patched to exact powers of two where the
numbers must agree bit for bit (``_torch_ref``, ROADMAP Queue C 1)."""

import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitserial, clustering, quantizer
from repro.data import pipeline
from repro_torch.core import bitserial as bitserial_t
from repro_torch.core import clustering as clustering_t
from repro_torch.core import prng
from repro_torch.core import quantizer as quantizer_t
from repro_torch.data import pipeline as pipeline_t

from _torch_ref import exact_pow2_reference  # noqa: F401  (fixture)

T = torch.from_numpy
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _wine(n=1500):
    x, y = pipeline.wine_like(n=n, seed=0)
    return (x - x.mean(0)) / (x.std(0) + 1e-6), y


def test_tables_equal_the_reference():
    for a, b in ((pipeline.wine_like(300, 2), pipeline_t.wine_like(300, 2)),
                 (pipeline.census_like(400), pipeline_t.census_like(400)),
                 (pipeline.gaussian_blobs(20, np.eye(3)),
                  pipeline_t.gaussian_blobs(20, np.eye(3)))):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert pipeline_t.WINE_FEATURES == pipeline.WINE_FEATURES


@pytest.mark.parametrize("centroid,metric,init", [
    ("median", "l1", "kmeanspp"), ("median", "l2", "random"),
    ("mean", "l2", "kmeanspp")])
def test_fit_without_init_matches(centroid, metric, init,
                                  exact_pow2_reference):
    """wine_like(1500): the same start from the same seed, so the same
    assignments and iteration count; centroids within 1e-5 (means are
    summed in another order)."""
    xs, _ = _wine()
    cfg = dict(k=3, centroid=centroid, metric=metric, init=init, seed=1)
    res = clustering.fit(jnp.asarray(xs), clustering.ClusterConfig(**cfg))
    res_t = clustering_t.fit(T(xs), clustering_t.ClusterConfig(**cfg))
    np.testing.assert_array_equal(res_t.assign.numpy(), np.asarray(res.assign))
    assert int(res_t.n_iters) == int(res.n_iters)
    np.testing.assert_allclose(res_t.centroids.numpy(),
                               np.asarray(res.centroids), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_weighted_kmeanspp_picks_the_reference_points(metric):
    xs, _ = _wine(800)
    w = np.random.default_rng(0).integers(0, 4, size=800).astype(np.float32)
    for seed in range(3):
        want = clustering.init_kmeanspp(jax.random.PRNGKey(seed),
                                        jnp.asarray(xs), 8, metric,
                                        weights=jnp.asarray(w))
        got = clustering_t.init_kmeanspp(prng.PRNGKey(seed), T(xs), 8,
                                         metric, weights=T(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_large_queue_batch_plan_matches(seed, exact_pow2_reference):
    """A queue of 64 requests takes plan_batches' k-medians branch (a fit
    without init_centroids): the same batches as the reference."""
    from repro.core import request_cluster as rc
    from repro_torch.core import request_cluster as rc_t

    rng = np.random.default_rng(seed)
    lens, gens = rng.integers(10, 2000, size=64), rng.integers(5, 300, size=64)
    want = rc.plan_batches([rc.Request(i, int(a), int(b)) for i, (a, b)
                            in enumerate(zip(lens, gens))], 4, 4, seed=seed)
    got = rc_t.plan_batches([rc_t.Request(i, int(a), int(b)) for i, (a, b)
                             in enumerate(zip(lens, gens))], 4, 4, seed=seed)
    assert got.batches == want.batches
    assert got.waste == want.waste


def test_recognition_rate_matches():
    rng = np.random.default_rng(4)
    assign = rng.integers(0, 6, size=500).astype(np.int32)
    labels = rng.integers(0, 4, size=500).astype(np.int32)
    labels[assign == 2] = 3                    # one pure cluster
    want = clustering.recognition_rate(jnp.asarray(assign),
                                       jnp.asarray(labels), 6, 4)
    got = clustering_t.recognition_rate(T(assign), T(labels), 6, 4)
    assert float(got) == float(want)


def test_select_k_and_silhouette_match(exact_pow2_reference):
    xc, _ = pipeline.census_like(n=400, seed=1, outlier_frac=0.0)
    cfg = dict(k=2, centroid="mean", metric="l2")
    k_opt, scores = clustering.select_k(jnp.asarray(xc), 2, 6,
                                        clustering.ClusterConfig(**cfg))
    k_opt_t, scores_t = clustering_t.select_k(
        T(xc), 2, 6, clustering_t.ClusterConfig(**cfg))
    assert k_opt_t == k_opt
    np.testing.assert_allclose(scores_t, scores, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("centroid,metric", [("mean", "l2"),
                                             ("median", "l1")])
def test_fit_minibatch_matches(centroid, metric, exact_pow2_reference):
    xs, _ = _wine(600)
    cfg = dict(k=3, centroid=centroid, metric=metric, bits=16)
    res = clustering.fit_minibatch(jax.random.PRNGKey(3), jnp.asarray(xs),
                                   clustering.ClusterConfig(**cfg), 64, 6)
    res_t = clustering_t.fit_minibatch(prng.PRNGKey(3), T(xs),
                                       clustering_t.ClusterConfig(**cfg), 64,
                                       6)
    np.testing.assert_allclose(res_t.centroids.numpy(),
                               np.asarray(res.centroids), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(res_t.counts.numpy(), np.asarray(res.counts))
    np.testing.assert_array_equal(res_t.assign.numpy(), np.asarray(res.assign))
    np.testing.assert_allclose(float(res_t.inertia), float(res.inertia),
                               rtol=TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_median_bits64_and_host_limbs_bit_exact(weighted):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(41, 3)) * 1e3
    scale = 2.0 ** 40
    hi, lo = quantizer.quantize64_host(x, scale)
    hi_t, lo_t = quantizer_t.quantize64_host(x, scale)
    np.testing.assert_array_equal(hi_t, hi)
    np.testing.assert_array_equal(lo_t, lo)
    np.testing.assert_array_equal(quantizer_t.dequantize64_host(hi, lo, scale),
                                  quantizer.dequantize64_host(hi, lo, scale))
    w = rng.integers(0, 4, size=(41, 1)).astype(np.float32) if weighted \
        else None
    mh, ml = bitserial.median_bits64(
        jnp.asarray(hi), jnp.asarray(lo),
        weights=None if w is None else jnp.asarray(w))
    mh_t, ml_t = bitserial_t.median_bits64(
        T(hi.astype(np.int64)), T(lo.astype(np.int64)),
        weights=None if w is None else T(w))
    for got, want in ((mh_t, mh), (ml_t, ml)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))


def test_quickstart_twin_prints_the_reference_numbers(exact_pow2_reference,
                                                      capsys):
    """examples/quickstart_torch.py --device cpu prints the lines of
    examples/quickstart.py, run with auto_scale patched to exact powers:
    every number equal, except that the reference prints its exponents as
    int(jnp.log2(2^f)), and XLA's CPU log2 gives 26.999998 for 2^27, so
    its scale line reads 26 where the port's reads 27 (ROADMAP Queue C 4)."""
    ref = runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                         run_name="reference_quickstart")
    capsys.readouterr()
    ref["main"]()
    want = capsys.readouterr().out.splitlines()
    twin = runpy.run_path(str(ROOT / "examples" / "quickstart_torch.py"),
                          run_name="quickstart_torch")
    got = []
    twin["run"]("cpu", say=got.append)
    assert len(got) == len(want) == 6
    assert got[:1] + got[2:] == want[:1] + want[2:]
    line = "fixed-point scales (2^f per feature): [{0} {0} {0} {0} {0} {0}]…"
    assert got[1] == line.format(27)
    assert want[1] == line.format(int(jnp.log2(jnp.float32(2.0 ** 27))))
    assert want[1] == line.format(26)


def test_quickstart_scale_against_unpatched_reference():
    """Unpatched, the reference's scale itself is jnp.exp2(27) =
    134217672 (ROADMAP Queue C 1); the port's is 2^27 exactly."""
    xs, _ = _wine()
    want = np.asarray(quantizer.auto_scale(jnp.asarray(xs), bits=32))
    got = quantizer_t.auto_scale(T(xs), bits=32).numpy()
    np.testing.assert_array_equal(got, np.full(12, 2.0 ** 27, np.float32))
    np.testing.assert_array_equal(want, np.full(12, 134217672.0, np.float32))
