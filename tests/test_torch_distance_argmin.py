"""The distance-argmin assignment (kernel B4, ``distance_argmin``) on the
CPU: the sequential twin of the CUDA kernel's arithmetic
(``distance_argmin_sequential``: each distance one chain over d in order,
the first strictly smaller distance wins) against the port's plain
version, the reference's Pallas kernel in interpret mode and its numpy
oracle; its rules for ties, NaN and rows without a finite distance; the
kernel's split of the centroids over threads and its merge of their
partial argmins, emulated on random distances with ties, inf and NaN
(hypothesis)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops, ref
from repro_torch.kernels import distance_argmin as da_t

T = torch.from_numpy
# (n, d, k): one and several 16-dim chunks, banks on either side of the
# kernel's 64-centroid tile, and the quickstart's shapes (the wine table's
# fits, 4,595 x 12 with K = 3; the census k sweep, 5,000 x 8 with K 2-8)
SHAPES = [(7, 2, 2), (100, 3, 16), (257, 8, 4), (300, 12, 70), (129, 16, 65),
          (50, 17, 130), (40, 300, 5), (4595, 12, 3), (5000, 8, 2),
          (5000, 8, 8)]


def _points(n, d, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(k, d)).astype(np.float32))


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_twin_matches_plain_and_reference(metric, n, d, k):
    """Same assignments as the plain version, the reference's Pallas kernel
    (interpret mode) and its numpy oracle; distances within 1e-5 (the three
    sum in other orders)."""
    x, c = _points(n, d, k, seed=n + d + k)
    a_t, m_t = da_t.distance_argmin_sequential(T(x), T(c), metric=metric)
    assert a_t.dtype == torch.int32 and m_t.dtype == torch.float32
    a0, m0 = da_t.distance_argmin_plain(T(x), T(c), metric=metric)
    a, m = ops.distance_argmin(jnp.asarray(x), jnp.asarray(c), metric=metric,
                               interpret=True)
    ea, em = ref.distance_argmin_ref(x, c, metric)
    for want_a, want_m in ((a0.numpy(), m0.numpy()),
                           (np.asarray(a), np.asarray(m)), (ea, em)):
        np.testing.assert_array_equal(a_t.numpy(), want_a)
        np.testing.assert_allclose(m_t.numpy(), want_m, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,k", [(64, 1, 9), (200, 16, 64), (33, 300, 70)])
def test_twin_l1_is_one_chain_per_distance(n, d, k):
    """L1 mindist is, bit for bit, the f32 chain dist += |x - c| over d in
    order, taken at the first index of its minimum."""
    x, c = _points(n, d, k, seed=d)
    dist = np.zeros((n, k), np.float32)
    for j in range(d):
        dist += np.abs(x[:, j, None] - c[None, :, j])
    a_t, m_t = da_t.distance_argmin_sequential(T(x), T(c), metric="l1")
    np.testing.assert_array_equal(a_t.numpy(), dist.argmin(1))
    np.testing.assert_array_equal(m_t.numpy().view(np.int32),
                                  dist.min(1).view(np.int32))


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_twin_bank_the_first_kernel_refused(metric):
    """K = 4,096 x D = 128, over the shared memory the first kernel needed
    to hold the bank: the twin agrees with the plain version and the
    oracle."""
    x, c = _points(24, 128, 4096, seed=3)
    a_t, m_t = da_t.distance_argmin_sequential(T(x), T(c), metric=metric)
    a0, m0 = da_t.distance_argmin_plain(T(x), T(c), metric=metric)
    ea, em = ref.distance_argmin_ref(x, c, metric)
    np.testing.assert_array_equal(a_t.numpy(), a0.numpy())
    np.testing.assert_array_equal(a_t.numpy(), ea)
    np.testing.assert_allclose(m_t.numpy(), em, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_twin_ties_keep_the_first_index(metric):
    """Duplicates within a 64-centroid tile and across tiles (c[40] = c[70]
    = c[3], c[129] = c[100]) with points placed on them, and a bank of
    identical centroids."""
    x, c = _points(300, 16, 130, seed=5)
    c[40] = c[70] = c[3]
    c[129] = c[100]
    x[:100] = c[3]
    x[100:200] = c[100]
    a, _ = da_t.distance_argmin_sequential(T(x), T(c), metric=metric)
    assert (a[:100] == 3).all() and (a[100:200] == 100).all()
    same = np.zeros((3, 2), np.float32)
    a, _ = da_t.distance_argmin_sequential(T(np.ones((4, 2), np.float32)),
                                           T(same), metric=metric)
    np.testing.assert_array_equal(a.numpy(), np.zeros(4, np.int32))


def test_twin_rows_without_a_finite_distance():
    """L1: a row with inf or NaN has no finite distance and gives (inf, 0).
    L2: a NaN row's expansion is NaN, which the clamp (fmax, as the
    kernel's fmaxf) turns into 0, so it gives (0, 0)."""
    x, c = _points(6, 4, 9, seed=6)
    x[1, 2] = np.inf
    x[2, 0] = -np.inf
    x[3] = np.nan
    a, m = da_t.distance_argmin_sequential(T(x), T(c), metric="l1")
    assert a[1:4].tolist() == [0, 0, 0]
    assert torch.isinf(m[1:4]).all()
    a, m = da_t.distance_argmin_sequential(T(x), T(c), metric="l2")
    assert int(a[3]) == 0 and float(m[3]) == 0.0


def _cent_of(j, cr):
    """The kernel's centroid slot j of the thread with centroid offset cr
    (csrc/distance_argmin.cu ``cent_of``)."""
    return (j // 4) * 32 + cr + j % 4


def _take_smaller(a, b):
    (d, i), (d2, i2) = a, b
    return b if d2 < d or (d2 == d and i2 < i) else a


def _kernel_argmin(dist):
    """One point's argmin as the kernel takes it: centroid tiles of 64 in
    order; within a tile, eight threads with eight slots each, every thread
    a strict-< scan of its slots in increasing index from (inf, 0); then the
    threads' pairs merged across lane distances 4, 2, 1."""
    k = len(dist)
    best = [(np.float32(np.inf), 0)] * 8
    for k0 in range(0, max(k, 1), 64):
        for cg in range(8):
            for j in range(8):
                kk = k0 + _cent_of(j, 4 * cg)
                if kk < k and dist[kk] < best[cg][0]:
                    best[cg] = (dist[kk], kk)
    for bit in (4, 2, 1):
        best = [_take_smaller(best[g], best[g ^ bit]) for g in range(8)]
    return best[0]


def _sequential_argmin(dist):
    best = (np.float32(np.inf), 0)
    for kk, v in enumerate(dist):
        if v < best[0]:
            best = (v, kk)
    return best


@settings(max_examples=200, deadline=None)
@given(k=st.integers(0, 200), data=st.data())
def test_kernel_split_and_merge_is_the_sequential_rule(k, data):
    """Ties, +-0, inf and NaN in any place: the kernel's split of the
    centroids over threads and its merge give the sequential first-minimum
    (NaN never wins, nothing finite gives (inf, 0))."""
    vals = st.sampled_from([0.0, -0.0, 1.0, 2.0, 3.0, np.inf, np.nan])
    dist = np.array(data.draw(st.lists(vals, min_size=k, max_size=k)),
                    np.float32)
    got, want = _kernel_argmin(dist), _sequential_argmin(dist)
    assert got[1] == want[1]
    assert np.float32(got[0]).view(np.int32) == np.float32(
        want[0]).view(np.int32)
    if k:
        # the twin holds to the same rule: one point at 0 in one dim, so
        # its L1 distances are |dist|
        a, m = da_t.distance_argmin_sequential(
            torch.zeros((1, 1)), T(dist[:, None].copy()), metric="l1")
        want = _sequential_argmin(np.abs(dist))
        assert int(a[0]) == want[1]
        assert m.numpy().view(np.int32)[0] == np.float32(
            want[0]).view(np.int32)


def test_cuda_wrapper_takes_no_cpu_tensors():
    """No fallback: the kernel's wrapper raises for CPU tensors."""
    with pytest.raises(ValueError):
        da_t.distance_argmin_cuda(torch.zeros(3, 2), torch.zeros(2, 2))

