"""The grouped bit-serial median (kernel B3, ``bitserial_median``) on the
CPU: the port's plain version and the radix-select form the CUDA kernel
computes, both bit for bit against the reference's Pallas kernel in
interpret mode, its numpy oracles and its ``ops.grouped_median_bits``, on
the shapes of tests/test_kernels.py at 16 and 32 bits, with unit and
integer weights, batched and one member at a time; and the kernel's
cluster-grouped, digit-at-a-time selection (``grouped_median_digits``, the
resident form at one bit a digit, the streamed form at four bits over
chunks) bit for bit against both, over ties, zero weights, empty
clusters, K = 1, one cluster holding ~90 % of the points and 1, 13, 16
and 32 bits (hypothesis)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import quantizer
from repro.kernels import ops, ref
from repro.kernels.bitserial_median import grouped_median_pallas
from repro_torch.core import bitserial as bitserial_t
from repro_torch.core import quantizer as quantizer_t
from repro_torch.kernels import bitserial_median as bsm_t
from repro_torch.kernels import ops as ops_t

T = torch.from_numpy
SWEEP = [(5, 1, 1), (8, 3, 2), (33, 7, 4), (64, 130, 3), (100, 12, 16)]


def radix_select_median(u, assign, k, weights=None, bits=32):
    """The CUDA kernel's form, with no per-point state: before bit b a
    point is active iff its bits above b equal its cluster's median
    prefix; otherwise it votes 1 above the prefix and 0 below it."""
    u = u.to(torch.int64)
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    if weights is not None:
        onehot = onehot * weights.to(torch.float32).unsqueeze(-1)
    total = onehot.sum(-2)
    med = torch.zeros(u.shape[:-2] + (k, u.shape[-1]), dtype=torch.int64)
    gidx = assign.long().unsqueeze(-1).expand(u.shape)
    for b in range(bits - 1, -1, -1):
        hi = (0xFFFFFFFF << (b + 1)) & 0xFFFFFFFF
        prefix = torch.gather(med, -2, gidx)           # the cluster's prefix
        up = u & hi
        eff = torch.where(up == prefix, (u >> b) & 1, (up > prefix).long())
        cnt1 = torch.matmul(onehot.transpose(-1, -2), eff.to(torch.float32))
        med = med | ((cnt1 * 2.0 > total.unsqueeze(-1)).long() << b)
    return med, total


def _words(x, bits):
    return quantizer_t.to_unsigned_order(T(x).long(), bits)


def _signed(med_u, bits):
    return quantizer_t.from_unsigned_order(med_u, bits).numpy()


def _forms(u, assign, k, w, bits):
    """(plain, radix-select, ops wrapper) medians and totals."""
    return [bitserial_t.grouped_median_bits(u, assign, k, weights=w,
                                            bits=bits),
            radix_select_median(u, assign, k, w, bits),
            ops_t.grouped_median_bits(u, assign, k, w, bits=bits)]


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("n,d,k", SWEEP)
def test_sweep_matches_pallas_and_oracle(n, d, k, bits):
    rng = np.random.default_rng(n * d * k + bits)
    lim = 2 ** (bits - 2) if bits == 16 else 2 ** 20
    x = rng.integers(-lim, lim, size=(n, d)).astype(np.int32)
    assign = rng.integers(0, k, size=(n,)).astype(np.int32)
    u = quantizer.to_unsigned_order(jnp.asarray(x), bits=bits)
    want = np.asarray(grouped_median_pallas(
        u, jnp.asarray(assign), jnp.ones((n,), jnp.float32), k, bits=bits,
        interpret=True)).astype(np.int64)
    expect, counts = ref.grouped_median_ref(x, assign, k)
    for med, tot in _forms(_words(x, bits), T(assign), k, None, bits):
        np.testing.assert_array_equal(med.numpy(), want)
        np.testing.assert_array_equal(tot.numpy(), counts.astype(np.float32))
        got = _signed(med, bits)
        for c in range(k):
            if counts[c] > 0:
                np.testing.assert_array_equal(got[c], expect[c])
            else:
                np.testing.assert_array_equal(med[c].numpy(), 0)


@pytest.mark.parametrize("bits", [16, 32])
def test_integer_weights_with_zeros(bits):
    """Cluster counts as weights (zeros included): the serve's compaction
    weights.  Equal to the interpret-mode Pallas kernel and, per cluster,
    to the weighted lower-median oracle."""
    rng = np.random.default_rng(bits + 5)
    n, d, k = 60, 9, 5
    x = rng.integers(-500, 500, size=(n, d)).astype(np.int32)
    assign = rng.integers(0, k, size=(n,)).astype(np.int32)
    w = rng.integers(0, 2000, size=(n,)).astype(np.float32)
    w[rng.random(n) < 0.3] = 0.0
    u = quantizer.to_unsigned_order(jnp.asarray(x), bits=bits)
    want = np.asarray(grouped_median_pallas(
        u, jnp.asarray(assign), jnp.asarray(w), k, bits=bits,
        interpret=True)).astype(np.int64)
    for med, tot in _forms(_words(x, bits), T(assign), k, T(w), bits):
        np.testing.assert_array_equal(med.numpy(), want)
        got = _signed(med, bits)
        for c in range(k):
            sel = (assign == c) & (w > 0)
            np.testing.assert_array_equal(tot[c].numpy(), w[assign == c].sum())
            if sel.any():
                np.testing.assert_array_equal(
                    got[c].astype(np.float64),
                    ref.weighted_lower_median_ref(
                        x[sel].astype(np.float64), w[sel]))


def test_weighted_single_cluster():
    """tests/test_kernels.py::test_weighted on every form."""
    rng = np.random.default_rng(7)
    x = rng.integers(-50, 50, size=(12, 5)).astype(np.int32)
    w = rng.integers(1, 4, size=(12,)).astype(np.float32)
    assign = np.zeros((12,), np.int32)
    expect = ref.weighted_lower_median_ref(x.astype(np.float64), w)
    for med, _ in _forms(_words(x, 32), T(assign), 1, T(w), 32):
        np.testing.assert_array_equal(_signed(med, 32)[0].astype(np.float64),
                                      expect)


@pytest.mark.parametrize("bits", [16, 32])
def test_batched_equals_members_one_at_a_time(bits):
    """Leading dimensions are independent members (the serve's (layer,
    slot, head) groups)."""
    rng = np.random.default_rng(3)
    x = rng.integers(-900, 900, size=(3, 4, 40, 6)).astype(np.int32)
    assign = rng.integers(0, 7, size=(3, 4, 40)).astype(np.int32)
    w = rng.integers(0, 5, size=(3, 4, 40)).astype(np.float32)
    u = _words(x, bits)
    batched = _forms(u, T(assign), 7, T(w), bits)
    for i in range(3):
        for j in range(4):
            one = bitserial_t.grouped_median_bits(
                u[i, j], T(assign[i, j]), 7, weights=T(w[i, j]), bits=bits)
            for med, tot in batched:
                np.testing.assert_array_equal(med[i, j].numpy(),
                                              one[0].numpy())
                np.testing.assert_array_equal(tot[i, j].numpy(),
                                              one[1].numpy())


def test_ops_matches_reference_ops():
    """tests/test_kernels.py::test_matches_pure_jax_path across packages:
    the port's wrapper on CPU tensors against the reference's wrapper."""
    rng = np.random.default_rng(11)
    x = rng.integers(-(2 ** 10), 2 ** 10, size=(40, 9)).astype(np.int32)
    assign = rng.integers(0, 5, size=(40,)).astype(np.int32)
    med, tot = ops.grouped_median_bits(quantizer.to_unsigned_order(
        jnp.asarray(x)), jnp.asarray(assign), 5, interpret=True)
    med_t, tot_t = ops_t.grouped_median_bits(_words(x, 32), T(assign), 5)
    assert med_t.dtype == torch.int64 and tot_t.dtype == torch.float32
    np.testing.assert_array_equal(med_t.numpy(),
                                  np.asarray(med).astype(np.int64))
    np.testing.assert_array_equal(tot_t.numpy(), np.asarray(tot))


def test_float_front_ends_reach_the_wrapper(monkeypatch):
    """grouped_median and the unweighted median go through
    ops.grouped_median_bits (so on the card they launch the kernel)."""
    calls = []
    real = ops_t.grouped_median_bits

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops_t, "grouped_median_bits", spy)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(30, 4))
                         .astype(np.float32))
    bitserial_t.grouped_median(x, torch.zeros(30, dtype=torch.int32), 2)
    med = bitserial_t.median(x, bits=32)
    assert calls == [(30, 4), (30, 4)]
    spec = quantizer_t.FixedPointSpec(bits=32,
                                      scale=quantizer_t.auto_scale(x, 32))
    u = quantizer_t.to_unsigned_order(quantizer_t.quantize(x, spec), 32)
    want = quantizer_t.dequantize(quantizer_t.from_unsigned_order(
        bitserial_t.median_bits(u, bits=32), 32), spec)
    np.testing.assert_array_equal(med.numpy(), want.numpy())


@pytest.mark.parametrize("shape", [(41,), (41, 5)])
def test_weighted_median_matches_reference(shape):
    """median with one integer weight per point ((N,) or (N, 1)) goes
    through the grouped wrapper and equals the reference's median_bits
    path bit for bit."""
    from repro.core import bitserial

    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.integers(0, 5, size=shape[:1] + (1,) * (len(shape) - 1))
    w = w.astype(np.float32)
    want = np.asarray(bitserial.median(jnp.asarray(x), bits=32,
                                       weights=jnp.asarray(w)))
    got = bitserial_t.median(T(x), bits=32, weights=T(w)).numpy()
    np.testing.assert_array_equal(got, want)


def test_median_rejects_per_element_weights():
    x = torch.zeros(6, 3)
    with pytest.raises(ValueError, match="one weight per point"):
        bitserial_t.median(x, weights=torch.ones(6, 3))


def test_cpu_tensors_never_launch_the_kernel():
    ops_t.reset_launches()
    ops_t.grouped_median_bits(torch.zeros(4, 2, dtype=torch.int64),
                              torch.zeros(4, dtype=torch.int32), 2)
    assert ops_t.launch_counts()["bitserial_median"] == 0


# the kernel's two selections: the resident form (one bit a digit, one
# chunk) and the streamed form (four-bit digits, partials over chunks)
DIGIT_FORMS = [(1, 0), (4, 0), (4, 7), (3, 16)]


def _skewed_case(rng, n, d, k, bits, skew, zero_frac, levels):
    """Words from ``levels`` distinct values (ties), assignments with a
    share ``skew`` of the points in cluster 0, integer weights with a
    share ``zero_frac`` of zeros."""
    vals = rng.integers(0, 2 ** bits, size=levels, dtype=np.int64)
    u = vals[rng.integers(0, levels, size=(n, d))]
    assign = rng.integers(0, k, size=n).astype(np.int32)
    assign[rng.random(n) < skew] = 0
    w = rng.integers(1, 50, size=n).astype(np.float32)
    w[rng.random(n) < zero_frac] = 0.0
    return u, assign, w


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 90), st.integers(1, 9), st.integers(1, 9),
       st.sampled_from([1, 13, 16, 32]), st.sampled_from([0.0, 0.9]),
       st.sampled_from([0.0, 0.5, 1.0]), st.integers(1, 6),
       st.sampled_from(DIGIT_FORMS), st.integers(0, 2 ** 31))
def test_digit_selection_equals_plain(n, d, k, bits, skew, zero_frac, levels,
                                      form, seed):
    """Bit for bit (medians and totals) against the plain per-bit one-hot
    form; clusters with no point or only zero weights give the word 0."""
    digit, chunk = form
    rng = np.random.default_rng(seed)
    u, assign, w = _skewed_case(rng, n, d, k, bits, skew, zero_frac, levels)
    want = bsm_t.grouped_median_bits_plain(T(u), T(assign), k,
                                           weights=T(w), bits=bits)
    got = bsm_t.grouped_median_digits(T(u), T(assign), k, T(w), bits=bits,
                                      digit=digit, chunk=chunk)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    empty = want[1].numpy() == 0
    assert (got[0].numpy()[empty] == 0).all()


@pytest.mark.parametrize("bits", [1, 13, 16, 32])
@pytest.mark.parametrize("digit,chunk", DIGIT_FORMS)
def test_digit_selection_matches_pallas(bits, digit, chunk):
    """A skewed case (90 % of the points in one cluster, ties, a third of
    the weights 0, K = 6 with empty clusters likely) against the
    reference's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(bits * 10 + digit + chunk)
    n, d, k = 48, 5, 6
    u, assign, w = _skewed_case(rng, n, d, k, bits, 0.9, 0.33, 4)
    want = np.asarray(grouped_median_pallas(
        jnp.asarray(u.astype(np.uint32)), jnp.asarray(assign),
        jnp.asarray(w), k, bits=bits, interpret=True)).astype(np.int64)
    got, tot = bsm_t.grouped_median_digits(T(u), T(assign), k, T(w),
                                           bits=bits, digit=digit,
                                           chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tot.numpy(), np.bincount(assign, weights=w, minlength=k)
        .astype(np.float32))


@pytest.mark.parametrize("digit,chunk", DIGIT_FORMS)
def test_digit_selection_single_cluster_and_batch(digit, chunk):
    """K = 1 (the unweighted median's path) and leading member dimensions,
    each member on its own."""
    rng = np.random.default_rng(digit + chunk)
    x = rng.integers(0, 2 ** 16, size=(3, 2, 30, 4), dtype=np.int64)
    w = rng.integers(0, 3, size=(3, 2, 30)).astype(np.float32)
    a = np.zeros((3, 2, 30), np.int32)
    got, _ = bsm_t.grouped_median_digits(T(x), T(a), 1, T(w), bits=16,
                                         digit=digit, chunk=chunk)
    for i in range(3):
        for j in range(2):
            want, _ = bitserial_t.grouped_median_bits(
                T(x[i, j]), T(a[i, j]), 1, weights=T(w[i, j]), bits=16)
            np.testing.assert_array_equal(got[i, j].numpy(), want.numpy())


def test_resident_and_streamed_shared_memory_sizes():
    """The wrapper's form choice at the serve's and the fit's shapes: the
    compaction and absorb members (320 points x 128 dims, K = 64 / 32)
    stage whole; 2^20 points stream (their scratch, which the kernel's
    library sizes, is checked on the card in test_torch_gpu.py)."""
    assert bsm_t.resident_bytes(320, 128, 64) <= bsm_t.RESIDENT_MAX_BYTES
    assert bsm_t.resident_bytes(320, 128, 32) <= bsm_t.RESIDENT_MAX_BYTES
    assert bsm_t.resident_bytes(1 << 20, 16, 64) > bsm_t.RESIDENT_MAX_BYTES
