"""The hand-written CUDA kernels against their plain PyTorch versions on
the card (sm_90).  Marked ``gpu``; without a Hopper card every test skips
(decided inside the fixture, never at import).  Run on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitserial_median as bsm
from repro_torch.kernels import clustered_decode as cd
from repro_torch.kernels import distance_argmin as da
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.kernels import paged_clustered_decode as pcd

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs compute capability 9.0 (sm_90a kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _decode_inputs(dev, dtype, b, l, hq, hkv, dh, c, r, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)  # noqa: E731
    counts = torch.randint(0, 4, (b, c, hkv), generator=g).float().to(dev)
    return (f(b, l, hq, dh), f(b, c, hkv, dh), f(b, c, hkv, dh), counts,
            f(b, r, hkv, dh), f(b, r, hkv, dh))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("shape", [(3, 5, 4, 2, 16, 6, 16),
                                   (4, 64, 32, 8, 128, 64, 256)])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_clustered_decode_kernel_matches_plain(cuda, dtype, tol, shape,
                                               softcap):
    b, l, hq, hkv, dh, c, r = shape
    args = _decode_inputs(cuda, dtype, b, l, hq, hkv, dh, c, r)
    t = torch.tensor([r // 2, 4 * r, 5 * r + 3, 7][:b], dtype=torch.int32,
                     device=cuda)
    cl = torch.tensor([l, l, 1, 1][:b], dtype=torch.int32, device=cuda)
    cov = torch.clamp(t + cl - r, min=0) + torch.tensor(
        [0, 3, 5, 2][:b], dtype=torch.int32, device=cuda)
    cov = torch.minimum(cov, t).to(torch.int32)
    got = cd.clustered_decode_cuda(*args, t, cov, cl, scale=dh ** -0.5,
                                   softcap=softcap)
    # plain in f32 on the same (rounded) inputs, then cast like the kernel
    want = cd.clustered_decode_plain(*(a.float() for a in args), t, cov, cl,
                                     scale=dh ** -0.5,
                                     softcap=softcap).to(dtype)
    torch.cuda.synchronize()
    for bi in range(b):
        n = int(cl[bi])
        torch.testing.assert_close(got[bi, :n].float(), want[bi, :n].float(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_distance_argmin_kernel_matches_plain(cuda, metric):
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(10_000, 16, generator=g).to(cuda)
    c = torch.randn(64, 16, generator=g).to(cuda)
    c[5] = c[2]                                 # duplicate: first index wins
    a, m = da.distance_argmin_cuda(x, c, metric=metric)
    a0, m0 = da.distance_argmin_plain(x, c, metric=metric)
    torch.cuda.synchronize()
    assert (a == 5).sum() == 0
    agree = (a == a0).float().mean().item()
    assert agree >= 0.9999, agree
    torch.testing.assert_close(m, m0, rtol=1e-5, atol=1e-5)


def _check_distance(x, c, tag):
    """L1 bit for bit with the sequential twin on the card; L2 as the
    phase-3 gate holds it: >= 99.99 % of assignments equal the plain
    version's, mindist within 1e-5."""
    a, m = da.distance_argmin_cuda(x, c, metric="l1")
    a_t, m_t = da.distance_argmin_sequential(x, c, metric="l1")
    a2, m2 = da.distance_argmin_cuda(x, c, metric="l2")
    a0, m0 = da.distance_argmin_plain(x, c, metric="l2")
    torch.cuda.synchronize()
    assert torch.equal(a, a_t), tag
    assert torch.equal(m.view(torch.int32), m_t.view(torch.int32)), tag
    agree = (a2 == a0).float().mean().item()
    assert agree >= 0.9999, (tag, agree)
    torch.testing.assert_close(m2, m0, rtol=1e-5, atol=1e-5)
    return a, a2


def _points(dev, n, d, k, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(n, d, generator=g).to(dev),
            torch.randn(k, d, generator=g).to(dev))


@pytest.mark.parametrize("k", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("d", [1, 8, 12, 16, 17, 128, 300])
def test_distance_argmin_widths_and_banks(cuda, d, k):
    """Widths of one 16-dim chunk and of several (a ragged last chunk at
    17 and 300) against banks on either side of the 64-centroid tile, N not
    a multiple of the 128-point block."""
    x, c = _points(cuda, 3001, d, k, seed=d * 7 + k)
    _check_distance(x, c, (d, k))


def test_distance_argmin_bank_the_old_kernel_refused(cuda):
    """K = 4,096 x D = 128: 2 MB of centroids, over the 232,448 bytes of
    shared memory the first design needed the whole bank to fit in."""
    x, c = _points(cuda, 5000, 128, 4096, seed=3)
    _check_distance(x, c, "4096 x 128")


@pytest.mark.parametrize("d", [16, 17])
def test_distance_argmin_duplicates_across_tiles(cuda, d):
    """Duplicated centroids in one thread's group, in two groups of one
    tile and across tiles (c[70] = c[40] = c[3], c[129] = c[100]), with
    points placed on them: the first index wins in both metrics."""
    x, c = _points(cuda, 1000, d, 130, seed=5)
    c[40] = c[3]
    c[70] = c[3]
    c[129] = c[100]
    x[:300] = c[3]
    x[300:400] = c[100]
    a, a2 = _check_distance(x, c, d)
    for got in (a, a2):
        assert (got[:300] == 3).all() and (got[300:400] == 100).all()


def test_distance_argmin_rows_without_a_finite_distance(cuda):
    """Rows of inf or NaN: (inf, 0) in L1, as the sequential rule gives;
    L2 as its twin (the clamp's fmaxf turns a NaN into 0)."""
    x, c = _points(cuda, 300, 12, 70, seed=6)
    x[5, 3] = float("inf")
    x[6] = float("nan")
    x[7, 0] = float("-inf")
    for metric in ("l1", "l2"):
        a, m = da.distance_argmin_cuda(x, c, metric=metric)
        a_t, m_t = da.distance_argmin_sequential(x, c, metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(a[5:8], a_t[5:8]), metric
        assert torch.equal(m[5:8], m_t[5:8]), metric
    a, m = da.distance_argmin_cuda(x, c, metric="l1")
    assert a[5:8].tolist() == [0, 0, 0]
    assert torch.isinf(m[5:8]).all()


def test_distance_argmin_two_runs_equal(cuda):
    x, c = _points(cuda, 1 << 16, 16, 64, seed=7)
    for metric in ("l1", "l2"):
        a, m = da.distance_argmin_cuda(x, c, metric=metric)
        b, n = da.distance_argmin_cuda(x, c, metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        assert torch.equal(m.view(torch.int32), n.view(torch.int32))


def test_distance_argmin_shared_memory_fits_a_block(cuda):
    from repro_torch.kernels import _build

    assert (0 < _build.query("distance_argmin_shared_bytes")
            < _build.MAX_SHARED_BYTES)


def _paged_view(dev, dense, t, cl, cov, bs, seed=0):
    """The dense kernel's inputs as packed paged rows: each slot's ring
    scattered into pool blocks through a shuffled block table, unmapped
    pool blocks holding garbage, one row per valid (slot, chunk row) and
    two padding rows (qpos1 0).  Returns (paged args, [(slot, row)])."""
    q, kc, vc, counts, kt, vt = dense
    b, r, hkv, dh = kt.shape
    nt = r // bs
    g = torch.Generator(device="cpu").manual_seed(seed)
    nb = b * nt + 3
    perm = torch.randperm(nb, generator=g)[:b * nt].reshape(b, nt)
    bt = perm.to(torch.int32).to(dev)
    pools = []
    for tail in (kt, vt):
        pool = torch.randn(nb, bs, hkv, dh, generator=g).to(dev, tail.dtype)
        pool[bt.long()] = tail.reshape(b, nt, bs, hkv, dh)
        pools.append(pool)
    rows = [(bi, i) for bi in range(b) for i in range(int(cl[bi]))]
    slot = torch.tensor([bi for bi, _ in rows] + [0, 0], dtype=torch.int32,
                        device=dev)
    qp = torch.cat([torch.stack([q[bi, i] for bi, i in rows]),
                    q.new_zeros(2, *q.shape[2:])])
    pos = torch.tensor([int(t[bi]) + i for bi, i in rows] + [-1, -1],
                       device=dev)
    qpos1 = torch.where(pos >= 0, pos + 1, 0).to(torch.int32)
    tw = (t + cl).to(torch.int32)[slot.long()]
    return (qp, kc, vc, counts, pools[0], pools[1], slot,
            bt[slot.long()].contiguous(), qpos1, tw,
            cov[slot.long()].contiguous()), rows


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_paged_kernel_matches_plain_and_dense(cuda, dtype, tol, softcap):
    """B2 against its plain version, bit-equal to B1 on every real row,
    and the window floor: (cov, wlo) == (max(cov, wlo), 0) exactly."""
    b, l, hq, hkv, dh, c, r, bs = 4, 64, 32, 8, 128, 64, 256, 16
    dense = _decode_inputs(cuda, dtype, b, l, hq, hkv, dh, c, r)
    t = torch.tensor([100, 1000, 300, 50], dtype=torch.int32, device=cuda)
    cl = torch.tensor([l, l, 1, 1], dtype=torch.int32, device=cuda)
    cov = torch.tensor([0, 900, 60, 10], dtype=torch.int32, device=cuda)
    args, rows = _paged_view(cuda, dense, t, cl, cov, bs)
    kw = dict(scale=dh ** -0.5, softcap=softcap)
    got = pcd.paged_clustered_decode_cuda(*args, **kw)
    want = pcd.paged_clustered_decode_plain(
        *(a.float() if a.is_floating_point() else a for a in args),
        **kw).to(dtype)
    ref = cd.clustered_decode_cuda(*dense, t, cov, cl, **kw)
    torch.cuda.synchronize()
    n = len(rows)
    torch.testing.assert_close(got[:n].float(), want[:n].float(), rtol=tol,
                               atol=tol)
    assert torch.isfinite(got).all()
    for ri, (bi, i) in enumerate(rows):
        assert torch.equal(got[ri], ref[bi, i]), (bi, i)
    wlo = torch.zeros_like(args[-1])
    wlo[::3] = args[-1][::3] + 7
    wlo[1::3] = torch.clamp(args[-1][1::3] - 5, min=0)
    floor = pcd.paged_clustered_decode_cuda(*args, wlo, **kw)
    merged = pcd.paged_clustered_decode_cuda(
        *args[:-1], torch.maximum(args[-1], wlo), torch.zeros_like(wlo),
        **kw)
    torch.cuda.synchronize()
    assert torch.equal(floor[:n], merged[:n])


def test_wrappers_count_launches(cuda):
    ops.reset_launches()
    x = torch.randn(100, 4, device=cuda)
    ops.distance_argmin(x, x[:3].contiguous())
    counts = ops.launch_counts()
    assert counts["distance_argmin"] == counts["distance_argmin l2"] == 1
    assert counts["distance_argmin l1"] == 0


@pytest.mark.parametrize("lead,n,d,k,bits,weighted", [
    ((3, 4), 320, 128, 64, 16, True),      # compaction members (resident)
    ((), 1500, 12, 3, 32, False),          # the quickstart's table
    ((2,), 37, 130, 5, 32, True),          # a partial column tile
    ((), 20_000, 16, 64, 32, False),       # streamed form
    ((2,), 9_000, 40, 7, 16, True)])       # streamed, batched, two tiles
def test_bitserial_median_kernel_equals_plain(cuda, lead, n, d, k, bits,
                                              weighted):
    """Integer weights (counts with zeros) and unit weights: bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(n + d)
    u = torch.randint(0, 2 ** bits, lead + (n, d), generator=g)
    a = torch.randint(0, k, lead + (n,), generator=g, dtype=torch.int32)
    w = None
    if weighted:
        w = torch.randint(0, 2000, lead + (n,), generator=g).float()
        w[torch.rand(lead + (n,), generator=g) < 0.2] = 0.0
    u, a = u.to(cuda), a.to(cuda)
    w = None if w is None else w.to(cuda)
    med, tot = bsm.grouped_median_bits_cuda(u, a, k, w, bits=bits)
    med0, tot0 = bsm.grouped_median_bits_plain(u, a, k, weights=w, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(med, med0)
    assert torch.equal(tot, tot0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, None)])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_flash_decode_kernel_matches_plain(cuda, dtype, tol, softcap):
    """f32 within ``tol``; bf16 within 2 bf16 ulps of each plain value
    (2^(e - 8) per ulp for |x| = m 2^e, m in [0.5, 1)), plus 1e-6 for f32
    sums near 0."""
    g = torch.Generator(device="cpu").manual_seed(2)
    b, s, hq, hkv, dh, t = 2, 700, 8, 2, 128, 600
    q, k, v = (torch.randn(*sh, generator=g).to(cuda, dtype)
               for sh in ((b, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    got = fd.flash_decode_cuda(q, k, v, t, scale=dh ** -0.5, softcap=softcap)
    want = fd.flash_decode_plain(q.float(), k.float(), v.float(), t,
                                 scale=dh ** -0.5,
                                 softcap=softcap).to(dtype)
    torch.cuda.synchronize()
    if tol is not None:
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        return
    g, r = got.float(), want.float()
    _, e = torch.frexp(r.abs().clamp(min=2.0 ** -20))
    ulp = torch.ldexp(torch.ones_like(r), e - 8)
    assert ((g - r).abs() <= 2 * ulp + 1e-6).all()


@pytest.mark.parametrize("lead,k,streamed", [((36, 4, 8), 64, False),
                                              ((36, 8), 32, False),
                                              ((), 64, True)])
def test_bitserial_median_serve_shapes_repeat(cuda, lead, k, streamed):
    """The compaction and absorb members (320 points x 128 dims, 16 bits,
    count and 0/1 mask weights) and the fit's streamed shape (2^20 x 16,
    32 bits, 0/1 weights): equal to the plain version and two runs equal,
    with one member whose points all lie in cluster 0 and cluster 1 of
    weight 0 in every member."""
    g = torch.Generator(device="cpu").manual_seed(k + len(lead))
    n, d, bits = ((1 << 20, 16, 32) if streamed else (320, 128, 16))
    u = torch.randint(0, 2 ** bits, lead + (n, d), generator=g)
    a = torch.randint(0, k, lead + (n,), generator=g, dtype=torch.int32)
    # integer weights with totals below 2^24: counts then 0/1 masks per
    # member, 0/1 masks over the 2^20 streamed points
    w = torch.randint(0, 2, lead + (n,), generator=g).float()
    if not streamed:
        w[..., :64] = torch.randint(0, 2000, lead + (64,), generator=g)
    a.view(-1, n)[0] = 0
    w[a == 1] = 0.0
    u, a, w = u.to(cuda), a.to(cuda), w.to(cuda)
    runs = [bsm.grouped_median_bits_cuda(u, a, k, w, bits=bits)
            for _ in range(2)]
    med0, tot0 = bsm.grouped_median_bits_plain(u, a, k, weights=w, bits=bits)
    torch.cuda.synchronize()
    for med, tot in runs:
        assert torch.equal(med, med0)
        assert torch.equal(tot, tot0)
    assert (runs[0][0][..., 1, :] == 0).all()



def test_bitserial_median_stream_scratch_size(cuda):
    """The streamed form's scratch as the kernel's library sizes it: the
    words' low 32 bits, then the chunk partials, far below the words at
    the fit's shape; none for the resident form."""
    from repro_torch.kernels import _build

    q = lambda *a: _build.query("bitserial_median_scratch_bytes",  # noqa
                                *a)
    n, d, k, chunk = 1 << 20, 16, 64, bsm.STREAM_CHUNK
    words = 4 * n * d
    partials = 4 * (n // chunk) * k * (16 * d + 1)
    assert q(1, n, d, k, chunk) == words + partials + 4 * k * d
    assert words < q(1, n, d, k, chunk) < 2 * words
    assert q(3, n, d, k, chunk) == 3 * q(1, n, d, k, chunk)
    assert q(36, 320, 128, 64, 0) == 0


FD_EDGES = (0, 1, 511, 512, 1500, 2048, 2300)


@pytest.mark.parametrize("case", ["f32", "f32_softcap50", "bf16"])
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_flash_decode_kernel_edges(cuda, g, dh, case):
    """S = 2048 (a multiple of the default chunk 512), t at 0, 1, 511, 512,
    1500, S and past S: f32 (+- softcap 50) within 1e-5 of the plain
    version, bf16 within 2 bf16 ulps (+1e-6), two runs equal; and S = 700
    (padded to 1024) at t = 0, 800 and 2000, where the padding counts."""
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    softcap = 50.0 if case == "f32_softcap50" else None
    gen = torch.Generator(device="cpu").manual_seed(g * dh)
    for s, edges in ((2048, FD_EDGES), (700, (0, 800, 2000))):
        q, k, v = (torch.randn(*sh, generator=gen).to(cuda, dtype)
                   for sh in ((2, 2 * g, dh), (2, s, 2, dh), (2, s, 2, dh)))
        for t in edges:
            kw = dict(scale=dh ** -0.5, softcap=softcap)
            got = fd.flash_decode_cuda(q, k, v, t, **kw)
            again = fd.flash_decode_cuda(q, k, v, t, **kw)
            want = fd.flash_decode_plain(q.float(), k.float(), v.float(), t,
                                         **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (s, t)
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
                continue
            r = want.to(dtype).float()
            _, e = torch.frexp(r.abs().clamp(min=2.0 ** -20))
            ulp = torch.ldexp(torch.ones_like(r), e - 8)
            assert ((got.float() - r).abs() <= 2 * ulp + 1e-6).all(), (s, t)


def test_fit_on_card_runs_both_clustering_kernels(cuda):
    """A k-medians fit from a threefry k-means++ start: distance_argmin and
    bitserial_median both launch, and the fit equals the CPU fit."""
    from repro_torch.core import clustering, prng

    g = torch.Generator(device="cpu").manual_seed(0)
    centers = torch.randn(6, 8, generator=g) * 6
    x = (centers[torch.randint(0, 6, (3000,), generator=g)]
         + torch.randn(3000, 8, generator=g))
    cfg = clustering.ClusterConfig(k=6, metric="l1", max_iters=8)
    init = clustering.init_kmeanspp(prng.PRNGKey(0), x, 6, "l1")
    init_c = clustering.init_kmeanspp(prng.PRNGKey(0), x.to(cuda), 6, "l1")
    assert torch.equal(init_c.cpu(), init)
    ops.reset_launches()
    res = clustering.fit(x.to(cuda), cfg, init_c)
    counts = ops.launch_counts()
    assert counts["distance_argmin"] > 0 and counts["bitserial_median"] > 0
    ref = clustering.fit(x, cfg, init)
    assert torch.equal(res.assign.cpu(), ref.assign)
    assert torch.equal(res.centroids.cpu(), ref.centroids)


def test_new_wrappers_count_launches(cuda):
    ops.reset_launches()
    u = torch.randint(0, 2 ** 16, (50, 4), device=cuda)
    ops.grouped_median_bits(u, torch.zeros(50, dtype=torch.int32,
                                           device=cuda), 2, bits=16)
    q = torch.randn(1, 4, 16, device=cuda)
    kv = torch.randn(1, 40, 2, 16, device=cuda)
    ops.flash_decode(q, kv, kv, 30, scale=0.25)
    counts = ops.launch_counts()
    assert counts["bitserial_median"] == 1 and counts["flash_decode"] == 1


def _edge_slots(dev, b, l, r, one_token=False):
    """t, chunk_len, cov per slot: a full chunk, a wrapped decode row, and
    chunks of odd lengths; cov within the ring's live window."""
    cl = [1] * b if one_token else [l, 1, max(1, l - 2), 1][:b]
    t = [r // 2, 3 * r + 5, r + 1, 7][:b]
    cov = [max(0, ti + ci - r) + (i % 3) for i, (ti, ci) in
           enumerate(zip(t, cl))]
    cov = [min(cv, ti) for cv, ti in zip(cov, t)]
    as_t = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    return as_t(t), as_t(cl), as_t(cov)


def _check_dense_and_paged(dev, dtype, tol, dense, t, cl, cov, bs=16,
                           split=None, one_token=False):
    """B1 against its plain version on the valid rows; B2 on the same data
    against its plain version and bit-equal to B1 on every real row, with
    the engine's row groups (``group_rows``), one row per block, and
    ``split`` (a list of group sizes cut from the packed rows, in order)
    when given."""
    b, _, hq, dh = dense[0].shape
    hkv = dense[1].shape[2]
    kw = dict(scale=dh ** -0.5, softcap=None)
    q1 = dense[0][:, 0].contiguous() if one_token else dense[0]
    got = cd.clustered_decode_cuda(q1, *dense[1:], t, cov,
                                   None if one_token else cl, **kw)
    want = cd.clustered_decode_plain(
        q1.float(), *(a.float() for a in dense[1:]), t, cov,
        None if one_token else cl, **kw).to(dtype)
    if one_token:
        got, want = got[:, None], want[:, None]
    args, rows = _paged_view(dev, tuple(dense), t, cl, cov, bs)
    torch.cuda.synchronize()
    for bi in range(b):
        n = int(cl[bi])
        torch.testing.assert_close(got[bi, :n].float(), want[bi, :n].float(),
                                   rtol=tol, atol=tol)
    n = len(rows)
    ref = torch.stack([got[bi, i] for bi, i in rows])
    slot, qpos1, tw = (args[6].cpu().numpy(), args[8].cpu().numpy(),
                       args[9].cpu().numpy())
    tables = {"engine": torch.from_numpy(
        pcd.group_rows(slot, qpos1, tw, hq // hkv)).to(dev), "alone": None}
    if split is not None:
        starts = [sum(split[:k]) for k in range(len(split))]
        grp = torch.full((len(slot),), -1, dtype=torch.int32)
        grp[:len(split)] = torch.tensor(
            [(s << pcd.GROUP_SHIFT) | c for s, c in zip(starts, split)])
        tables["split"] = grp.to(dev)
    want_p = pcd.paged_clustered_decode_plain(
        *(a.float() if a.is_floating_point() else a for a in args),
        **kw).to(dtype)
    for name, grp in tables.items():
        out = pcd.paged_clustered_decode_cuda(*args, row_group=grp, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out[:n].float(), want_p[:n].float(),
                                   rtol=tol, atol=tol)
        assert torch.isfinite(out).all(), name
        assert torch.equal(out[:n], ref), name
        assert not out[n:].any(), name          # padding rows: zeros


EDGE_SHAPES = {                  # b, l, hq, hkv, dh, c, r
    "few_tiles": (3, 5, 4, 2, 16, 6, 16),      # C + R = 22: 2 tiles, 4 warps
    "g1": (2, 9, 4, 4, 64, 10, 48),
    "g8": (2, 5, 16, 2, 64, 20, 32),
    "g16": (2, 3, 32, 2, 128, 33, 64),
    "dh64": (2, 7, 8, 2, 64, 40, 80),
    "dh256": (2, 6, 8, 2, 256, 17, 48),
}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("shape", list(EDGE_SHAPES))
def test_decode_kernels_at_edge_shapes(cuda, dtype, tol, shape):
    """C + R not a multiple of the tile, fewer tiles than warps, g = 1, 8
    and 16, Dh 64 and 256: B1 and B2 against their plain versions, B2
    bit-equal to B1 on every real row."""
    b, l, hq, hkv, dh, c, r = EDGE_SHAPES[shape]
    dense = _decode_inputs(cuda, dtype, b, l, hq, hkv, dh, c, r, seed=5)
    t, cl, cov = _edge_slots(cuda, b, l, r)
    _check_dense_and_paged(cuda, dtype, tol, dense, t, cl, cov)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("b", [1, 2])
def test_decode_kernels_one_token_small_buckets(cuda, dtype, tol, b):
    """The one-token form at the engine's shrunk buckets (B = 1, 2) at
    qwen3-4b's heads (32 / 8 of 128)."""
    dense = _decode_inputs(cuda, dtype, b, 1, 32, 8, 128, 64, 256, seed=6)
    t, cl, cov = _edge_slots(cuda, b, 1, 256, one_token=True)
    _check_dense_and_paged(cuda, dtype, tol, dense, t, cl, cov,
                           one_token=True)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
def test_decode_kernels_rows_with_every_entry_masked(cuda, dtype, tol):
    """Slot 0 has no live centroid and a frontier past its rows: every
    entry of its rows is masked, so each gives the uniform average over
    all C + R entries, as the plain version does."""
    b, l, hq, hkv, dh, c, r = 3, 6, 8, 2, 64, 12, 32
    dense = list(_decode_inputs(cuda, dtype, b, l, hq, hkv, dh, c, r,
                                seed=7))
    dense[3][0] = 0.0                              # counts of slot 0
    t, cl, cov = _edge_slots(cuda, b, l, r)
    cov[0] = t[0] + cl[0]                          # ring hidden from slot 0
    _check_dense_and_paged(cuda, dtype, tol, tuple(dense), t, cl, cov)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
def test_paged_slot_spanning_groups(cuda, dtype, tol):
    """A slot's 7 chunk rows at g = 4 span two groups (4 + 3 as the engine
    cuts them, and 3 + 4 + ... cut by hand, so a row sits at another place
    in its block than in B1's): every real row stays bit-equal to B1."""
    b, l, hq, hkv, dh, c, r = 2, 7, 32, 8, 128, 64, 256
    dense = _decode_inputs(cuda, dtype, b, l, hq, hkv, dh, c, r, seed=8)
    t, cl, cov = _edge_slots(cuda, b, l, r)
    _check_dense_and_paged(cuda, dtype, tol, dense, t, cl, cov,
                           split=[3, 4, 1, 1, 1])


# ---------------------------------------------------------------------------
# blocking admission and the static engine on the card
# ---------------------------------------------------------------------------


def _tiny():
    from repro_torch.models.config import ModelConfig

    return ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                       vocab=64, pad_vocab_multiple=16, dtype="float32")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_prefill_card_matches_cpu(cuda):
    """The reduced qwen3 in f32: a right-padded prompt's logits at
    last_pos and the exact B=1 cache, card against CPU."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"),
                              dtype="float32")
    params = tfm.init_params(0, cfg, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 40),
                        generator=torch.Generator().manual_seed(0))
    want, cache = tfm.prefill(params, cfg, tok, max_seq=64, last_pos=29)
    got, cache_c = tfm.prefill(_to(params, cuda), cfg, tok.to(cuda),
                               max_seq=64, last_pos=29)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for lc, lg in zip(cache["layers"], cache_c["layers"]):
        for key in ("k", "v"):
            torch.testing.assert_close(lg[key].cpu(), lc[key], rtol=1e-4,
                                       atol=1e-4)


def test_write_slot_paged_drops_covered_offsets(cuda):
    """A blocking admission's ring goes into the slot's mapped blocks
    only: covered ring blocks (n_blocks in the write row) are dropped, and
    every block outside the row keeps its bytes."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server

    cfg, bs, r = _tiny(), 4, 16
    cache = tfm.init_cache(cfg, 2, 64, kv_mode="clustered", kv_clusters=4,
                           kv_tail=r, kv_pool_blocks=9, kv_block_size=bs,
                           device=cuda)
    g = torch.Generator(device="cpu").manual_seed(3)
    for leaf in cache["layers"]:
        for key in ("k_tail", "v_tail"):
            leaf[key].copy_(torch.randn(leaf[key].shape, generator=g))
    before = [{k: v.clone() for k, v in leaf.items()}
              for leaf in cache["layers"]]
    src = tfm.init_cache(cfg, 1, 64, kv_mode="clustered", kv_clusters=4,
                         kv_tail=r, device=cuda)
    for leaf in src["layers"]:
        for key, val in leaf.items():
            val.copy_(torch.randn(val.shape, generator=g).to(val.dtype)
                      if val.is_floating_point() else
                      torch.full(val.shape, 5, dtype=val.dtype))
    row = np.array([9, 6, 9, 2], np.int32)          # ring blocks 1 and 3
    Server._write_slot_paged(cache, src, 1, row, bs)
    for leaf, old, s in zip(cache["layers"], before, src["layers"]):
        for key in ("k_cents", "v_cents", "counts", "cov"):
            assert torch.equal(leaf[key][1], s[key][0])
            assert torch.equal(leaf[key][0], old[key][0])
        for key in ("k_tail", "v_tail"):
            ring = s[key][0].reshape(-1, bs, *s[key].shape[2:])
            assert torch.equal(leaf[key][6], ring[1])
            assert torch.equal(leaf[key][2], ring[3])
            for blk in set(range(9)) - {6, 2}:
                assert torch.equal(leaf[key][blk], old[key][blk]), blk


@pytest.mark.parametrize("paged", [False, True])
def test_tiny_blocking_serve_on_card(cuda, paged):
    """A blocking clustered serve of TINY on the card: the decode kernel
    of its engine launches once a layer an engine step, and the greedy
    tokens equal the CPU serve's."""
    from repro_torch.core.kv_compress import KVCompressConfig
    from repro_torch.core.request_cluster import Request
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = _tiny()
    params = tfm.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(9)
    spec = [(60, 12), (9, 10), (48, 9), (21, 14)]
    reqs = [Request(i, l, gn) for i, (l, gn) in enumerate(spec)]
    prompts = {i: rng.integers(0, 64, size=l).astype(np.int32)
               for i, (l, _) in enumerate(spec)}
    scfg = ServerConfig(batch_size=2, max_seq=96, kv_compress=KVCompressConfig(
        n_clusters=8, iters=4, keep_recent=16, refresh_every=8),
        paged=PagedKVConfig(block_size=4) if paged else None)
    toks = {}
    for dev in ("cpu", cuda):
        srv = Server(cfg, scfg, params, device=dev)
        ops.reset_launches()
        toks[str(dev)] = {o.uid: o.tokens for o in srv.serve(reqs, prompts)}
        counts = ops.launch_counts()
    st = dict(srv.last_stats, **srv.last_admission)
    kernel = "paged_clustered_decode" if paged else "clustered_decode"
    assert counts[kernel] == cfg.n_layers * st["decode_steps"]
    assert counts["bitserial_median"] >= (st["kv_admit_compress"]
                                          + st["kv_compactions"]) > 0
    assert toks["cpu"] == toks[str(cuda)]
    if paged:
        assert st["pool_blocks_end"] == 0.0


def test_tiny_static_serve_on_card(cuda):
    """The static engine on the card: the CPU's tokens, and no kernel."""
    from repro_torch.core.request_cluster import Request
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = _tiny()
    params = tfm.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    spec = [(5, 4), (23, 6), (9, 3), (17, 5), (6, 1), (21, 4)]
    reqs = [Request(i, l, gn) for i, (l, gn) in enumerate(spec)]
    prompts = {i: rng.integers(0, 64, size=l).astype(np.int32)
               for i, (l, _) in enumerate(spec)}
    scfg = ServerConfig(batch_size=4, max_seq=64, engine="static")
    want = {o.uid: o.tokens for o in
            Server(cfg, scfg, params, device="cpu").serve(reqs, prompts)}
    ops.reset_launches()
    got = {o.uid: o.tokens for o in
           Server(cfg, scfg, params, device=cuda).serve(reqs, prompts)}
    assert not any(ops.launch_counts().values())
    assert got == want


def test_int8_decode_on_card(cuda):
    """Decode over an int8 exact cache (per-head scales 0.05): card logits
    equal the CPU's within 1e-4, and the quantised cache bytes agree."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"),
                              dtype="float32")
    params = tfm.init_params(0, cfg, device="cpu")
    caches = [tfm.init_cache(cfg, 2, 32, kv_mode="int8", device=d)
              for d in ("cpu", cuda)]
    for c in caches:
        for leaf in c["layers"]:
            leaf["k_scale"].fill_(0.05)
            leaf["v_scale"].fill_(0.05)
    pg = _to(params, cuda)
    tok = torch.randint(0, cfg.vocab, (2, 8),
                        generator=torch.Generator().manual_seed(2))
    for t in range(8):
        want, _ = tfm.decode_step(params, cfg, caches[0], tok[:, t:t + 1], t)
        got, _ = tfm.decode_step(pg, cfg, caches[1], tok[:, t:t + 1].to(cuda),
                                 t)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for lc, lg in zip(caches[0]["layers"], caches[1]["layers"]):
        assert (lg["k"].cpu().int() - lc["k"].int()).abs().max() <= 1


# ---------------------------------------------------------------------------
# sliding-window layers and quota-paged exact KV on the card
# ---------------------------------------------------------------------------


def _glwin():
    from repro_torch.models.config import ModelConfig

    return ModelConfig(name="tiny-gl", family="dense", n_layers=2,
                       d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                       d_ff=64, vocab=64, pad_vocab_multiple=16,
                       dtype="float32", layer_pattern="GL",
                       sliding_window=16)


@pytest.mark.parametrize("mode", ["dense", "paged", "quota"])
def test_glwin_chunked_serve_on_card(cuda, mode):
    """GLWIN (the reference's tiny 'GL' config, window 16) served chunked
    on the card gives the CPU port's tokens: dense and paged clustered KV
    (the decode kernel of the mode once for the 'G' layer of every engine
    step), and paged exact KV under QuotaRetention (paged_clustered_decode
    over one dead centroid and a ring of max_seq, clustered_decode and
    bitserial_median never)."""
    from repro_torch.core.kv_compress import KVCompressConfig
    from repro_torch.core.request_cluster import Request
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = _glwin()
    params = tfm.init_params(7, cfg, device="cpu")
    rng = np.random.default_rng(13)
    spec = [(26, 10), (12, 6), (20, 8), (8, 5)]
    reqs = [Request(i, l, gn) for i, (l, gn) in enumerate(spec)]
    prompts = {i: rng.integers(0, 64, size=l).astype(np.int32)
               for i, (l, _) in enumerate(spec)}
    ccfg = (None if mode == "quota" else KVCompressConfig(
        n_clusters=4, iters=2, keep_recent=32, refresh_every=4))
    paged = {"dense": None, "paged": PagedKVConfig(block_size=4),
             "quota": PagedKVConfig(block_size=4, pool_blocks=12)}[mode]
    scfg = ServerConfig(batch_size=2, max_seq=64, prefill_chunk=8,
                        kv_compress=ccfg, paged=paged)
    toks = {}
    for dev in ("cpu", cuda):
        srv = Server(cfg, scfg, params, device=dev)
        ops.reset_launches()
        toks[str(dev)] = {o.uid: o.tokens for o in srv.serve(reqs, prompts)}
        counts = ops.launch_counts()
    st = srv.last_stats
    assert toks["cpu"] == toks[str(cuda)]
    kernel, other = (("clustered_decode", "paged_clustered_decode")
                     if mode == "dense" else
                     ("paged_clustered_decode", "clustered_decode"))
    assert counts[kernel] == st["decode_steps"]     # one 'G' layer
    assert counts[other] == 0
    assert st["kv_retired_window"] > 0
    if mode == "quota":
        assert counts["bitserial_median"] == 0
        assert st["kv_retired_quota"] > 0 and st["kv_retired_frontier"] == 0
    else:
        assert counts["bitserial_median"] > 0
        assert st["kv_retired_frontier"] > 0
    if paged is not None:
        assert st["pool_blocks_end"] == 0.0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
def test_paged_decode_quota_layout(cuda, dtype, tol):
    """paged_clustered_decode in the quota layout: one centroid of count 0
    (garbage payload), a ring of 64 positions in 16 blocks of 4 behind a
    shuffled table, decode rows and a 5-row chunk: the kernel equals its
    plain version, and in f32 exact attention over the visible positions
    (the dead centroid takes no weight)."""
    from repro_torch.models import attention

    g = torch.Generator(device="cpu").manual_seed(5)
    b, hq, hkv, dh, bs, r = 3, 4, 2, 16, 4, 64
    nt = r // bs
    ring = {k: torch.randn(b, r, hkv, dh, generator=g) for k in "kv"}
    perm = 1 + torch.randperm(b * nt, generator=g)
    table = perm.reshape(b, nt).to(torch.int32)
    pools = {}
    for k in "kv":
        pool = torch.randn(1 + b * nt, bs, hkv, dh, generator=g)
        pool[table.long()] = ring[k].reshape(b, nt, bs, hkv, dh)
        pools[k] = pool.to(cuda, dtype)
    # slot 0: a chunk of 5 rows ending at position 40; slots 1, 2: decode
    rows = [(0, p) for p in range(36, 41)] + [(1, 63), (2, 0)]
    slot = torch.tensor([s for s, _ in rows], dtype=torch.int32)
    qpos1 = torch.tensor([p + 1 for _, p in rows], dtype=torch.int32)
    tw = torch.tensor([41 if s == 0 else p + 1 for s, p in rows],
                      dtype=torch.int32)
    n = len(rows)
    args = dict(q=torch.randn(n, hq, dh, generator=g).to(cuda, dtype),
                k_cents=torch.randn(b, 1, hkv, dh, generator=g).to(cuda,
                                                                   dtype),
                v_cents=torch.randn(b, 1, hkv, dh, generator=g).to(cuda,
                                                                   dtype),
                counts=torch.zeros(b, 1, hkv, device=cuda),
                k_pool=pools["k"], v_pool=pools["v"],
                row_slot=slot.to(cuda), row_bt=table[slot.long()].to(cuda),
                qpos1=qpos1.to(cuda), tw=tw.to(cuda),
                cov=torch.zeros(n, dtype=torch.int32, device=cuda))
    args["row_group"] = torch.from_numpy(pcd.group_rows(
        slot.numpy(), qpos1.numpy(), tw.numpy(), hq // hkv)).to(cuda)
    got = pcd.paged_clustered_decode_cuda(**args, scale=dh ** -0.5)
    f32 = {k: (v.float() if v.is_floating_point() else v)
           for k, v in args.items()}
    want = pcd.paged_clustered_decode_plain(**f32, scale=dh ** -0.5)
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    if dtype == torch.float32:
        exact = attention.decode_attention(
            args["q"], ring["k"][slot.long()].to(cuda),
            ring["v"][slot.long()].to(cuda), t=qpos1.to(cuda),
            scale=dh ** -0.5)
        torch.testing.assert_close(got, exact, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# prefix-shared admission and the template store on the card
# ---------------------------------------------------------------------------

SHARE_STATS = ("prefix_hits", "prefix_tokens_reused", "prefill_chunks",
               "kv_shared_blocks", "kv_bytes_saved", "pool_cow",
               "pool_allocs", "pool_frees", "pool_blocks_end")


def _template_burst(tpl_seed, sfx_seed, n):
    """One 40-token template and suffixes of 3-8 tokens (the TINY streams
    of tests/test_torch_prefix_serving.py)."""
    from repro_torch.core.request_cluster import Request

    template = np.random.default_rng(tpl_seed).integers(0, 64, size=40)
    rng = np.random.default_rng(sfx_seed)
    reqs, prompts = [], {}
    for i in range(n):
        sfx = rng.integers(0, 64, size=int(rng.integers(3, 9)))
        prompts[i] = np.concatenate([template, sfx]).astype(np.int32)
        reqs.append(Request(i, len(prompts[i]), int(rng.integers(6, 12))))
    return reqs, prompts


def _share_scfg(pool_blocks=0, **kw):
    from repro_torch.core.kv_compress import KVCompressConfig
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.server import ServerConfig

    return ServerConfig(batch_size=2, max_seq=96, prefill_chunk=8,
                        kv_compress=KVCompressConfig(
                            n_clusters=8, iters=4, keep_recent=16,
                            refresh_every=8),
                        paged=PagedKVConfig(block_size=4,
                                            pool_blocks=pool_blocks), **kw)


def test_tiny_prefix_shared_serve_on_card(cuda):
    """TINY's templated burst with prefix sharing on the card: the CPU
    port's tokens and sharing, pool and copy-on-write stats, and
    paged_clustered_decode once a layer an engine step."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.prefix_cache import PrefixShareConfig
    from repro_torch.runtime.server import Server

    cfg = _tiny()
    params = tfm.init_params(0, cfg, device="cpu")
    reqs, prompts = _template_burst(5, 5, 6)
    scfg = _share_scfg(prefix_share=PrefixShareConfig())
    toks, stats = {}, {}
    for dev in ("cpu", cuda):
        srv = Server(cfg, scfg, params, device=dev)
        ops.reset_launches()
        toks[str(dev)] = {o.uid: o.tokens for o in srv.serve(reqs, prompts)}
        stats[str(dev)] = srv.last_stats
        counts = ops.launch_counts()
    st = stats[str(cuda)]
    assert toks["cpu"] == toks[str(cuda)]
    for key in SHARE_STATS:
        assert st[key] == stats["cpu"][key], key
    assert st["prefix_hits"] > 0 and st["pool_cow"] > 0
    assert counts["paged_clustered_decode"] == (cfg.n_layers
                                                * st["decode_steps"])
    assert counts["clustered_decode"] == 0 and counts["bitserial_median"] > 0


def test_tiny_warm_store_serve_on_card(cuda):
    """Two bursts of one template through a template store on the card:
    each serve's tokens, sharing, pool and template stats equal the CPU
    port's, and the warm serve hits the store."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server
    from repro_torch.runtime.template_store import TemplateStoreConfig

    cfg = _tiny()
    params = tfm.init_params(0, cfg, device="cpu")
    scfg = _share_scfg(24, template_store=TemplateStoreConfig())
    bursts = [_template_burst(5, 11, 4), _template_burst(5, 13, 4)]
    runs = {}
    for dev in ("cpu", cuda):
        srv = Server(cfg, scfg, params, device=dev)
        runs[str(dev)] = [
            ({o.uid: o.tokens for o in srv.serve(*b)}, dict(srv.last_stats))
            for b in bursts]
        srv.invalidate_templates()
        assert srv._store.pinned_blocks() == 0
    for (got, st), (want, st_cpu) in zip(runs[str(cuda)], runs["cpu"]):
        assert got == want
        keys = SHARE_STATS + tuple(k for k in st_cpu
                                   if k.startswith("template_"))
        for key in keys:
            assert st[key] == st_cpu[key], key
    assert runs[str(cuda)][1][1]["prefix_hits"] > 0


def test_cow_impl_on_card(cuda):
    """``Server._cow_impl`` copies pool blocks on the card bit for bit as
    on the CPU, repeated pairs included."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server

    cache = tfm.init_cache(_tiny(), 2, 64, kv_mode="clustered",
                           kv_clusters=4, kv_tail=16, kv_pool_blocks=12,
                           kv_block_size=4, device="cpu")
    g = torch.Generator(device="cpu").manual_seed(5)
    for leaf in cache["layers"]:
        for key in ("k_tail", "v_tail"):
            leaf[key].copy_(torch.randn(leaf[key].shape, generator=g))
    card = _to(cache, cuda)
    pairs = [(3, 9), (0, 7), (3, 9), (5, 11)]
    Server._cow_impl(cache, pairs)
    Server._cow_impl(card, pairs)
    for lc, lg in zip(cache["layers"], card["layers"]):
        for key, val in lc.items():
            assert torch.equal(lg[key].cpu(), val), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swap_round_trip_on_card(cuda, dtype):
    """The preemption swap on the card: a slot's state and tail blocks to
    the host and back into another slot's fresh blocks, bit for bit, the
    re-adopted and every other block untouched (tests/_torch_swap.py)."""
    from _torch_swap import swap_round_trip, tiny

    assert swap_round_trip(cuda, tiny(dtype))[:2] == (2, 1)


def _slo_stream():
    """tests/test_scheduler.py's stream: best-effort requests first, three
    priority-1 requests at the FIFO tail."""
    from repro_torch.core.request_cluster import Request

    rng = np.random.default_rng(3)
    reqs, prompts = [], {}
    for i in range(8):
        plen = int(rng.integers(6, 30))
        prompts[i] = rng.integers(0, 64, size=(plen,)).astype(np.int32)
        reqs.append(Request(i, plen, int(rng.integers(6, 14)),
                            priority=1 if i >= 5 else 0))
    return reqs, prompts


@pytest.mark.parametrize("chunk", [8, 0], ids=["chunked", "blocking"])
def test_tiny_slo_serve_on_card(cuda, chunk):
    """TINY (f32) through a 10-block pool with ``SLOConfig(
    priority_admission=False)`` and tracing, on the card: best-effort
    slots are preempted to host memory and resumed, and the tokens equal
    the CPU port's and an uninterrupted card run's (48 blocks, no
    scheduler); every sched_* counter equals the CPU's; the trace
    validates; paged_clustered_decode launched once a layer an engine
    step."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.scheduler import SLOConfig
    from repro_torch.runtime.server import Server
    from repro_torch.runtime.telemetry import TelemetryConfig, validate_trace

    cfg = _tiny()
    params = tfm.init_params(0, cfg, device="cpu")
    reqs, prompts = _slo_stream()
    scfg = dataclasses.replace(
        _share_scfg(10), prefill_chunk=chunk, use_clustered_batching=False,
        scheduler=SLOConfig(priority_admission=False),
        telemetry=TelemetryConfig(trace=True))
    whole_cfg = dataclasses.replace(
        scfg, scheduler=None, telemetry=None,
        paged=PagedKVConfig(block_size=4, pool_blocks=48))
    toks, stats = {}, {}
    for name, dev, sc in (("cpu", "cpu", scfg), ("card", cuda, scfg),
                          ("whole", cuda, whole_cfg)):
        srv = Server(cfg, sc, params, device=dev)
        ops.reset_launches()
        outs = srv.serve(reqs, prompts)
        toks[name] = {o.uid: (o.tokens, o.shed) for o in outs}
        stats[name] = dict(srv.last_stats)
        if name == "card":
            counts = ops.launch_counts()
            trace = srv.last_trace
    st = stats["card"]
    assert toks["card"] == toks["cpu"]
    assert st["sched_preemptions"] >= 1 and st["sched_swaps_in"] >= 1
    assert st["sched_shed_high"] == 0
    for key in (k for k in stats["cpu"] if k.startswith("sched_")):
        assert st[key] == stats["cpu"][key], key
    for uid, (t, shed) in toks["card"].items():
        assert not shed and t == toks["whole"][uid][0], uid
    assert validate_trace(trace, totals=st) == []
    assert counts["paged_clustered_decode"] == (cfg.n_layers
                                                * st["decode_steps"])
    assert counts["clustered_decode"] == 0 and counts["bitserial_median"] > 0


def _gm():
    """The reference's GM_REC (tests/test_serving_engine.py): a 'G' layer
    and a Mamba2 'M' layer, f32."""
    from repro_torch.models.config import ModelConfig, SSMConfig

    return ModelConfig(name="gm", family="hybrid", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                       vocab=64, pad_vocab_multiple=16, dtype="float32",
                       layer_pattern="GM",
                       ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                     head_dim=32, n_groups=1, chunk=32))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_gm_chunked_serve_on_card(cuda, paged):
    """'GM' served chunked on the card, dense and paged, gives the CPU
    port's tokens: the clustered kernels run beside recurrent state (the
    decode kernel of the mode once for the 'G' layer of every engine
    step, bitserial_median for absorbs and compactions) while the 'M'
    layer advances its state token by token; the recurrent state is
    priced and never retires."""
    import dataclasses

    from repro_torch.core.request_cluster import Request
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server

    cfg = _gm()
    params = tfm.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(9)
    spec = [(60, 12), (9, 10), (48, 9), (21, 14)]
    reqs = [Request(i, l, gn) for i, (l, gn) in enumerate(spec)]
    prompts = {i: rng.integers(0, 64, size=(l,)).astype(np.int32)
               for i, (l, _) in enumerate(spec)}
    scfg = _share_scfg()
    if not paged:
        scfg = dataclasses.replace(scfg, paged=None)
    toks = {}
    for dev in ("cpu", cuda):
        srv = Server(cfg, scfg, params, device=dev)
        ops.reset_launches()
        toks[str(dev)] = {o.uid: o.tokens for o in srv.serve(reqs, prompts)}
        counts = ops.launch_counts()
    st = srv.last_stats
    assert toks["cpu"] == toks[str(cuda)]
    kernel, other = (("paged_clustered_decode", "clustered_decode") if paged
                     else ("clustered_decode", "paged_clustered_decode"))
    assert counts[kernel] == st["decode_steps"]     # one 'G' layer
    assert counts[other] == 0
    assert counts["bitserial_median"] >= st["kv_absorbs"] + \
        st["kv_compactions"] > 0
    assert st["state_bytes_recurrent"] > 0 and st["kv_retired_recurrent"] == 0
    if paged:
        assert st["pool_blocks_end"] == 0


def test_gm_swap_serve_on_card(cuda):
    """'GM' through a 10-block pool with ``SLOConfig(priority_admission=
    False)`` on the card: slots are preempted to host memory with their
    recurrent state and resumed, with the CPU port's tokens and sched_*
    counters and an unpressured card run's tokens (48 blocks, no
    scheduler)."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.scheduler import SLOConfig
    from repro_torch.runtime.server import Server

    cfg = _gm()
    params = tfm.init_params(0, cfg, device="cpu")
    reqs, prompts = _slo_stream()
    scfg = _share_scfg(10, use_clustered_batching=False,
                       scheduler=SLOConfig(priority_admission=False))
    whole_cfg = dataclasses.replace(
        scfg, scheduler=None, paged=PagedKVConfig(block_size=4,
                                                  pool_blocks=48))
    toks, stats = {}, {}
    for name, dev, sc in (("cpu", "cpu", scfg), ("card", cuda, scfg),
                          ("whole", cuda, whole_cfg)):
        srv = Server(cfg, sc, params, device=dev)
        ops.reset_launches()
        outs = srv.serve(reqs, prompts)
        toks[name] = {o.uid: (o.tokens, o.shed) for o in outs}
        stats[name] = dict(srv.last_stats)
        if name == "card":
            counts = ops.launch_counts()
    st = stats["card"]
    assert toks["card"] == toks["cpu"]
    assert st["sched_preemptions"] >= 1 and st["sched_swaps_in"] >= 1
    for key in (k for k in stats["cpu"] if k.startswith("sched_")):
        assert st[key] == stats["cpu"][key], key
    for uid, (t, shed) in toks["card"].items():
        assert shed or t == toks["whole"][uid][0], uid
    assert counts["paged_clustered_decode"] == st["decode_steps"]
    assert st["state_bytes_recurrent"] > 0


def test_apply_moe_on_card_matches_cpu(cuda):
    """The reduced qwen2-moe's MoE layer (8 experts, top-2, a shared
    expert) on (4, 16, 64) f32 rows at a capacity factor that drops
    tokens: the CPU's routes, expert loads and drop fraction exactly, y
    within 1e-5; and two card runs bit-equal (the combine adds each
    token's expert outputs in k order, never by an atomic scatter)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe

    cfg = dataclasses.replace(configs.get_reduced("qwen2-moe-a2.7b"),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32))
    y0, m0 = moe.apply_moe(p, x, cfg)
    pc = {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
              if isinstance(v, dict) else v.to(cuda)) for k, v in p.items()}
    runs = [moe.apply_moe(pc, x.to(cuda), cfg) for _ in range(2)]
    torch.cuda.synchronize()
    assert float(m0["drop_frac"]) > 0
    (y1, m1), (y2, _) = runs
    assert torch.equal(y1, y2)
    assert torch.equal(m1["expert_load"].cpu(), m0["expert_load"])
    assert float(m1["drop_frac"]) == float(m0["drop_frac"])
    torch.testing.assert_close(y1.cpu(), y0, rtol=1e-5, atol=1e-5)


def test_mamba2_blocking_equals_chunked_on_card(cuda):
    """ROADMAP Queue C 10 on the card: the reduced mamba2-2.7b (f32)
    served blocking (each prompt's columns stepped at the slot count) and
    chunked gives the same tokens, and the CPU's."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.request_cluster import Request
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = dataclasses.replace(configs.get_reduced("mamba2-2.7b"),
                              dtype="float32")
    params = tfm.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(6)
    lens = rng.integers(20, 41, size=4)
    reqs = [Request(i, int(n), 12) for i, n in enumerate(lens)]
    prompts = {i: rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for i, n in enumerate(lens)}
    toks = {}
    for name, dev, chunk in (("blocking", cuda, 0), ("chunked", cuda, 8),
                             ("cpu", "cpu", 8)):
        srv = Server(cfg, ServerConfig(batch_size=4, max_seq=96,
                                       prefill_chunk=chunk), params,
                     device=dev)
        toks[name] = {o.uid: o.tokens for o in srv.serve(reqs, prompts)}
    assert toks["blocking"] == toks["chunked"] == toks["cpu"]


@pytest.mark.parametrize("tv", [(12, 7), (16, 12)],
                         ids=["per_slot", "past_max_seq"])
def test_mla_decode_on_card_matches_cpu(cuda, tv):
    """The reduced deepseek-v3's MLA layer in f32: an expanded prefill of
    12 positions, then the absorbed decode at per-slot positions, card
    against CPU within 1e-5 (outputs and latent caches); at t = max_seq
    16 the slot's write is dropped, with no device-side assert."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import attention

    cfg = dataclasses.replace(configs.get_reduced("deepseek-v3-671b"),
                              dtype="float32")
    p = attention.init_mla(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 12, cfg.d_model)).astype(
        np.float32))
    x1 = torch.from_numpy(rng.normal(size=(2, 1, cfg.d_model)).astype(
        np.float32))
    t = torch.tensor(tv, dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        pd = {k: v.to(dev) for k, v in p.items()}
        y, c = attention.mla_prefill(pd, x.to(dev), cfg,
                                     positions=torch.arange(12, device=dev),
                                     max_seq=16)
        y1, c = attention.mla_decode(pd, x1.to(dev), cfg, cache=c,
                                     t=t.to(dev))
        out[str(dev)] = [a.cpu() for a in (y, y1, c["ckv"], c["kpe"])]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_encdec_encode_and_decode_on_card_match_cpu(cuda):
    """The reduced seamless-m4t-medium in f32: ``encode``, a prefill over
    its output and one ``decode_step``, card against CPU within 1e-5; the
    cross caches are carried through the step unchanged."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(configs.get_reduced("seamless-m4t-medium"),
                              dtype="float32")
    params = tfm.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(3)
    enc = torch.from_numpy(rng.normal(size=(2, 13, cfg.d_model)).astype(
        np.float32))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 9)).astype(
        np.int32))
    out = {}
    for dev in ("cpu", cuda):
        pd = _to(params, dev)
        e = tfm.encode(pd, cfg, enc.to(dev))
        lg, c = tfm.prefill(pd, cfg, tok.to(dev), max_seq=24,
                            enc_embeds=enc.to(dev))
        cross = [(k.clone(), v.clone()) for k, v in c["cross"]]
        nxt = lg.argmax(-1).to(torch.int32)[:, None]
        lg1, c = tfm.decode_step(pd, cfg, c, nxt, 9)
        for (k, v), (k0, v0) in zip(c["cross"], cross):
            assert torch.equal(k, k0) and torch.equal(v, v0)
        out[str(dev)] = [a.cpu() for a in (e, lg, lg1)]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# AdamW with no warmup at lr 1e-2: the first step moves every element by
# about lr, a thousand times the 1e-5 the updated parameters are held to
_TRAIN_AW = dict(lr=1e-2, warmup_steps=0)


def _train_step(cfg, params, batch, dev, monkeypatch):
    """One ``make_train_step`` step on ``dev`` from a copy of ``params``
    at ``_TRAIN_AW``: (metrics as floats, the updated parameters on the
    CPU, every MoE layer's sorted top-k experts, the clipped gradient
    leaves on the CPU, recorded through the ``grad_transform`` hook)."""
    from repro_torch.core import tree
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.optim import adamw

    routes, apply_moe = [], moe.apply_moe

    def recording(p, x, cfg_):
        with torch.no_grad():
            _, idx, _ = moe.route(p, x.reshape(-1, x.shape[-1]), cfg_)
        routes.append(torch.sort(idx, dim=1).values.cpu())
        return apply_moe(p, x, cfg_)

    grads = []

    def record(g):
        grads.append(g.detach().cpu())
        return g

    monkeypatch.setattr(moe, "apply_moe", recording)
    p = tree.map_(lambda t: t.detach().to(dev, copy=True), params)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**_TRAIN_AW),
                                 steps.StepOptions(loss_chunk=16),
                                 grad_transform=record)
    p, _, m = step(p, adamw.init(p), batch)
    monkeypatch.setattr(moe, "apply_moe", apply_moe)
    return ({k: float(v) for k, v in m.items()},
            tree.map_(lambda t: t.detach().cpu(), p), routes, grads)


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v3-671b"])
def test_train_step_card_matches_cpu(cuda, arch, monkeypatch):
    """One train step of the reduced qwen3 and of the reduced deepseek-v3
    (MLA, MoE and the MTP head) in f32, card against CPU: first every MoE
    layer's expert sets equal, then the loss and every metric within
    1e-5, the gradient norm within 1e-4 (relative), each clipped gradient
    leaf within 1e-4 of its largest CPU entry, the updated parameters
    (lr 1e-2, no warmup) within 1e-5 except for at most 0.1 % of them,
    which AdamW's first step (about lr an element) may move the other way
    where a gradient is near 0: those within 2 lr."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.data import pipeline
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    params = tfm.init_params(0, cfg, device="cpu")
    assert ("mtp" in params) == (arch == "deepseek-v3-671b")
    batch = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
        seed=0, global_batch=2, seq_len=64)).batch_at(0)
    (m_g, p_g, r_g, g_g), (m_c, p_c, r_c, g_c) = (
        _train_step(cfg, params, batch, d, monkeypatch)
        for d in (cuda, torch.device("cpu")))
    assert len(r_g) == len(r_c) and (len(r_g) > 0) == ("mtp" in params)
    for a, b in zip(r_g, r_c):
        assert torch.equal(a, b), "MoE expert sets differ card / CPU"
    assert set(m_g) == set(m_c)
    for k, v in m_c.items():
        tol = 1e-4 if k == "grad_norm" else 1e-5
        assert abs(m_g[k] - v) <= tol * max(abs(v), 1e-6), (k, m_g[k], v)
    assert len(g_g) == len(g_c) == len(tree.leaves(params))
    for i, (a, b) in enumerate(zip(g_g, g_c)):
        err, top = (a - b).abs().max().item(), b.abs().max().item()
        assert err <= 1e-4 * top, (i, err, top)
    lr1 = float(adamw.schedule(adamw.AdamWConfig(**_TRAIN_AW),
                               torch.tensor(1)))
    assert lr1 > 0.99e-2
    flipped = total = 0
    for a, b in zip(tree.leaves(p_g), tree.leaves(p_c)):
        d = (a - b).abs()
        assert d.max().item() <= 2 * lr1 + 1e-5
        flipped += int((d > 1e-5).sum())
        total += d.numel()
    assert flipped <= 1e-3 * total, (flipped, total)


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma2-27b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "deepseek-v3-671b",
                                  "qwen2-moe-a2.7b"])
def test_train_step_mesh_on_card(cuda, arch, monkeypatch, tmp_path):
    """One train step of each reduced family in f32 through a one-rank
    NCCL mesh (``lower_step`` on ``make_host_mesh()``, a file store, no
    network) against the one-card ``make_train_step`` step: first every
    MoE layer's expert sets equal, then the loss and every metric, each
    clipped gradient leaf and every updated parameter equal to the bit
    (on one rank every collective is an identity)."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as shard_rules

    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    params = tfm.init_params(0, cfg, device="cpu")
    batch = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
        seed=0, global_batch=2, seq_len=64)).batch_at(0)
    aw = adamw.AdamWConfig(**_TRAIN_AW)
    opts = steps.StepOptions(loss_chunk=16)
    runs = []
    for mesh_run in (False, True):
        routes, apply_moe = [], moe.apply_moe

        def recording(p, x, cfg_):
            with torch.no_grad():
                _, idx, _ = moe.route(p, x.reshape(-1, x.shape[-1]), cfg_)
            routes.append(torch.sort(idx, dim=1).values.cpu())
            return apply_moe(p, x, cfg_)

        grads = []

        def record(g):
            grads.append(g.detach().cpu())
            return g

        monkeypatch.setattr(moe, "apply_moe", recording)
        p = tree.map_(lambda t: t.detach().to(cuda, copy=True), params)
        o = adamw.init(p)
        if mesh_run:
            dist.init_process_group(
                "nccl", init_method=f"file://{tmp_path}/store", rank=0,
                world_size=1, timeout=datetime.timedelta(seconds=120))
            try:
                step, _ = steps.lower_step(
                    cfg, make_host_mesh(), ShapeCell("t", 64, 2, "train"),
                    opts, aw, grad_transform=record)
                p, o = shard_rules.place_train_state(p, o, step.rules)
                p, o, m = step(p, o, batch)
                torch.cuda.synchronize()
            finally:
                dist.destroy_process_group()
        else:
            p, o, m = steps.make_train_step(cfg, aw, opts, record)(p, o,
                                                                   batch)
        monkeypatch.setattr(moe, "apply_moe", apply_moe)
        runs.append(({k: float(v) for k, v in m.items()},
                     [t.detach().cpu() for t in tree.leaves(p)], routes,
                     grads))
    (m_1, p_1, r_1, g_1), (m_m, p_m, r_m, g_m) = runs
    assert len(r_1) == len(r_m) and (len(r_1) > 0) == (cfg.moe is not None)
    for a, b in zip(r_m, r_1):
        assert torch.equal(a, b), "MoE expert sets differ mesh / one card"
    assert m_m == m_1
    assert len(g_m) == len(g_1) == len(p_1)
    for a, b in zip(g_m + p_m, g_1 + p_1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [8, 23, 64])
def test_bitserial_median_trainer_shapes(cuda, n):
    """The Trainer's straggler median and MAD (n step times x 1, K 1, 16
    bits, no weights) through ``core.bitserial.median`` on the card equal
    the plain version's, and launch the kernel once each."""
    from repro_torch.core import bitserial, quantizer

    g = torch.Generator().manual_seed(n)
    times = (0.05 + 0.01 * torch.rand(n, 1, generator=g)).to(cuda)
    for x in (times, None):
        x = (times - med).abs() if x is None else x
        spec = quantizer.FixedPointSpec(
            bits=16, scale=quantizer.auto_scale(x, 16).reshape(1))
        u = quantizer.to_unsigned_order(quantizer.quantize(x, spec), 16)
        a = torch.zeros(n, dtype=torch.int32, device=cuda)
        m0, t0 = bsm.grouped_median_bits_plain(u, a, 1, bits=16)
        ops.reset_launches()
        med = bitserial.median(x, bits=16)
        assert ops.launch_counts()["bitserial_median"] == 1
        m1, t1 = bsm.grouped_median_bits_cuda(u, a, 1, bits=16)
        assert torch.equal(m1, m0) and torch.equal(t1, t0)
        want = quantizer.dequantize(quantizer.from_unsigned_order(
            m0.reshape(1), 16), spec)
        assert torch.equal(med, want)


@pytest.mark.parametrize("flags,kernel", [
    (["--kv-clusters", "8", "--keep-recent", "16", "--refresh-every", "8"],
     "clustered_decode"),
    (["--paged", "--prefill-chunk", "16"], "paged_clustered_decode"),
], ids=["clustered", "paged"])
def test_serve_cli_on_card_prints_the_cpu_counts(cuda, flags, kernel,
                                                 monkeypatch):
    """The serving CLI on the reduced qwen3-4b in f32, the same weights on
    the card and on the CPU: every engine step's logits on its real rows
    (a dense step's every slot, a packed step's rows at a position >= 0)
    within 1e-4, every serve's greedy tokens equal, request for request;
    every line equal but for its timing fields (the counts: completions,
    tokens, chunks, pool blocks, retired positions); and on the card the
    mode's decode kernel and bitserial_median launched.  The tokens alone
    would hold little: the random reduced model repeats its first token,
    whatever its attention returns."""
    import dataclasses

    from _serve_lines import mask
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server

    orig = configs.get_reduced
    monkeypatch.setattr(configs, "get_reduced", lambda a: dataclasses.replace(
        orig(a), dtype="float32"))
    toks, orig_serve = [], Server.serve

    def recorded(self, requests, prompts):
        outs = orig_serve(self, requests, prompts)
        toks[-1].append({o.uid: o.tokens for o in outs})
        return outs

    monkeypatch.setattr(Server, "serve", recorded)
    logits, step, packed = [], tfm.decode_step, tfm.decode_step_packed

    def step_logits(*a, **k):
        out, cache = step(*a, **k)
        logits[-1].append(out.float().cpu())
        return out, cache

    def packed_logits(params, cfg, cache, tokp, rslot, rpos, *a, **k):
        out, cache = packed(params, cfg, cache, tokp, rslot, rpos, *a, **k)
        logits[-1].append(out[rpos >= 0].float().cpu())
        return out, cache

    monkeypatch.setattr(tfm, "decode_step", step_logits)
    monkeypatch.setattr(tfm, "decode_step_packed", packed_logits)
    argv = ["--arch", "qwen3-4b", "--reduced", "--requests", "8",
            "--max-new", "4"] + flags
    params = tfm.init_params(0, configs.get_reduced("qwen3-4b"),
                             device="cpu")
    lines = {}
    for dev in ("cpu", "cuda"):
        got = []
        toks.append([])
        logits.append([])
        ops.reset_launches()
        serve.main(argv + ["--device", dev], params=params, say=got.append)
        lines[dev] = [mask(line) for line in got]
    launches = ops.launch_counts()
    assert toks[0] and all(len(t) == 8 for t in toks[0])
    assert logits[0] and len(logits[1]) == len(logits[0])
    for got, want in zip(logits[1], logits[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert toks[1] == toks[0]
    assert lines["cuda"] == lines["cpu"]
    assert any("8 completions, 32 tokens" in line for line in lines["cuda"])
    assert launches[kernel] > 0 and launches["bitserial_median"] > 0


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-moe-a2.7b"])
def test_int_seed_draws_equal_on_card_and_cpu(cuda, arch):
    """An int seed draws every leaf on the CPU generator and moves it:
    ``init_params(0, cfg, device="cuda")`` equals the CPU's bit for bit,
    leaf by leaf."""
    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.models import transformer as tfm

    cfg = configs.get_reduced(arch)
    card = tree.leaves(tfm.init_params(0, cfg, device="cuda"))
    cpu = tree.leaves(tfm.init_params(0, cfg, device="cpu"))
    assert len(card) == len(cpu)
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("arch,kv", [("qwen3-4b", "clustered"),
                                     ("qwen3-4b", "exact"),
                                     ("qwen2-moe-a2.7b", "clustered")])
def test_dryrun_on_card_counts_as_meta(cuda, arch, kv):
    """``run_cell(device="cuda")`` on a reduced config at a decode cell
    whose ring is full (seq_len >= kv_tail): the card's kernel launches a
    step and its count of a step equal the meta record's; the step's
    logits are finite and its time is no shorter than the ideal."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ShapeCell
    from repro_torch.roofline import analysis

    cfg = configs.get_reduced(arch)
    cell = ShapeCell("decode_s", 512, 8, "decode")
    rec = dryrun.run_cell(arch, "decode_s", {"kv_mode": kv, "kv_clusters": 16,
                                             "kv_tail": 64},
                          device="cuda", cfg=cfg, cell=cell)
    meta, card = rec["op_stats"], rec["card_op_stats"]
    n_g = tfm.layer_kinds(cfg).count("G")
    want = n_g if kv == "clustered" else 0
    assert rec["launches_per_step"]["clustered_decode"] == want
    assert meta["kernels"].get("clustered_decode", {}).get(
        "launches", 0) == want
    for key in ("flops", "hbm_bytes", "matmul_flops", "aten_ops", "kernels"):
        assert card[key] == meta[key], key
    assert rec["logits_finite"]
    row = analysis.analyze_record(rec)
    assert row["measured_s"] >= row["ideal_s"]
    prof = rec["profile"]
    assert prof["device_busy_s"] and 0 <= prof["idle_share"] < 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tiny_mesh_serve_on_card(cuda, paged, tmp_path):
    """The mesh engine on a one-rank NCCL world (a file store, no
    network): TINY served chunked and clustered through
    ``make_serving_mesh("1x1")`` gives the tokens of the same serve
    without a mesh, and the decode kernel launches once a layer an engine
    step through the head island (B1 dense, B2 paged), B3 at least once
    an absorb and a compaction."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core.kv_compress import KVCompressConfig
    from repro_torch.core.request_cluster import Request
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = _tiny()
    params = tfm.init_params(0, cfg, device=cuda)
    rng = np.random.default_rng(9)
    spec = [(60, 12), (9, 10), (48, 9), (21, 14)]
    reqs = [Request(i, l, gn) for i, (l, gn) in enumerate(spec)]
    prompts = {i: rng.integers(0, 64, size=l).astype(np.int32)
               for i, (l, _) in enumerate(spec)}
    kw = dict(batch_size=2, max_seq=96, prefill_chunk=8,
              kv_compress=KVCompressConfig(n_clusters=8, iters=4,
                                           keep_recent=16, refresh_every=8),
              paged=PagedKVConfig(block_size=4) if paged else None)
    want = {o.uid: o.tokens for o in Server(
        cfg, ServerConfig(**kw), params, device=cuda).serve(reqs, prompts)}
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        assert dist.get_backend() == "nccl"
        srv = Server(cfg, ServerConfig(mesh=make_serving_mesh("1x1"), **kw),
                     params, device=cuda)
        ops.reset_launches()
        got = {o.uid: o.tokens for o in srv.serve(reqs, prompts)}
        counts = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    st = srv.last_stats
    kernel, other = (("paged_clustered_decode", "clustered_decode") if paged
                     else ("clustered_decode", "paged_clustered_decode"))
    assert got == want
    assert counts[kernel] == cfg.n_layers * st["decode_steps"]
    assert counts[other] == 0
    assert counts["bitserial_median"] >= (st["kv_absorbs"]
                                          + st["kv_compactions"]) > 0
    if paged:
        assert st["pool_blocks_end"] == 0.0


@pytest.mark.parametrize("family", ["moe", "moe-paged", "GL", "GM", "GR"])
def test_family_mesh_serve_on_card(cuda, family, tmp_path):
    """Every model family through the mesh engine of a one-rank NCCL world
    (a file store, no network): the reduced qwen2-moe (f32, its 8 routed
    experts on the one rank, the mesh's sharded dispatch; dense and
    paged) and tests/test_sharded_serving.py's 'GL', 'GM' and 'GR' models
    served chunked and clustered through ``make_serving_mesh("1x1")``
    give the tokens of the same serve without a mesh; the 'G' layers'
    decode kernel (B2 paged, B1 otherwise) launches once a layer an
    engine step through the head island."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core.kv_compress import KVCompressConfig
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.server import Server, ServerConfig

    import _torch_family_ranks as fam

    is_moe, paged = family.startswith("moe"), family.endswith("paged")
    cfg = fam.moe_config() if is_moe else fam.family_config(family)
    params = tfm.init_params(0, cfg, device=cuda)
    reqs, prompts = fam.recurrent_stream()
    kw = dict(batch_size=4, max_seq=96, prefill_chunk=8,
              kv_compress=KVCompressConfig(n_clusters=8, iters=4,
                                           keep_recent=16, refresh_every=8),
              paged=PagedKVConfig(block_size=4) if paged else None)
    want = {o.uid: o.tokens for o in Server(
        cfg, ServerConfig(**kw), params, device=cuda).serve(reqs, prompts)}
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        assert dist.get_backend() == "nccl"
        srv = Server(cfg, ServerConfig(mesh=make_serving_mesh("1x1"), **kw),
                     params, device=cuda)
        ops.reset_launches()
        moe.reset_mesh_dispatches()
        got = {o.uid: o.tokens for o in srv.serve(reqs, prompts)}
        counts = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    assert got == want
    n_g = tfm.layer_kinds(cfg).count("G")
    kernel, other = (("paged_clustered_decode", "clustered_decode") if paged
                     else ("clustered_decode", "paged_clustered_decode"))
    assert counts[kernel] == n_g * srv.last_stats["decode_steps"]
    assert counts[other] == 0
    if paged:
        assert srv.last_stats["pool_blocks_end"] == 0.0
    if is_moe:
        assert moe.mesh_dispatches["sharded"] > 0


def test_runtime_modes_mesh_serve_on_card(cuda, tmp_path):
    """Prefix sharing's template store and the SLO scheduler through the
    mesh engine of a one-rank NCCL world (a file store, no network): the
    reduced qwen3-4b serves tests/test_sharded_serving.py's two store
    bursts through one mesh Server (:213), then its oversubscribed stream
    under ``SLOConfig(priority_admission=False)`` over 8 blocks (:312),
    traced.  A one-rank mesh is the one-card schedule: tokens, shed flags
    and counters equal the same serves without a mesh; B2 launches once a
    layer an engine step through the head island; the trace validates;
    ``invalidate_templates()`` drains the pool."""
    import datetime

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server
    from repro_torch.runtime.telemetry import validate_trace

    import _torch_runtime_ranks as rk

    cfg = configs.get_reduced("qwen3-4b")
    params = tfm.init_params(0, cfg, device=cuda)
    keys = ("prefix_hits", "prefix_tokens_reused", "template_pinned_blocks",
            "sched_preemptions", "sched_swaps_in", "sched_swaps_out",
            "sched_sheds", "sched_deferrals", "pool_blocks_end")

    def serves(mesh=None):
        out = []
        srv = Server(cfg, rk.server_config(pool=24, store=True, mesh=mesh),
                     params, device=cuda)
        for seed in (11, 13):
            got = rk.run(srv, rk.store_burst(seed), keys)
            out.append(got + (ops.launch_counts(),
                              srv.last_stats["decode_steps"]))
            ops.reset_launches()
        srv.invalidate_templates()
        srv = Server(cfg, rk.server_config(pool=8, slo=True, fifo=True,
                                           trace=True, mesh=mesh),
                     params, device=cuda)
        got = rk.run(srv, rk.slo_stream(), keys)
        out.append(got + (ops.launch_counts(),
                          srv.last_stats["decode_steps"]))
        assert validate_trace(srv.last_trace,
                              totals=dict(srv.last_stats)) == []
        return out

    ops.reset_launches()
    want = serves()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        assert dist.get_backend() == "nccl"
        ops.reset_launches()
        got = serves(make_serving_mesh("1x1"))
    finally:
        dist.destroy_process_group()
    assert want[1][2]["prefix_hits"] > 0
    assert want[2][2]["sched_preemptions"] >= 1
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        counts, steps = g[3], g[4]
        assert counts["paged_clustered_decode"] == cfg.n_layers * steps
        assert counts["clustered_decode"] == 0
