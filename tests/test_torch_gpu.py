"""The hand-written CUDA kernels against their plain PyTorch versions on
the card (sm_90).  Marked ``gpu``; without a Hopper card every test skips
(decided inside the fixture, never at import).  Run on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``."""

import pytest
import torch

from repro_torch.kernels import clustered_decode as cd
from repro_torch.kernels import distance_argmin as da
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
                    torch.zeros_like(q[0, :2])])
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
    assert ops.launch_counts()["distance_argmin"] == 1
