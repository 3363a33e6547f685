"""The hand-written CUDA kernels against their plain PyTorch versions on
the card (sm_90).  Marked ``gpu``; without a Hopper card every test skips
(decided inside the fixture, never at import).  Run on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``."""

import pytest
import torch

from repro_torch.kernels import clustered_decode as cd
from repro_torch.kernels import distance_argmin as da
from repro_torch.kernels import ops

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


def test_wrappers_count_launches(cuda):
    ops.reset_launches()
    x = torch.randn(100, 4, device=cuda)
    ops.distance_argmin(x, x[:3].contiguous())
    assert ops.launch_counts()["distance_argmin"] == 1
