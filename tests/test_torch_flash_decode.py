"""Flash-decode (kernel B5) on the CPU: the port's plain version against
the reference's Pallas kernel in interpret mode and against the port's
``decode_attention``, on the shapes of tests/test_kernels.py, within 1e-5
in f32, with and without a softcap; and the kernel's split-and-merge
(``flash_decode_splits``: splits over the real positions below min(t, S),
the zero padding added as one term) against both at the edges t = 0, 1,
chunk, a t inside a chunk, S and t > S, with S not a multiple of the
chunk, within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode_pallas
from repro_torch.kernels import flash_decode as fd_t
from repro_torch.kernels import ops as ops_t
from repro_torch.models import attention as attention_t

T = torch.from_numpy
TOL = 1e-5


def _inputs(b, s, hq, hkv, dh, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, dh)).astype(np.float32) * q_scale
    k = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("b,s,hq,hkv,dh,t", [
    (1, 64, 4, 2, 16, 64), (2, 128, 8, 2, 32, 100),
    (1, 96, 4, 4, 16, 1), (2, 64, 4, 1, 8, 33)])
def test_plain_matches_pallas_and_decode_attention(b, s, hq, hkv, dh, t,
                                                   softcap):
    q, k, v = _inputs(b, s, hq, hkv, dh, b + s + t, q_scale=4.0)
    scale = dh ** -0.5
    want = np.asarray(flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(t),
        scale=scale, softcap=softcap, chunk=32, interpret=True))
    got = fd_t.flash_decode_plain(T(q), T(k), T(v), t, scale=scale,
                                  softcap=softcap, chunk=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    full = attention_t.decode_attention(T(q), T(k), T(v), t=t, scale=scale,
                                        softcap=softcap)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [0, 700, 1024])
def test_default_chunk_with_padding(t):
    """chunk 512 over S = 700 (one padded chunk); t = 0 masks everything,
    where both fall back to the mean over the padded cache."""
    q, k, v = _inputs(1, 700, 4, 2, 16, t)
    want = np.asarray(flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(t),
        scale=0.25, interpret=True))
    got = ops_t.flash_decode(T(q), T(k), T(v), t, scale=0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_bf16_output_follows_q():
    q, k, v = _inputs(2, 64, 4, 2, 16, 3)
    bq, bk, bv = (T(a).to(torch.bfloat16) for a in (q, k, v))
    got = fd_t.flash_decode_plain(bq, bk, bv, 50, scale=0.25, chunk=16)
    assert got.dtype == torch.bfloat16
    want = fd_t.flash_decode_plain(bq.float(), bk.float(), bv.float(), 50,
                                   scale=0.25, chunk=16)
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


def test_cpu_tensors_never_launch_the_kernel():
    ops_t.reset_launches()
    q, k, v = (T(a) for a in _inputs(1, 8, 2, 1, 4, 0))
    ops_t.flash_decode(q, k, v, 4, scale=0.5)
    assert ops_t.launch_counts()["flash_decode"] == 0


@pytest.mark.parametrize("split", [fd_t.SPLIT, 64])
@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("t", [0, 1, 128, 450, 700, 760, 2000, -5])
def test_splits_match_plain_and_pallas_at_the_edges(t, softcap, split):
    """S = 700 over chunks of 128 (68 padded positions): t = 0 and t < 0
    mask everything (the mean of v over the 768 padded positions); t = 760
    and 2000 count padded positions with score 0 up to min(t, 768)."""
    q, k, v = _inputs(2, 700, 8, 2, 16, 40 + max(t, 0), q_scale=3.0)
    kw = dict(scale=0.25, softcap=softcap, chunk=128)
    want = np.asarray(flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(t),
        interpret=True, **kw))
    got = fd_t.flash_decode_splits(T(q), T(k), T(v), t, split=split, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    plain = fd_t.flash_decode_plain(T(q), T(k), T(v), t, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [0, 33, 64])
def test_splits_with_one_chunk_and_bf16(t):
    """chunk >= S (no padding) and bf16 inputs, output in bf16: within one
    bf16 rounding of the plain version's f32 result."""
    q, k, v = _inputs(1, 64, 4, 1, 32, t)
    bq, bk, bv = (T(a).to(torch.bfloat16) for a in (q, k, v))
    got = fd_t.flash_decode_splits(bq, bk, bv, t, scale=0.2, split=16)
    assert got.dtype == torch.bfloat16
    want = fd_t.flash_decode_plain(bq.float(), bk.float(), bv.float(), t,
                                   scale=0.2)
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               rtol=2 ** -7, atol=1e-6)
