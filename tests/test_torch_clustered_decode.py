"""The plain version of the port's clustered_decode kernel against the
reference: its Pallas kernel in interpret mode, and the layer-level
``attn_decode_clustered(use_kernel=False)`` einsum path.  Also the
mixed-mode contract: a fused chunk equals stepwise decode, and rows at or
past chunk_len never affect the valid rows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.kernels.clustered_decode import clustered_decode_pallas
from repro.models import attention as attn
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.kernels import clustered_decode as cd_t
from repro_torch.kernels import ops as ops_t
from repro_torch.models import attention as attn_t

T = torch.from_numpy
ATOL = 1e-5


def _inputs(rng, b, c, r, hq, hkv, dh, l):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    counts = rng.uniform(0, 3, size=(b, c, hkv)).astype(np.float32)
    counts[:, ::3] = 0.0                         # some empty clusters
    return dict(q=f(b, l, hq, dh), k_cents=f(b, c, hkv, dh),
                v_cents=f(b, c, hkv, dh), counts=counts,
                k_tail=f(b, r, hkv, dh), v_tail=f(b, r, hkv, dh))


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_plain_matches_pallas_interpret(softcap):
    """Unwrapped ring, wrapped ring, cov > 0, empty clusters, and
    chunk_len 1 and L in one launch (valid rows compared)."""
    rng = np.random.default_rng(0)
    b, c, r, hq, hkv, dh, l = 4, 6, 16, 4, 2, 16, 5
    x = _inputs(rng, b, c, r, hq, hkv, dh, l)
    t = np.array([3, 9, 30, 21], np.int32)       # pre/post ring wrap
    cov = np.array([0, 0, 20, 10], np.int32)     # cov >= t + cl - r holds
    cl = np.array([l, l, 1, 1], np.int32)
    want = np.asarray(clustered_decode_pallas(
        *(jnp.asarray(v) for v in x.values()), jnp.asarray(t),
        jnp.asarray(cov), jnp.asarray(cl), scale=dh ** -0.5,
        softcap=softcap, interpret=True))
    got = ops_t.clustered_decode(
        *(T(v) for v in x.values()), T(t), T(cov), T(cl), scale=dh ** -0.5,
        softcap=softcap).numpy()
    for bi in range(b):
        np.testing.assert_allclose(got[bi, :cl[bi]], want[bi, :cl[bi]],
                                   rtol=ATOL, atol=ATOL, err_msg=f"slot {bi}")
    # decode form (B, Hq, Dh)
    want1 = np.asarray(clustered_decode_pallas(
        *(jnp.asarray(v[:, 0] if k == "q" else v) for k, v in x.items()),
        jnp.asarray(t), jnp.asarray(cov), scale=dh ** -0.5, softcap=softcap,
        interpret=True))
    got1 = cd_t.clustered_decode_plain(
        *(T(v[:, 0] if k == "q" else v) for k, v in x.items()), T(t),
        T(cov), scale=dh ** -0.5, softcap=softcap).numpy()
    np.testing.assert_allclose(got1, want1, rtol=ATOL, atol=ATOL)


@pytest.fixture(scope="module")
def qwen_attn():
    cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"),
                              dtype="float32")
    cfg_t = dataclasses.replace(configs_t.get_reduced("qwen3-4b"),
                                dtype="float32")
    p = attn.init_attn(jax.random.PRNGKey(1), cfg)
    p_np = jax.tree.map(np.asarray, p)
    p_t = {k: bridge.to_torch(v) for k, v in p_np.items()}
    return cfg, cfg_t, p, p_t


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("chunked", [False, True])
def test_layer_matches_reference_einsum_path(qwen_attn, chunked, use_kernel):
    """Port attn_decode_clustered — through the kernel wrapper (its plain
    version here) and through its own einsum path — against the
    reference's use_kernel=False layer path."""
    cfg, cfg_t, p, p_t = qwen_attn
    rng = np.random.default_rng(1)
    b, c, r, l = 3, 8, 16, 6 if chunked else 1
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    cache = {
        "k_cents": rng.normal(size=(b, c, hkv, dh)).astype(np.float32),
        "v_cents": rng.normal(size=(b, c, hkv, dh)).astype(np.float32),
        "counts": rng.integers(0, 4, size=(b, c, hkv)).astype(np.float32),
        "k_tail": rng.normal(size=(b, r, hkv, dh)).astype(np.float32),
        "v_tail": rng.normal(size=(b, r, hkv, dh)).astype(np.float32),
        "cov": np.array([0, 12, 20], np.int32),
    }
    t = np.array([4, 22, 30], np.int32)
    cl = np.array([l, 1, 1], np.int32) if chunked else None
    x = rng.normal(size=(b, l, cfg.d_model)).astype(np.float32)
    kw = dict(chunk_len=jnp.asarray(cl)) if chunked else {}
    y, c_ref = attn.attn_decode_clustered(
        p, jnp.asarray(x), cfg, cache=jax.tree.map(jnp.asarray, cache),
        t=jnp.asarray(t), use_kernel=False, **kw)
    kw_t = dict(chunk_len=T(cl)) if chunked else {}
    cache_t = {k: T(v.copy()) for k, v in cache.items()}
    y_t, c_t = attn_t.attn_decode_clustered(p_t, T(x), cfg_t, cache=cache_t,
                                            t=T(t), use_kernel=use_kernel,
                                            **kw_t)
    rows = cl if chunked else np.ones(b, np.int32)
    for bi in range(b):
        np.testing.assert_allclose(y_t.numpy()[bi, :rows[bi]],
                                   np.asarray(y)[bi, :rows[bi]],
                                   rtol=1e-4, atol=ATOL)
    # the ring write (rows past chunk_len dropped) is the same
    np.testing.assert_allclose(c_t["k_tail"].numpy(),
                               np.asarray(c_ref["k_tail"]), rtol=1e-5,
                               atol=1e-6)


def test_mixed_mode_matches_stepwise_decode():
    """Feeding a chunk's rows one at a time (write, then score) equals one
    fused launch with the rows pre-written."""
    rng = np.random.default_rng(11)
    c, r, hq, hkv, dh, L = 6, 8, 4, 2, 16, 5
    t0, cov = 9, 6
    k_cents = T(rng.normal(size=(1, c, hkv, dh)).astype(np.float32))
    v_cents = T(rng.normal(size=(1, c, hkv, dh)).astype(np.float32))
    counts = T(rng.uniform(0, 3, size=(1, c, hkv)).astype(np.float32))
    k_tail = T(rng.normal(size=(1, r, hkv, dh)).astype(np.float32))
    v_tail = T(rng.normal(size=(1, r, hkv, dh)).astype(np.float32))
    q = T(rng.normal(size=(1, L, hq, dh)).astype(np.float32))
    k_new = T(rng.normal(size=(L, hkv, dh)).astype(np.float32))
    v_new = T(rng.normal(size=(L, hkv, dh)).astype(np.float32))

    kt, vt = k_tail.clone(), v_tail.clone()
    want = []
    for i in range(L):
        kt[:, (t0 + i) % r] = k_new[i]
        vt[:, (t0 + i) % r] = v_new[i]
        want.append(ops_t.clustered_decode(
            q[:, i], k_cents, v_cents, counts, kt, vt, [t0 + i], [cov],
            scale=dh ** -0.5))
    got = ops_t.clustered_decode(q, k_cents, v_cents, counts, kt, vt, [t0],
                                 [cov], [L], scale=dh ** -0.5)
    for i in range(L):
        np.testing.assert_allclose(got[:, i].numpy(), want[i].numpy(),
                                   rtol=ATOL, atol=ATOL, err_msg=f"row {i}")


def test_rows_past_chunk_len_are_ignored():
    rng = np.random.default_rng(12)
    c, r, hq, hkv, dh, L = 4, 8, 2, 1, 8, 4
    args = [T(rng.normal(size=(1, c, hkv, dh)).astype(np.float32)),
            T(rng.normal(size=(1, c, hkv, dh)).astype(np.float32)),
            T(rng.uniform(1, 2, size=(1, c, hkv)).astype(np.float32)),
            T(rng.normal(size=(1, r, hkv, dh)).astype(np.float32)),
            T(rng.normal(size=(1, r, hkv, dh)).astype(np.float32))]
    q = T(rng.normal(size=(1, L, hq, dh)).astype(np.float32))
    out = ops_t.clustered_decode(q, *args, [5], [1], [2], scale=dh ** -0.5)
    q_junk = q.clone()
    q_junk[:, 2:] = 999.0
    out_j = ops_t.clustered_decode(q_junk, *args, [5], [1], [2],
                                   scale=dh ** -0.5)
    np.testing.assert_array_equal(out[:, :2].numpy(), out_j[:, :2].numpy())
    assert np.isfinite(out_j.numpy()).all()     # NEG, never -inf: no NaN


def test_bf16_plain_rounds_the_f32_result():
    """In bf16 the math stays f32 and only the output rounds."""
    rng = np.random.default_rng(3)
    x = _inputs(rng, 2, 4, 8, 4, 2, 16, 1)
    t, cov = np.array([3, 10], np.int32), np.array([0, 2], np.int32)
    f32 = cd_t.clustered_decode_plain(*(T(v) for v in x.values()), T(t),
                                      T(cov), scale=0.25)
    bf = cd_t.clustered_decode_plain(
        *(T(v).to(torch.bfloat16) if k != "counts" else T(v)
          for k, v in x.items()), T(t), T(cov), scale=0.25)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), f32.numpy(), rtol=3e-2,
                               atol=3e-2)
