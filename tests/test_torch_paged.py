"""The port's paged clustered-KV slice against the reference on TINY:
the plain paged_clustered_decode against the reference's Pallas kernel in
interpret mode and against the port's plain clustered_decode per row,
``decode_step_packed`` logits and pool writes, and the paged ``Server``:
tokens equal to the reference's paged Server and to the port's dense
Server, pool statistics, and an oversubscribed pool that serves short
streams and raises PoolExhausted on a deep one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_compress
from repro.core.request_cluster import Request
from repro.kernels.paged_clustered_decode import paged_clustered_decode_pallas
from repro.models import transformer as tfm
from repro.models.config import ModelConfig
from repro.runtime.kv_pool import PagedKVConfig, PoolExhausted
from repro.runtime.server import Server, ServerConfig
from repro_torch import bridge
from repro_torch.core import kv_compress as kv_t
from repro_torch.core.request_cluster import Request as RequestT
from repro_torch.kernels import clustered_decode as cd_t
from repro_torch.kernels import ops as ops_t
from repro_torch.models import transformer as tfm_t
from repro_torch.models.config import ModelConfig as ModelConfigT
from repro_torch.runtime import kv_pool as kv_pool_t
from repro_torch.runtime.server import Server as ServerT
from repro_torch.runtime.server import ServerConfig as ServerConfigT

T = torch.from_numpy
ATOL = 1e-5
_TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                pad_vocab_multiple=16, dtype="float32")
TINY = ModelConfig(**_TINY_KW)
TINY_T = ModelConfigT(**_TINY_KW)
# tests/test_serving_engine.py::TestPagedEngine
CCFG = kv_compress.KVCompressConfig(n_clusters=8, iters=4, keep_recent=16,
                                    refresh_every=8)
CCFG_T = kv_t.KVCompressConfig(**dataclasses.asdict(CCFG))
STREAM = [(60, 12), (9, 10), (48, 9), (21, 14)]         # _stream(seed=9)
SHORT = [(5, 3), (4, 2), (6, 2), (5, 3), (4, 2)]        # oversubscribed


def _paged_inputs(rng, b, c, r, hq, hkv, dh, bs, t, cl, cov):
    """Dense clustered_decode inputs and the same data as packed paged
    rows: each slot's ring in pool blocks through a shuffled table, the
    spare blocks holding garbage, two padding rows at the end."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    counts = rng.uniform(0, 3, size=(b, c, hkv)).astype(np.float32)
    counts[:, ::3] = 0.0
    l = int(cl.max())
    dense = dict(q=f(b, l, hq, dh), k_cents=f(b, c, hkv, dh),
                 v_cents=f(b, c, hkv, dh), counts=counts,
                 k_tail=f(b, r, hkv, dh), v_tail=f(b, r, hkv, dh))
    nt = r // bs
    nb = b * nt + 2
    bt = rng.permutation(nb)[:b * nt].reshape(b, nt).astype(np.int32)
    pools = []
    for key in ("k_tail", "v_tail"):
        pool = f(nb, bs, hkv, dh)
        pool[bt] = dense[key].reshape(b, nt, bs, hkv, dh)
        pools.append(pool)
    rows = [(bi, i) for bi in range(b) for i in range(int(cl[bi]))]
    slot = np.array([bi for bi, _ in rows] + [0, 0], np.int32)
    pos = np.array([int(t[bi]) + i for bi, i in rows] + [-1, -1], np.int32)
    qp = np.concatenate([np.stack([dense["q"][bi, i] for bi, i in rows]),
                         np.zeros((2, hq, dh), np.float32)])
    paged = (qp, dense["k_cents"], dense["v_cents"], counts, pools[0],
             pools[1], slot, bt[slot], np.where(pos >= 0, pos + 1, 0)
             .astype(np.int32), (t + cl).astype(np.int32)[slot],
             cov[slot].astype(np.int32))
    return dense, paged, rows


B, C, R, HQ, HKV, DH, BS = 3, 4, 16, 4, 2, 16, 4
T_SL = np.array([9, 30, 21], np.int32)            # pre/post ring wrap
CL_SL = np.array([5, 1, 1], np.int32)             # slot 0 admits a chunk
COV_SL = np.array([3, 18, 10], np.int32)


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("with_wlo", [False, True])
def test_plain_matches_pallas_interpret(softcap, with_wlo):
    rng = np.random.default_rng(5)
    _, args, rows = _paged_inputs(rng, B, C, R, HQ, HKV, DH, BS, T_SL,
                                  CL_SL, COV_SL)
    n = len(rows)
    wlo = np.zeros(n + 2, np.int32)
    if with_wlo:
        wlo[:n] = [3 * i % 23 for i in range(n)]   # above and below cov
    want = np.asarray(paged_clustered_decode_pallas(
        *(jnp.asarray(a) for a in args), jnp.asarray(wlo),
        scale=DH ** -0.5, softcap=softcap, interpret=True))
    got = ops_t.paged_clustered_decode(
        *(T(a) for a in args), T(wlo), scale=DH ** -0.5,
        softcap=softcap).numpy()
    np.testing.assert_allclose(got[:n], want[:n], rtol=ATOL, atol=ATOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_plain_matches_plain_dense_per_row(softcap):
    """tests/test_clustered_decode.py::test_paged_kernel_bit_identical_to
    _dense on the plain versions: every real paged row equals the dense
    row of the same (slot, chunk row)."""
    rng = np.random.default_rng(7)
    dense, args, rows = _paged_inputs(rng, B, C, R, HQ, HKV, DH, BS, T_SL,
                                      CL_SL, COV_SL)
    want = cd_t.clustered_decode_plain(
        *(T(v) for v in dense.values()), T(T_SL), T(COV_SL), T(CL_SL),
        scale=DH ** -0.5, softcap=softcap).numpy()
    got = ops_t.paged_clustered_decode(
        *(T(a) for a in args), scale=DH ** -0.5, softcap=softcap).numpy()
    for ri, (bi, i) in enumerate(rows):
        np.testing.assert_allclose(got[ri], want[bi, i], rtol=1e-6,
                                   atol=1e-6, err_msg=f"row ({bi},{i})")


def test_window_floor_masks_like_cov():
    """tests/test_clustered_decode.py::test_paged_kernel_window_floor_
    masks_like_cov: (cov, wlo) is bit-identical to (max(cov, wlo), 0),
    and the floor really masks."""
    rng = np.random.default_rng(11)
    cl = np.ones(B, np.int32)
    _, args, rows = _paged_inputs(rng, B, C, R, HQ, HKV, DH, BS, T_SL, cl,
                                  np.array([2, 18, 0], np.int32))
    args = [T(a) for a in args]
    cov = args[-1]
    wlo = torch.tensor([5, 22, 8, 0, 0], dtype=torch.int32)
    run = lambda c, w: ops_t.paged_clustered_decode(  # noqa: E731
        *args[:-1], c, w, scale=DH ** -0.5)
    got = run(cov, wlo)
    assert torch.equal(got, run(torch.maximum(cov, wlo),
                                torch.zeros_like(wlo)))
    base = run(cov, None)
    assert (got - base)[:len(rows)].abs().amax((1, 2)).gt(0).all()


@pytest.fixture(scope="module")
def weights():
    params = tfm.init_params(jax.random.PRNGKey(0), TINY)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                            TINY_T, "cpu")


def test_decode_step_packed_matches_reference(weights):
    """Two packed steps (a chunk of 5 beside a decode row, then two
    decode rows) over a random paged cache carried across by value:
    logits and every layer's pool writes agree at 1e-5."""
    params, pt = weights
    rng = np.random.default_rng(3)
    b, nt, c, hkv, dh = 2, R // BS, 8, TINY.n_kv_heads, TINY.head_dim
    nb = b * nt + 1
    cache = tfm.init_cache(TINY, b, 64, kv_mode="clustered", kv_clusters=c,
                           kv_tail=R, kv_pool_blocks=nb, kv_block_size=BS)
    cache = jax.tree.map(np.asarray, cache)
    leaves = cache["scan"]["sub0"]
    lyr = leaves["k_cents"].shape[0]
    for key in ("k_cents", "v_cents", "k_tail", "v_tail"):
        leaves[key] = rng.normal(size=leaves[key].shape).astype(np.float32)
    leaves["counts"] = rng.integers(0, 3, size=(lyr, b, c, hkv)).astype(
        np.float32)
    leaves["cov"] = np.tile(np.array([0, 5], np.int32), (lyr, 1))
    bt = rng.permutation(nb)[:b * nt].reshape(b, nt).astype(np.int32)
    cache_t = bridge.cache_from_numpy(cache, TINY_T, "cpu")
    cache_j = jax.tree.map(jnp.asarray, cache)
    # (slot, token, position, ring watermark, index in chunk) + padding
    steps = [[(0, 7, i, 5, i) for i in range(5)] + [(1, 3, 20, 21, 0)],
             [(0, 9, 5, 6, 0), (1, 4, 21, 22, 0)]]
    for rows in steps:
        m = 8
        packed = np.zeros((5, m), np.int32)
        packed[2] = -1
        packed[:, :len(rows)] = np.asarray(rows, np.int32).T
        width = max(r[4] for r in rows) + 1
        want, cache_j = tfm.decode_step_packed(
            params, TINY, cache_j, *(jnp.asarray(x) for x in
                                     packed[[1, 0, 2, 3, 4]]),
            jnp.asarray(bt), block_size=BS, width=width)
        got, cache_t = tfm_t.decode_step_packed(
            pt, TINY_T, cache_t, *(T(x) for x in packed[[1, 0, 2, 3, 4]]),
            T(bt), block_size=BS, width=width)
        n = len(rows)
        np.testing.assert_allclose(got.numpy()[:n], np.asarray(want)[:n],
                                   rtol=ATOL, atol=ATOL)
        for li, leaf in enumerate(cache_t["layers"]):
            for key in ("k_tail", "v_tail"):
                want_pool = np.asarray(cache_j["scan"]["sub0"][key])[li]
                assert leaf[key].shape == (nb, BS, hkv, dh)
                np.testing.assert_allclose(leaf[key].numpy(), want_pool,
                                           rtol=ATOL, atol=ATOL, err_msg=key)


def _requests(spec, seed):
    rng = np.random.default_rng(seed)
    prompts = {i: rng.integers(0, 64, size=(l,)).astype(np.int32)
               for i, (l, _) in enumerate(spec)}
    return ([Request(i, l, g) for i, (l, g) in enumerate(spec)],
            [RequestT(i, l, g) for i, (l, g) in enumerate(spec)], prompts)


def _serve(weights, spec, seed, *, paged, port):
    """Tokens and stats of one serve on TINY with CCFG, batch 2,
    max_seq 96 and prefill_chunk 8."""
    params, pt = weights
    reqs, reqs_t, prompts = _requests(spec, seed)
    base = dict(batch_size=2, max_seq=96, prefill_chunk=8)
    if port:
        pg = kv_pool_t.PagedKVConfig(**paged) if paged else None
        srv = ServerT(TINY_T, ServerConfigT(kv_compress=CCFG_T, paged=pg,
                                            **base), pt, device="cpu")
        outs = srv.serve(reqs_t, prompts)
    else:
        pg = PagedKVConfig(**paged) if paged else None
        srv = Server(TINY, ServerConfig(kv_compress=CCFG, paged=pg, **base),
                     params)
        outs = srv.serve(reqs, prompts)
    return {o.uid: o.tokens for o in outs}, srv.last_stats


@pytest.fixture(scope="module")
def stream(weights):
    """The paged stream on both packages, and the port's dense serve."""
    pg = dict(block_size=4)
    return {"ref": _serve(weights, STREAM, 9, paged=pg, port=False),
            "port": _serve(weights, STREAM, 9, paged=pg, port=True),
            "dense": _serve(weights, STREAM, 9, paged=None, port=True)}


def test_paged_tokens_equal_reference_and_dense(stream):
    (want, st_ref), (got, st) = stream["ref"], stream["port"]
    assert got == want
    assert got == stream["dense"][0]
    for uid, (_, g) in enumerate(STREAM):
        assert len(got[uid]) == g
    assert set(st) == set(st_ref)        # last_stats under the same keys
    for key in ("decode_steps", "kv_absorbs", "kv_compactions",
                "kv_retired_frontier", "prefill_chunks", "launch_pad_frac",
                "launch_ragged_frac", "kv_frag", "kv_alloc_tokens_peak",
                "kv_bytes_peak_per_shard", "pool_blocks_total",
                "pool_blocks_peak", "pool_occupancy_peak", "pool_allocs",
                "pool_frees", "pool_blocks_end", "state_bytes_ring"):
        assert st[key] == st_ref[key], key


def test_pool_recycles_and_drains(stream):
    """TestPagedEngine.test_token_identical_to_dense and
    test_blocks_recycle_and_reallocate: compaction and absorbs ran, blocks
    were freed and handed out again, and the pool drains to zero."""
    st = stream["port"][1]
    assert st["kv_compactions"] > 0 and st["kv_absorbs"] > 0
    assert st["pool_blocks_end"] == 0.0
    assert 0.0 < st["pool_occupancy_peak"] <= 1.0
    assert st["pool_allocs"] > st["pool_blocks_peak"]
    assert st["pool_frees"] == st["pool_allocs"]


def test_packed_launch_pads_less_than_dense(stream):
    st, st_dense = stream["port"][1], stream["dense"][1]
    assert st["launch_pad_frac"] < st_dense["launch_pad_frac"]
    assert st["launch_ragged_frac"] > st_dense["launch_ragged_frac"]
    assert st["kv_bytes_peak_per_shard"] <= st_dense[
        "kv_bytes_peak_per_shard"]
    assert st["kv_frag"] < st_dense["kv_frag"]


@pytest.mark.parametrize("port", [False, True])
def test_oversubscribed_pool(weights, port):
    """TestPagedEngine.test_oversubscribed_pool_serves_short_streams with
    chunked admission: 5 blocks serve two slots of short requests with
    the dense tokens; 4 blocks on the deep stream stall every slot and
    raise PoolExhausted."""
    got, st = _serve(weights, SHORT, 3, port=port,
                     paged=dict(block_size=4, pool_blocks=5))
    assert got == _serve(weights, SHORT, 3, paged=None, port=True)[0]
    assert st["pool_occupancy_peak"] <= 1.0
    assert st["pool_blocks_end"] == 0.0
    err = kv_pool_t.PoolExhausted if port else PoolExhausted
    with pytest.raises(err, match="zero forward progress"):
        _serve(weights, STREAM, 9, port=port,
               paged=dict(block_size=4, pool_blocks=4))
