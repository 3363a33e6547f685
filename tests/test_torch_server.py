"""The port's Server against the reference Server on TINY.

Greedy tokens are equal for exact KV with chunked admission (chunk 4 and
16), for clustered KV streaming long prompts through absorb_chunk and
per-slot compaction (chunk 8), and with blocking admission (the
reference's default, ``prefill_chunk=0``): exact, clustered (prompts in
the ring alone and prompts clustered whole by compress_cache_batched),
dense and paged, with a pool small enough to defer admissions; and for
the static engine.  The port keeps the reference's invariants: chunked
admission gives blocking admission's tokens (exact KV, and clustered
prompts that fit the ring), paged blocking gives dense blocking's.  Also
``compact_kv`` over an exact prefill cache, and the port's gates: no
device means CUDA, every ServerConfig feature the port lacks raises
NotImplementedError, and misused prefix sharing raises the reference's
ValueErrors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.core import kv_compress
from repro.core import request_cluster
from repro.core.request_cluster import Request
from repro.models import transformer as tfm
from repro.models.config import ModelConfig
from repro.runtime.kv_pool import PagedKVConfig
from repro.runtime.server import Server, ServerConfig
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.core import kv_compress as kv_t
from repro_torch.core import request_cluster as request_cluster_t
from repro_torch.core.request_cluster import Request as RequestT
from repro_torch.models import transformer as tfm_t
from repro_torch.models.config import ModelConfig as ModelConfigT
from repro_torch.runtime import kv_pool as kv_pool_t
from repro_torch.runtime import prefix_cache as prefix_cache_t
from repro_torch.runtime import scheduler as scheduler_t
from repro_torch.runtime import template_store as template_store_t
from repro_torch.runtime.kv_pool import PagedKVConfig as PagedKVConfigT
from repro_torch.runtime.server import Server as ServerT
from repro_torch.runtime.server import ServerConfig as ServerConfigT

from _torch_ref import exact_pow2_reference, ref_init_params  # noqa: F401

_TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                pad_vocab_multiple=16, dtype="float32")
TINY = ModelConfig(**_TINY_KW)
TINY_T = ModelConfigT(**_TINY_KW)
PIECES = [(5, 4), (23, 6), (9, 3), (17, 5), (6, 1), (21, 4)]
# tests/test_serving_engine.py::test_long_prompt_streams_through_absorb,
# plus longer decodes so per-slot compaction runs too
LONG = [(60, 6), (9, 4), (48, 5)]
LONG_DECODE = [(60, 20), (9, 14), (48, 17), (30, 25)]


@pytest.fixture(scope="module")
def weights():
    params = ref_init_params(TINY)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                            TINY_T, "cpu")


def _requests(spec, seed):
    rng = np.random.default_rng(seed)
    prompts = {i: rng.integers(0, 64, size=(l,)).astype(np.int32)
               for i, (l, _) in enumerate(spec)}
    return ([Request(i, l, g) for i, (l, g) in enumerate(spec)],
            [RequestT(i, l, g) for i, (l, g) in enumerate(spec)], prompts)


def _serve_both(weights, spec, seed, ccfg=None, **kw):
    params, pt = weights
    reqs, reqs_t, prompts = _requests(spec, seed)
    ccfg_t = (kv_t.KVCompressConfig(**dataclasses.asdict(ccfg))
              if ccfg is not None else None)
    ref = Server(TINY, ServerConfig(kv_compress=ccfg, **kw), params)
    want = {o.uid: o.tokens for o in ref.serve(reqs, prompts)}
    srv = ServerT(TINY_T, ServerConfigT(kv_compress=ccfg_t, **kw), pt,
                  device="cpu")
    got = {o.uid: o.tokens for o in srv.serve(reqs_t, prompts)}
    return want, got, ref.last_stats, srv.last_stats


@pytest.mark.parametrize("chunk", [4, 16])
def test_exact_kv_tokens_equal_reference(weights, chunk):
    want, got, st_ref, st = _serve_both(weights, PIECES, 0, batch_size=2,
                                        max_seq=64, prefill_chunk=chunk)
    assert got == want
    assert set(st) == set(st_ref)        # last_stats under the same keys
    for uid, (_, g) in enumerate(PIECES):
        assert len(got[uid]) == g
    for key in ("gen_tokens", "decode_steps", "prefill_chunks", "slot_waste",
                "launch_rows_frac", "launch_pad_frac"):
        assert st[key] == st_ref[key], key
    assert st["ttft_p95_ms"] > 0 and st["itl_p50_ms"] >= 0


@pytest.mark.parametrize("spec,seed", [(LONG, 9), (LONG_DECODE, 9)])
def test_clustered_kv_tokens_equal_reference(weights, spec, seed):
    ccfg = kv_compress.KVCompressConfig(n_clusters=8, iters=4,
                                        keep_recent=16, refresh_every=8)
    want, got, st_ref, st = _serve_both(weights, spec, seed, ccfg=ccfg,
                                        batch_size=2, max_seq=64,
                                        prefill_chunk=8)
    assert got == want
    assert set(st) == set(st_ref)
    assert st["kv_absorbs"] > 0
    for key in ("kv_absorbs", "kv_compactions", "kv_retired_frontier",
                "decode_steps", "kv_frag", "launch_bucket_mean",
                "state_bytes_ring", "kv_bytes_peak_per_shard"):
        assert st[key] == st_ref[key], key
    if spec is LONG_DECODE:
        assert st["kv_compactions"] > 0


def test_bucket_shrinks_on_drain(weights):
    """One straggler keeps decoding after the others exit: the launch
    bucket walks down and the tokens stay equal."""
    spec = [(9, 30), (12, 3), (7, 2), (15, 3)]
    want, got, st_ref, st = _serve_both(weights, spec, 4, batch_size=4,
                                        max_seq=64, prefill_chunk=8)
    assert got == want
    assert st["launch_rows_frac"] < 1.0
    assert st["launch_rows_frac"] == st_ref["launch_rows_frac"]


def test_server_defaults_to_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServerT(TINY_T, ServerConfigT(prefill_chunk=8), weights[1])


@pytest.mark.parametrize("field,value", [
    ("mesh", object()),
])
def test_unported_features_raise(weights, field, value):
    """``mesh=`` serves since the mesh slice
    (tests/test_torch_sharded_serving.py), every model family since 10b
    and 10c's first part, and under the SLO scheduler, prefix sharing and
    the template store since 10c's second part
    (tests/test_torch_sharded_slo.py, tests/test_torch_sharded_prefix.py):
    no mode gate stops a scheduled mesh serve, and the first check it
    meets is the mesh's type.  ``scheduler=`` and tracing serve since the
    SLO slice (tests/test_torch_scheduler.py,
    tests/test_torch_telemetry.py)."""
    kw = {"prefill_chunk": 8, "kv_compress": _SHARE_CC,
          "paged": PagedKVConfigT(block_size=4),
          "scheduler": scheduler_t.SLOConfig(), field: value}
    with pytest.raises(TypeError, match="mesh= takes a DeviceMesh"):
        ServerT(TINY_T, ServerConfigT(**kw), weights[1], device="cpu")


_SHARE_CC = kv_t.KVCompressConfig(n_clusters=8, iters=4, keep_recent=16,
                                  refresh_every=8)


@pytest.mark.parametrize("kw,match", [
    # tests/test_serving_engine.py::TestPrefixSharing::test_validation
    (dict(kv_compress=_SHARE_CC, prefill_chunk=8,
          prefix_share=prefix_cache_t.PrefixShareConfig()), "prefix_share"),
    (dict(kv_compress=_SHARE_CC, paged=PagedKVConfigT(block_size=4),
          prefix_share=prefix_cache_t.PrefixShareConfig()), "prefix_share"),
    (dict(kv_compress=_SHARE_CC, prefill_chunk=8,
          paged=PagedKVConfigT(block_size=4),
          prefix_share=prefix_cache_t.PrefixShareConfig(),
          template_store=template_store_t.TemplateStoreConfig()),
     "subsumes prefix_share"),
    # 'L' window rings are in no slot snapshot
    (dict(kv_compress=_SHARE_CC, prefill_chunk=8,
          paged=PagedKVConfigT(block_size=4), layer_pattern="GL",
          prefix_share=prefix_cache_t.PrefixShareConfig()),
     "'L' window rings are not in snapshots"),
])
def test_prefix_share_value_gates(weights, kw, match):
    """Prefix sharing and the template store serve since the prefix slice
    (tests/test_torch_prefix_serving.py); their misuse raises the
    reference's ValueErrors."""
    kw = dict(kw)
    cfg = TINY_T
    if "layer_pattern" in kw:
        cfg = dataclasses.replace(TINY_T, sliding_window=16,
                                  layer_pattern=kw.pop("layer_pattern"))
    with pytest.raises(ValueError, match=match):
        ServerT(cfg, ServerConfigT(batch_size=2, max_seq=96, **kw),
                weights[1], device="cpu")


def test_paged_value_gates_kept(weights):
    ccfg = kv_t.KVCompressConfig(keep_recent=18, refresh_every=8)
    with pytest.raises(ValueError, match="must divide keep_recent"):
        ServerT(TINY_T, ServerConfigT(kv_compress=ccfg, prefill_chunk=8,
                                      paged=PagedKVConfigT(block_size=4)),
                weights[1], device="cpu")


def test_unported_layer_kinds_raise(weights):
    """Every layer kind of the zoo serves: 'L' layers since the
    sliding-window slice (tests/test_torch_window_serving.py), 'M' and 'R'
    since the recurrent slice (tests/test_torch_recurrent_serving.py), MoE
    FFNs since the MoE slice (tests/test_torch_moe_serving.py), MLA, the
    frontend stubs and encoder-decoders since this slice
    (tests/test_torch_mla_serving.py, tests/test_torch_encdec.py), so
    'GM', qwen2-moe, deepseek-v3, internvl2 and seamless Servers build.
    An unknown layer kind still raises."""
    bad = dataclasses.replace(TINY_T, layer_pattern="GX")
    with pytest.raises(NotImplementedError, match="unknown layer kinds"):
        ServerT(bad, ServerConfigT(), weights[1], device="cpu")
    gm = dataclasses.replace(TINY_T, layer_pattern="GM",
                             ssm=configs_t.get_reduced("mamba2-2.7b").ssm)
    ServerT(gm, ServerConfigT(prefill_chunk=8),
            tfm_t.init_params(0, gm, device="cpu"), device="cpu")
    moe = configs_t.get_reduced("qwen2-moe-a2.7b")
    ServerT(moe, ServerConfigT(prefill_chunk=8),
            tfm_t.init_params(0, moe, device="cpu"), device="cpu")
    for arch in ("deepseek-v3-671b", "internvl2-76b", "seamless-m4t-medium"):
        cfg = configs_t.get_reduced(arch)
        ServerT(cfg, ServerConfigT(),
                tfm_t.init_params(0, cfg, device="cpu"), device="cpu")


def test_reference_value_gates_kept(weights):
    ccfg = kv_t.KVCompressConfig(keep_recent=16, refresh_every=0)
    with pytest.raises(ValueError, match="refresh_every"):
        ServerT(TINY_T, ServerConfigT(kv_compress=ccfg, prefill_chunk=8),
                weights[1], device="cpu")
    ccfg = kv_t.KVCompressConfig(keep_recent=8, refresh_every=4)
    with pytest.raises(ValueError, match="keep_recent"):
        ServerT(TINY_T, ServerConfigT(prefill_chunk=16, kv_compress=ccfg),
                weights[1], device="cpu")
    # the static engine serves exact KV from unpaged caches only
    for kw in (dict(kv_compress=ccfg), dict(paged=PagedKVConfigT(4)),
               dict(prefill_chunk=8)):
        with pytest.raises(ValueError, match="engine"):
            ServerT(TINY_T, ServerConfigT(engine="static", **kw), weights[1],
                    device="cpu")


@pytest.mark.parametrize("batch", [2, 3])
def test_batch_plans_match(batch):
    """Admission order: the small-queue length sort and FIFO plans (and
    their padding waste) equal the reference's.  Large queues, not built
    here, cluster through a k-means++ fit whose draws equal the
    reference's since the threefry port (ROADMAP Queue C 2, closed)."""
    reqs, reqs_t, _ = _requests(PIECES, 0)
    for fn, fn_t in ((request_cluster.plan_batches,
                      request_cluster_t.plan_batches),
                     (request_cluster.plan_fifo,
                      request_cluster_t.plan_fifo)):
        want, got = fn(reqs, batch), fn_t(reqs_t, batch)
        assert got.batches == want.batches
        assert got.waste == pytest.approx(want.waste)


# ---------------------------------------------------------------------------
# blocking admission and the static engine
# ---------------------------------------------------------------------------

# tests/test_serving_engine.py: TestChunkedPrefill's short-prompt config
# (every prompt fits the ring less refresh: the ring-alone form), and the
# long-prompt config of TestPagedEngine (clustered whole at admission)
CCFG_SHORT = kv_compress.KVCompressConfig(n_clusters=8, iters=4,
                                          keep_recent=32, refresh_every=4)
CCFG = kv_compress.KVCompressConfig(n_clusters=8, iters=4, keep_recent=16,
                                    refresh_every=8)
STREAM = [(60, 12), (9, 10), (48, 9), (21, 14)]      # TestPagedEngine._stream
BLOCKING = {
    "exact_b2": (PIECES, 0, None, dict(batch_size=2, max_seq=64)),
    "exact_b3_bucket8_fifo": (PIECES, 0, None, dict(
        batch_size=3, max_seq=64, prefill_bucket=8,
        use_clustered_batching=False)),
    "clustered_short": (PIECES, 0, CCFG_SHORT, dict(batch_size=2,
                                                    max_seq=64)),
    "clustered_long": (LONG_DECODE, 9, CCFG, dict(batch_size=2, max_seq=64)),
    "paged": (STREAM, 9, CCFG, dict(batch_size=2, max_seq=96,
                                    paged=(4, 0))),
    "dense_stream": (STREAM, 9, CCFG, dict(batch_size=2, max_seq=96)),
    "static_b1": (PIECES, 0, None, dict(batch_size=1, max_seq=64,
                                        engine="static",
                                        use_clustered_batching=False)),
    "static_b4": (PIECES, 0, None, dict(batch_size=4, max_seq=64,
                                        engine="static")),
}
# port-only counts of blocking clustered admission (Server.last_admission,
# outside the metrics registry)
PORT_ONLY = {"kv_admit_compress", "kv_admit_tail", "clusterize_s"}


def _paged_kw(kw, port):
    kw = dict(kw)
    if "paged" in kw:
        bs, nb = kw.pop("paged")
        kw["paged"] = (PagedKVConfigT if port else PagedKVConfig)(
            block_size=bs, pool_blocks=nb)
    return kw


def _serve_port(pt, spec, seed, ccfg=None, **kw):
    _, reqs_t, prompts = _requests(spec, seed)
    ccfg_t = (kv_t.KVCompressConfig(**dataclasses.asdict(ccfg))
              if ccfg is not None else None)
    srv = ServerT(TINY_T, ServerConfigT(kv_compress=ccfg_t,
                                        **_paged_kw(kw, True)), pt,
                  device="cpu")
    return {o.uid: o.tokens for o in srv.serve(reqs_t, prompts)}, \
        dict(srv.last_stats, **srv.last_admission)


@pytest.fixture(scope="module")
def blocking(weights):
    """Each BLOCKING case served once by each package, on first use:
    name -> (reference tokens, port tokens, reference stats, port stats)."""
    params, pt = weights
    done = {}

    def get(name):
        if name not in done:
            spec, seed, ccfg, kw = BLOCKING[name]
            reqs, _, prompts = _requests(spec, seed)
            ref = Server(TINY, ServerConfig(kv_compress=ccfg,
                                            **_paged_kw(kw, False)), params)
            want = {o.uid: o.tokens for o in ref.serve(reqs, prompts)}
            got, st = _serve_port(pt, spec, seed, ccfg, **kw)
            done[name] = (want, got, ref.last_stats, st)
        return done[name]
    return get


@pytest.mark.parametrize("name", list(BLOCKING))
def test_blocking_and_static_tokens_equal_reference(blocking, name):
    want, got, st_ref, st = blocking(name)
    spec, _, ccfg, kw = BLOCKING[name]
    assert got == want
    for uid, (_, g) in enumerate(spec):
        assert len(got[uid]) == g
    if kw.get("engine") == "static":
        assert st == st_ref                          # plan_waste alone
        return
    # last_stats under the reference's keys, and the port-only counts of
    # blocking clustered admission
    assert set(st) - PORT_ONLY == set(st_ref)
    for key in ("gen_tokens", "decode_steps", "prefill_pad_frac",
                "prefill_chunks", "kv_absorbs", "kv_compactions",
                "kv_retired_frontier", "slot_waste", "launch_rows_frac",
                "launch_pad_frac", "kv_frag", "kv_bytes_peak_per_shard",
                "pool_blocks_peak", "pool_allocs", "pool_frees",
                "pool_blocks_end"):
        assert st.get(key) == st_ref.get(key), key
    assert st["kv_absorbs"] == 0 and st["prefill_chunks"] == 0
    assert 0 < st["prefill_pad_frac"] < 1
    if ccfg is not None:
        assert set(st) >= PORT_ONLY
        long = sum(l > ccfg.keep_recent - ccfg.refresh
                   for l, g in spec if g > 1)
        assert (st["kv_admit_compress"], st["kv_admit_tail"]) == (
            long, sum(g > 1 for _, g in spec) - long)


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_equals_blocking_exact(blocking, weights, chunk):
    """TestChunkedPrefill.test_token_identical_to_blocking in the port:
    the same tokens whether prompts stream in chunks or admit whole (and
    both equal one-at-a-time static decode)."""
    got, st = _serve_port(weights[1], PIECES, 0, batch_size=2, max_seq=64,
                          prefill_chunk=chunk)
    assert got == blocking("exact_b2")[1] == blocking("static_b1")[1]
    assert st["prefill_pad_frac"] == 0.0 and st["prefill_chunks"] > 0


def test_chunked_equals_blocking_clustered_short(blocking, weights):
    """TestChunkedPrefill.test_clustered_short_prompts_token_identical in
    the port: prompts that fit the ring admit loss-free either way."""
    got, st = _serve_port(weights[1], PIECES, 0, CCFG_SHORT, batch_size=2,
                          max_seq=64, prefill_chunk=8)
    assert got == blocking("clustered_short")[1]
    assert st["kv_absorbs"] == 0.0


def test_paged_blocking_equals_dense_blocking(blocking):
    """TestPagedEngine.test_token_identical_to_dense at chunk 0 in the
    port: compaction ran, every block came back."""
    _, got, _, st = blocking("paged")
    assert got == blocking("dense_stream")[1]
    assert st["kv_compactions"] > 0 and st["kv_admit_compress"] > 0
    assert st["pool_blocks_end"] == 0.0
    assert st["pool_frees"] == st["pool_allocs"] > st["pool_blocks_peak"]


def test_oversubscribed_paged_blocking_defers(weights, monkeypatch):
    """A pool of 4 blocks (one slot's ring) for two slots: a 14-token
    prompt keeps 3 blocks live, so the second admission finds one free
    block, stays at the queue head until the first request exits, and
    every request still gets the dense tokens (the reference's too)."""
    params, pt = weights
    spec = [(14, 3), (14, 3), (7, 2)]
    reqs, _, prompts = _requests(spec, 5)
    ref = Server(TINY, ServerConfig(batch_size=2, max_seq=96,
                                    kv_compress=CCFG,
                                    paged=PagedKVConfig(block_size=4,
                                                        pool_blocks=4)),
                 params)
    want = {o.uid: o.tokens for o in ref.serve(reqs, prompts)}
    dense, _ = _serve_port(pt, spec, 5, CCFG, batch_size=2, max_seq=96)
    refused = []
    ensure = kv_pool_t.BlockPool.ensure

    def spy(self, *a, **k):
        try:
            return ensure(self, *a, **k)
        except kv_pool_t.PoolExhausted:
            refused.append(a[0])
            raise
    monkeypatch.setattr(kv_pool_t.BlockPool, "ensure", spy)
    got, st = _serve_port(pt, spec, 5, CCFG, batch_size=2, max_seq=96,
                          paged=(4, 4))
    assert refused, "no admission was deferred"
    assert got == want == dense
    assert st["pool_blocks_end"] == 0.0 and st["pool_occupancy_peak"] <= 1


def test_oversubscribed_paged_blocking_short_and_deep(weights):
    """TestPagedEngine.test_oversubscribed_pool_serves_short_streams in the
    port: 5 blocks serve short requests with the dense tokens; 4 blocks on
    the deep stream raise PoolExhausted at zero forward progress."""
    pt = weights[1]
    short = [(5, 3), (4, 2), (6, 2), (5, 3), (4, 2)]
    got, st = _serve_port(pt, short, 3, CCFG, batch_size=2, max_seq=96,
                          paged=(4, 5))
    assert got == _serve_port(pt, short, 3, CCFG, batch_size=2,
                              max_seq=96)[0]
    assert st["pool_occupancy_peak"] <= 1.0
    with pytest.raises(kv_pool_t.PoolExhausted, match="zero forward"):
        _serve_port(pt, STREAM, 9, CCFG, batch_size=2, max_seq=96,
                    paged=(4, 4))


@pytest.fixture(scope="module")
def one_layer():
    """tests/test_clustered_decode.py::test_server_compact_kv_roundtrip's
    model: the reduced qwen3 cut to one layer, in f32, and the reference's
    prefill cache of a 96-token prompt (max_seq 128), carried across."""
    cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"), n_layers=1,
                              dtype="float32")
    cfg_t = dataclasses.replace(configs_t.get_reduced("qwen3-4b"),
                                n_layers=1, dtype="float32")
    params = ref_init_params(cfg)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                  "cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, size=(1, 96))
    _, cache = tfm.prefill(params, cfg, jnp.asarray(toks, jnp.int32),
                           max_seq=128)
    cache_t = bridge.cache_from_numpy(jax.tree.map(np.asarray, cache), cfg_t,
                                      "cpu")
    return cfg, cfg_t, params, pt, toks, cache, cache_t


def test_server_compact_kv_exact_roundtrip(one_layer, exact_pow2_reference):
    """compact_kv turns the exact prefill cache into clustered leaves with
    the reference's bits (value centroids within 1e-5), which decode to
    logits within 1e-4 of the reference's and close to exact decode."""
    cfg, cfg_t, params, pt, toks, cache, cache_t = one_layer
    # iters 5: a config no other test traces (compress_cache_batched jits
    # per config, and this trace must see the exact-power patch)
    ccfg = kv_compress.KVCompressConfig(n_clusters=12, iters=5,
                                        keep_recent=16)
    want = Server(cfg, ServerConfig(max_seq=128), params).compact_kv(
        cache, t=96, ccfg=ccfg)
    srv = ServerT(cfg_t, ServerConfigT(max_seq=128), pt, device="cpu")
    got = srv.compact_kv(cache_t, 96, kv_t.KVCompressConfig(
        **dataclasses.asdict(ccfg)))
    assert got["layers"][0]["k_cents"].shape == (1, 12, cfg_t.n_kv_heads,
                                                  cfg_t.head_dim)
    want_t = bridge.cache_from_numpy(jax.tree.map(np.asarray, want), cfg_t)
    leaf, ref = got["layers"][0], want_t["layers"][0]
    assert leaf.keys() == ref.keys()
    for key in leaf:
        if key == "v_cents":
            torch.testing.assert_close(leaf[key], ref[key], rtol=1e-5,
                                       atol=1e-5)
        else:
            assert torch.equal(leaf[key], ref[key]), key
    le, _ = tfm_t.decode_step(pt, cfg_t, cache_t, torch.from_numpy(
        toks[:, -1:]), 96)
    lc, _ = tfm_t.decode_step(pt, cfg_t, got, torch.from_numpy(toks[:, -1:]),
                              96)
    lr, _ = tfm.decode_step(params, cfg, want, jnp.asarray(toks[:, -1:],
                                                           jnp.int32),
                            jnp.int32(96))
    np.testing.assert_allclose(lc.numpy(), np.asarray(lr), rtol=1e-4,
                               atol=1e-4)
    assert bool(torch.isfinite(lc).all())
    cos = float((le * lc).sum() / (le.norm() * lc.norm()))
    assert cos > 0.98, cos


def test_server_compact_kv_leaves_short_exact_caches(one_layer):
    """An exact cache of at most C + R positions is not worth compressing:
    compact_kv passes it through."""
    _, cfg_t, _, pt, _, _, cache_t = one_layer
    srv = ServerT(cfg_t, ServerConfigT(max_seq=128), pt, device="cpu")
    got = srv.compact_kv(cache_t, 96, kv_t.KVCompressConfig(
        n_clusters=100, keep_recent=28))
    assert got["layers"][0] is cache_t["layers"][0]


def test_write_slot_paged_drops_covered_blocks():
    """_write_slot_paged: slot 1's centroids, counts and cov, and its ring
    blocks 1 and 3 into pool blocks 6 and 2; covered ring blocks (n_blocks
    in the write row) are dropped, and every other pool block and slot
    keeps its bytes."""
    g = torch.Generator().manual_seed(3)
    cache = tfm_t.init_cache(TINY_T, 2, 64, kv_mode="clustered",
                             kv_clusters=4, kv_tail=16, kv_pool_blocks=9,
                             kv_block_size=4, device="cpu")
    src = tfm_t.init_cache(TINY_T, 1, 64, kv_mode="clustered", kv_clusters=4,
                           kv_tail=16, device="cpu")
    for c in (cache, src):
        for leaf in c["layers"]:
            for val in leaf.values():
                val.copy_(torch.randn(val.shape, generator=g).to(val.dtype)
                          if val.is_floating_point()
                          else torch.randint(0, 9, val.shape, generator=g))
    before = [{k: v.clone() for k, v in leaf.items()}
              for leaf in cache["layers"]]
    ServerT._write_slot_paged(cache, src, 1, np.array([9, 6, 9, 2]), 4)
    for leaf, old, s in zip(cache["layers"], before, src["layers"]):
        for key in ("k_cents", "v_cents", "counts", "cov"):
            assert torch.equal(leaf[key][1], s[key][0])
            assert torch.equal(leaf[key][0], old[key][0])
        for key in ("k_tail", "v_tail"):
            ring = s[key][0].reshape(4, 4, *s[key].shape[2:])
            assert torch.equal(leaf[key][6], ring[1])
            assert torch.equal(leaf[key][2], ring[3])
            for blk in set(range(9)) - {2, 6}:
                assert torch.equal(leaf[key][blk], old[key][blk])
