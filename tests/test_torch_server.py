"""The port's dense continuous engine against the reference Server on
TINY: greedy tokens are equal for exact KV with chunked admission (chunk 4
and 16) and for clustered KV streaming long prompts through absorb_chunk
and per-slot compaction (chunk 8).  Also the port's gates: no device
means CUDA, and every ServerConfig feature this slice lacks raises
NotImplementedError, paged serving included where this slice lacks it."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import kv_compress
from repro.core import request_cluster
from repro.core.request_cluster import Request
from repro.models import transformer as tfm
from repro.models.config import ModelConfig
from repro.runtime.server import Server, ServerConfig
from repro_torch import bridge
from repro_torch.core import kv_compress as kv_t
from repro_torch.core import request_cluster as request_cluster_t
from repro_torch.core.request_cluster import Request as RequestT
from repro_torch.models.config import ModelConfig as ModelConfigT
from repro_torch.runtime.kv_pool import PagedKVConfig as PagedKVConfigT
from repro_torch.runtime.server import Server as ServerT
from repro_torch.runtime.server import ServerConfig as ServerConfigT
from repro_torch.runtime.telemetry import TelemetryConfig

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
    params = tfm.init_params(jax.random.PRNGKey(0), TINY)
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
    ("engine", "static"),
    ("prefill_chunk", 0),
    # paged serving of exact KV (no kv_compress): QuotaRetention
    ("paged", PagedKVConfigT(block_size=4)),
    ("prefix_share", object()),
    ("template_store", object()),
    ("scheduler", object()),
    ("mesh", object()),
    ("telemetry", TelemetryConfig(trace=True)),
])
def test_unported_features_raise(weights, field, value):
    # static batches admit by blocking prefill: no chunk for that case
    kw = {"prefill_chunk": 0 if field == "engine" else 8, field: value}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServerT(TINY_T, ServerConfigT(**kw), weights[1], device="cpu")


def test_paged_blocking_admission_raises(weights):
    """Paged clustered serving needs chunked admission in this slice."""
    ccfg = kv_t.KVCompressConfig(keep_recent=16, refresh_every=8)
    with pytest.raises(NotImplementedError,
                       match="_write_slot_paged_impl.*item 6"):
        ServerT(TINY_T, ServerConfigT(kv_compress=ccfg, prefill_chunk=0,
                                      paged=PagedKVConfigT(block_size=4)),
                weights[1], device="cpu")


def test_paged_value_gates_kept(weights):
    ccfg = kv_t.KVCompressConfig(keep_recent=18, refresh_every=8)
    with pytest.raises(ValueError, match="must divide keep_recent"):
        ServerT(TINY_T, ServerConfigT(kv_compress=ccfg, prefill_chunk=8,
                                      paged=PagedKVConfigT(block_size=4)),
                weights[1], device="cpu")


def test_unported_layer_kinds_raise(weights):
    gl = dataclasses.replace(TINY_T, layer_pattern="GL", sliding_window=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServerT(gl, ServerConfigT(prefill_chunk=8), weights[1], device="cpu")


def test_reference_value_gates_kept(weights):
    ccfg = kv_t.KVCompressConfig(keep_recent=16, refresh_every=0)
    with pytest.raises(ValueError, match="refresh_every"):
        ServerT(TINY_T, ServerConfigT(kv_compress=ccfg, prefill_chunk=8),
                weights[1], device="cpu")
    ccfg = kv_t.KVCompressConfig(keep_recent=8, refresh_every=4)
    with pytest.raises(ValueError, match="keep_recent"):
        ServerT(TINY_T, ServerConfigT(prefill_chunk=16, kv_compress=ccfg),
                weights[1], device="cpu")


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
