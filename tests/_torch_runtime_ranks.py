"""The ranks of tests/test_torch_sharded_prefix.py's and
tests/test_torch_sharded_slo.py's gloo worlds (run through
``_torch_world``; imports neither JAX nor the reference).

Every rank builds the (data=2, model=4) serving mesh over the 8-rank world
and serves the reference's runtime-mode pins (tests/test_sharded_serving.py)
through the port's mesh engine on the weights the caller bridged from the
reference: prefix sharing (:167) and the warm template store (:213) in
``prefix_main``, SLO preemption over 'G' (:312) and over recurrent state,
'GM' (:513) and 'GR', in ``slo_main``.  Every rank runs the same host
engine, so all must return the same tokens and counters.  ``slo_main``
also serves the 'G' stream once with the swap payload's transfer planted
out (a resuming rank keeps its own stale rows) and twice with one rank's
clock running a million times fast past the best-effort deadlines.
"""

import hashlib
import time
import types

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import kv_compress
from repro_torch.core.request_cluster import Request
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.runtime.kv_pool import PagedKVConfig
from repro_torch.runtime.prefix_cache import PrefixShareConfig
from repro_torch.runtime.scheduler import SLOConfig
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.runtime.telemetry import TelemetryConfig, validate_trace
from repro_torch.runtime.template_store import TemplateStoreConfig
from repro_torch.sharding import rules as shard_rules

import _torch_family_ranks as family
import _torch_serving_ranks as serving

# the classes a ServerConfig is built from: the port's here, the
# reference's in the tests
PORT = types.SimpleNamespace(
    ServerConfig=ServerConfig, KVCompressConfig=kv_compress.KVCompressConfig,
    PagedKVConfig=PagedKVConfig, PrefixShareConfig=PrefixShareConfig,
    TemplateStoreConfig=TemplateStoreConfig, SLOConfig=SLOConfig,
    TelemetryConfig=TelemetryConfig)

PREFIX_STATS = ("n_data_shards", "prefix_hits", "prefix_tokens_reused",
                "prefill_chunks", "pool_blocks_end", "pool_allocs",
                "pool_frees", "template_pinned_blocks", "template_entries",
                "template_bytes_pinned")
SLO_STATS = ("n_data_shards", "sched_preemptions", "sched_swaps_in",
             "sched_swaps_out", "sched_sheds", "sched_shed_high",
             "sched_backlog_end", "sched_swap_bytes", "sched_deferrals",
             "sched_readopted_blocks", "sched_reuploaded_blocks",
             "pool_blocks_end", "pool_allocs", "pool_frees",
             "state_bytes_recurrent", "kv_retired_recurrent",
             "decode_steps")
# a best-effort TTFT deadline no serve reaches on a true clock
DEADLINE_MS = 600_000.0
SKEW = 1e6


def server_config(ns=PORT, *, pool=0, share=False, store=False, slo=False,
                  fifo=False, trace=False, mesh=None, chunk=8):
    """The pins' paged clustered ServerConfig (batch 4, max_seq 96,
    chunks of ``chunk`` (0: blocking admission), blocks of 4, ``pool``
    blocks a data shard, 0 = the slots' own) with the runtime mode asked
    for, from ``ns``'s classes."""
    kw = dict(batch_size=4, max_seq=96, prefill_chunk=chunk,
              kv_compress=ns.KVCompressConfig(**serving.CCFG),
              paged=ns.PagedKVConfig(block_size=4, pool_blocks=pool))
    if share:
        kw["prefix_share"] = ns.PrefixShareConfig()
    if store:
        kw["template_store"] = ns.TemplateStoreConfig()
    if slo:
        # arrival-order admission: the pins drive preemption and the swap
        kw["scheduler"] = ns.SLOConfig(priority_admission=False)
    if fifo:
        kw["use_clustered_batching"] = False
    if trace:
        kw["telemetry"] = ns.TelemetryConfig(trace=True)
    if mesh is not None:
        kw["mesh"] = mesh
    return ns.ServerConfig(**kw)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------


def _template_rng():
    """``default_rng(0)`` past the common stream's prompts: the pins'
    ``rng`` when they draw the 40-token template."""
    rng = np.random.default_rng(0)
    for l, _ in serving.stream()[0]:
        rng.integers(0, 64, size=(l,))
    return rng


def templated_stream(cls=Request):
    """:167's burst: 8 requests, the one 40-token template plus a suffix
    of 3-8 tokens, 6-11 new tokens each."""
    rng = _template_rng()
    tpl = rng.integers(0, 64, size=(40,)).astype(np.int32)
    reqs, prompts = [], {}
    for i in range(8):
        sfx = rng.integers(0, 64, size=(int(rng.integers(3, 9)),))
        prompts[i] = np.concatenate([tpl, sfx]).astype(np.int32)
        reqs.append(cls(i, len(prompts[i]), int(rng.integers(6, 12))))
    return reqs, prompts


def store_burst(sfx_seed, cls=Request):
    """:213's bursts: the same template, suffixes and budgets from
    ``default_rng(sfx_seed)`` (11, then 13)."""
    tpl = _template_rng().integers(0, 64, size=(40,)).astype(np.int32)
    r2 = np.random.default_rng(sfx_seed)
    reqs, prompts = [], {}
    for i in range(8):
        sfx = r2.integers(0, 64, size=(int(r2.integers(3, 9)),))
        prompts[i] = np.concatenate([tpl, sfx]).astype(np.int32)
        reqs.append(cls(i, len(prompts[i]), int(r2.integers(6, 12))))
    return reqs, prompts


def slo_stream(cls=Request, priority=True, deadline_ms=0.0):
    """:312's oversubscribed stream from ``default_rng(3)``: 10 requests
    of 6-29 prompt tokens and 6-13 new ones, uids 6-9 priority 1 (the
    protected class last), or all priority 0 when not ``priority`` (the
    unpressured serve); best-effort requests carry ``deadline_ms``."""
    srng = np.random.default_rng(3)
    reqs, prompts = [], {}
    for i in range(10):
        plen = int(srng.integers(6, 30))
        prompts[i] = srng.integers(0, 64, size=(plen,)).astype(np.int32)
        gen = int(srng.integers(6, 14))
        prio = 1 if (priority and i >= 6) else 0
        kw = dict(priority=prio)
        if deadline_ms and not prio:
            kw["deadline_ms"] = deadline_ms
        reqs.append(cls(i, plen, gen, **kw))
    return reqs, prompts


# ---------------------------------------------------------------------------
# serves
# ---------------------------------------------------------------------------


def config(model: str, model_cls=ModelConfig, ssm_cls=SSMConfig):
    """'G' is tests/test_sharded_serving.py's tiny4; 'GM' / 'GR' the
    recurrent pins' configs; 'moe' the reduced qwen2-moe in f32 (the
    port's)."""
    if model == "G":
        return serving.config("tiny4", model_cls)
    if model == "moe":
        return family.moe_config()
    return family.family_config(model, model_cls, ssm_cls)


def run(srv, stream, stats):
    """(tokens {uid: list}, shed {uid: bool}, {stat: value}) of one serve."""
    outs = srv.serve(*stream)
    return ({o.uid: list(o.tokens) for o in outs},
            {o.uid: bool(o.shed) for o in outs},
            {k: srv.last_stats.get(k) for k in stats})


def swap_events(trace):
    """The trace's swap_out and resume spans and shed events as (name,
    data shard, uid, why a shed)."""
    return [(e["name"], e["pid"], e["uid"], e["args"].get("why"))
            for e in trace if e["name"] in ("swap_out", "resume", "shed")]


def _params(weights, model):
    cfg = config(model)
    return cfg, bridge.params_from_numpy(weights[model], cfg, "cpu")


def prefix_main(rank, world, weights):
    """weights: {"G"}: a numpy tree (the reference layout)."""
    mesh = make_serving_mesh("2x4")
    cfg, params = _params(weights, "G")
    out = {}
    for name, kw in (("unshared", {}), ("shared", dict(share=True))):
        srv = Server(cfg, server_config(mesh=mesh, **kw), params,
                     device="cpu")
        out[name] = run(srv, templated_stream(), PREFIX_STATS)
    cold = Server(cfg, server_config(pool=24, mesh=mesh), params,
                  device="cpu")
    out["cold"] = run(cold, store_burst(13), PREFIX_STATS)
    srv = Server(cfg, server_config(pool=24, store=True, mesh=mesh), params,
                 device="cpu")
    out["warm1"] = run(srv, store_burst(11), PREFIX_STATS)
    out["warm2"] = run(srv, store_burst(13), PREFIX_STATS)
    pool = srv._tmpl_pool
    srv.invalidate_templates()
    out["drained"] = (srv._store.pinned_blocks(), pool.allocated())
    # the epoch rule on an MoE mesh, whose ranks hold different blocks of
    # the routed-expert banks: one epoch on every rank, and a change of the
    # weights on one rank alone changes every rank's
    mcfg = config("moe")
    epochs = []
    for perturbed in (False, True):
        p = tfm.init_params(0, mcfg, device="cpu")
        if perturbed and rank == 5:
            p["layers"][0]["moe"]["router"] += 1e-3
        srv = Server(mcfg, server_config(store=True, mesh=mesh), p,
                     device="cpu")
        epochs.append(srv._store_epoch[-1])
        out["moe_expert_bytes"] = srv.param_bytes()["experts"]
    out["epochs"] = epochs
    return out


def _fast_clock(real=time.perf_counter):
    """A ``perf_counter`` that runs SKEW times fast from now on."""
    t0 = real()
    return lambda: t0 + (real() - t0) * SKEW


def _digest(payload):
    h = hashlib.blake2b(digest_size=8)
    for t in shard_rules._leaves(payload, []):
        h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def _recording(move, log):
    """``move`` (a ``move_payload``) that logs each call's (src, dst,
    digest of the payload it was given, digest of the one it returns)."""
    def call(payload, group, src, dst, device):
        got = move(payload, group, src, dst, device)
        log.append((src, dst, _digest(payload), _digest(got)))
        return got
    return call


def _slo_serve(cfg, params, mesh, stream, pool=8, chunk=8):
    """A traced SLO serve over ``pool`` blocks a data shard: run()'s
    triple, the swap spans, the trace's problems and the payload moves."""
    moves = []
    moved = shard_rules.move_payload
    shard_rules.move_payload = _recording(moved, moves)
    try:
        srv = Server(cfg, server_config(pool=pool, slo=True, fifo=True,
                                        trace=True, mesh=mesh, chunk=chunk),
                     params, device="cpu")
        got = run(srv, stream, SLO_STATS)
    finally:
        shard_rules.move_payload = moved
    st = dict(srv.last_stats)
    return got + (swap_events(srv.last_trace),
                  validate_trace(srv.last_trace, totals=st), moves)


def slo_main(rank, world, weights):
    """weights: {"G", "GM", "GR"}: numpy trees."""
    mesh = make_serving_mesh("2x4")
    out = {"coord": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))}
    for model in ("G", "GM", "GR"):
        cfg, params = _params(weights, model)
        out[model] = _slo_serve(cfg, params, mesh, slo_stream())
    cfg, params = _params(weights, "G")
    # the planted fault: the resuming ranks keep the payload they built
    # from their own rows (stale), nothing crosses the data group
    moved = shard_rules.move_payload
    shard_rules.move_payload = lambda payload, *a, **k: payload
    try:
        out["G_fault"] = _slo_serve(cfg, params, mesh, slo_stream())
    finally:
        shard_rules.move_payload = moved
    # blocking admission over 4 blocks a shard defers best-effort
    # admissions; their deadline is read on one rank's clock running far
    # past it: rank 0's verdict holds for the world (rank 3: nobody sheds
    # for the deadline; rank 0: everybody does)
    out["G_blocking"] = _slo_serve(cfg, params, mesh, slo_stream(), pool=4,
                                   chunk=0)
    for skewed in (3, 0):
        clock = time.perf_counter
        if rank == skewed:
            time.perf_counter = _fast_clock()
        try:
            out[f"skew{skewed}"] = _slo_serve(
                cfg, params, mesh, slo_stream(deadline_ms=DEADLINE_MS),
                pool=4, chunk=0)
        finally:
            time.perf_counter = clock
    return out
