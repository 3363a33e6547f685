"""Prefix sharing and the template store on the port's mesh: a (data=2,
model=4) gloo world of 8 spawned CPU ranks serves the twins of
tests/test_sharded_serving.py's ``test_sharded_prefix_sharing_parity``
(:167) and ``test_sharded_template_store_warm_parity`` (:213) on the
reference's ``tiny4`` (f32, 4 / 4 heads of 16) and its weights (bridged).

* Prefix sharing: a 40-token template with short suffixes, paged chunked
  clustered.  The shared mesh serve's tokens equal the unshared mesh
  serve's, the port's shared single-device serve's and the reference's;
  the shard-local maps still hit, and the pool drains.
* The template store: one mesh Server serves two bursts of the template;
  the warm second serve's tokens equal a cold mesh serve's, the port's
  warm single-device serve's and the reference's; it hits the store, the
  pins survive the drain in each shard's pool block, and
  ``invalidate_templates()`` drains the pool.
* The store's epoch on an MoE mesh, whose ranks hold different blocks of
  the routed-expert banks: one value on every rank, and weights changed
  on one rank alone change it on every rank, so no two ranks can come up
  one warm and one cold.

Every rank returns the same tokens and counters (one host engine, run
SPMD), and they are those of the reference's own 2 x 4 mesh serves
(``_ref_mesh_runs``, 8 fake XLA devices in a child process).  The ranks (``_torch_runtime_ranks.prefix_main``) serve while this
process runs the reference's and the single-device serves."""

import types

import jax
import numpy as np
import pytest

from repro.core import kv_compress as kv_ref
from repro.core import quantizer as quantizer_ref
from repro.core.request_cluster import Request as RequestRef
from repro.models.config import ModelConfig as ModelConfigRef
from repro.runtime.kv_pool import PagedKVConfig as PagedKVConfigRef
from repro.runtime.prefix_cache import PrefixShareConfig as PrefixRef
from repro.runtime.server import Server as ServerRef
from repro.runtime.server import ServerConfig as ServerConfigRef
from repro.runtime.template_store import TemplateStoreConfig as StoreRef
from repro_torch import bridge
from repro_torch.runtime.server import Server

import _ref_mesh_runs
import _torch_ref
import _torch_runtime_ranks as ranks
from _torch_world import World

REF = types.SimpleNamespace(
    ServerConfig=ServerConfigRef, KVCompressConfig=kv_ref.KVCompressConfig,
    PagedKVConfig=PagedKVConfigRef, PrefixShareConfig=PrefixRef,
    TemplateStoreConfig=StoreRef)


def _serve(server, ns, params, kw, streams):
    """Tokens of each of ``streams`` through one Server (a store keeps its
    entries from one serve to the next)."""
    if ns is REF:
        srv = server(ranks.config("G", ModelConfigRef),
                     ranks.server_config(ns, **kw), params)
    else:
        srv = server(ranks.config("G"), ranks.server_config(ns, **kw),
                     params, device="cpu")
    out = []
    for reqs, prompts in streams:
        out.append(({o.uid: list(o.tokens) for o in srv.serve(reqs, prompts)},
                    dict(srv.last_stats)))
    return out


@pytest.fixture(scope="module")
def runs():
    weights = {"G": jax.tree.map(np.asarray, _torch_ref.ref_init_params(
        ranks.config("G", ModelConfigRef), 0))}
    ref_mesh = _ref_mesh_runs.start("prefix")
    world = World("_torch_runtime_ranks:prefix_main", 8, weights=weights)
    tpl = ranks.templated_stream
    bursts = [ranks.store_burst(s) for s in (11, 13)]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quantizer_ref, "auto_scale", _torch_ref._auto_scale_exact)
        out["ref_shared"] = _serve(ServerRef, REF, weights["G"],
                                   dict(share=True), [tpl(RequestRef)])[0]
        out["ref_warm"] = _serve(
            ServerRef, REF, weights["G"], dict(pool=24, store=True),
            [ranks.store_burst(s, RequestRef) for s in (11, 13)])
    params = bridge.params_from_numpy(weights["G"], ranks.config("G"), "cpu")
    out["shared"] = _serve(Server, ranks.PORT, params, dict(share=True),
                           [tpl()])[0]
    out["warm"] = _serve(Server, ranks.PORT, params,
                         dict(pool=24, store=True), bursts)
    out["ranks"] = world.result()
    out["ref_mesh"] = _ref_mesh_runs.result(ref_mesh)
    return out


def test_sharded_prefix_sharing_parity(runs):
    """Shared mesh == unshared mesh == shared single device == the
    reference's; the shard-local maps get hits; the pool drains."""
    ref_toks, ref_st = runs["ref_shared"]
    single, single_st = runs["shared"]
    assert single == ref_toks
    assert single_st["prefix_hits"] == ref_st["prefix_hits"] > 0
    rank0 = runs["ranks"][0]
    shared, _, st = rank0["shared"]
    unshared = rank0["unshared"][0]
    assert sorted(shared) == sorted(ref_toks)
    for uid, t in shared.items():
        assert t == unshared[uid] == ref_toks[uid], uid
    assert st["n_data_shards"] == 2.0
    assert st["prefix_hits"] > 0
    assert st["prefix_tokens_reused"] > 0
    assert st["pool_blocks_end"] == 0.0
    assert st["pool_allocs"] == st["pool_frees"]


def test_sharded_template_store_warm_parity(runs):
    """The warm mesh serve == a cold mesh serve == the warm single-device
    serve == the reference's; pins survive the drain; the warm serve
    hits; ``invalidate_templates()`` drains the pool."""
    (_, ref_st1), (ref2, ref_st2) = runs["ref_warm"]
    (_, st1), (single2, st2) = runs["warm"]
    assert single2 == ref2
    assert st2["prefix_hits"] == ref_st2["prefix_hits"] > 0
    assert st1["template_pinned_blocks"] == ref_st1["template_pinned_blocks"]
    rank0 = runs["ranks"][0]
    warm2, _, wst2 = rank0["warm2"]
    cold2 = rank0["cold"][0]
    for uid, t in warm2.items():
        assert t == cold2[uid] == ref2[uid], uid
    assert rank0["warm1"][2]["template_pinned_blocks"] > 0
    assert wst2["prefix_hits"] > 0          # warm across the serve gap
    assert wst2["pool_blocks_end"] == 0.0
    # a pinned block's bytes count every kv head, as on one device (the
    # warm serve's parked cache is the rank's head block)
    assert (wst2["template_bytes_pinned"] / wst2["template_pinned_blocks"]
            == st2["template_bytes_pinned"] / st2["template_pinned_blocks"])
    assert rank0["cold"][2]["prefix_hits"] is None
    assert rank0["drained"] == (0, 0)


@pytest.mark.parametrize("name", ["shared", "warm1", "warm2"])
def test_counters_equal_the_reference_mesh(runs, name):
    """The reference's own 2 x 4 mesh serves (8 fake XLA devices, in a
    child process): the same tokens and the same hits, reused tokens,
    prefill chunks, pool and store counters (per-shard maps, steering by
    match and by traffic cluster, the store's pins per shard)."""
    toks, _, st = runs["ref_mesh"][name]
    got = runs["ranks"][0][name]
    assert got[0] == {int(k): v for k, v in toks.items()}
    assert got[2] == st


def test_every_rank_serves_the_same(runs):
    """One host engine, run SPMD: every rank's tokens and counters are
    rank 0's, the warm-or-cold decision included."""
    per_rank = runs["ranks"]
    for name in ("unshared", "shared", "cold", "warm1", "warm2", "drained"):
        for r, got in enumerate(per_rank):
            assert got[name] == per_rank[0][name], (name, r)


def test_store_epoch_is_one_for_the_world(runs):
    """On the MoE mesh every rank holds its block of the expert banks,
    yet the store's epoch is one value for the world; a change of weights
    on one rank alone moves every rank's epoch."""
    per_rank = runs["ranks"]
    first = per_rank[0]["epochs"]
    assert first[0] != first[1]
    for r, got in enumerate(per_rank):
        assert got["epochs"] == first, r
        assert got["moe_expert_bytes"] > 0
