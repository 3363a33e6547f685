"""The port's mesh serving engine on a (data=2, model=4) gloo world of 8
spawned CPU ranks: the twins of tests/test_sharded_serving.py's first four
pins and its indivisible-heads fallback, on the reference's ``tiny4`` (f32,
4 / 4 heads of 16) and its weights (bridged).

For the same mixed-length stream, every scenario's tokens equal, request
for request, both the port's single-device engine and the reference's
(``auto_scale`` patched to exact powers of two, ``_torch_ref``): greedy
exact KV, mid-stream compaction, chunked prefill (exact and clustered,
with absorbs), paged blocking and chunked (tokens also equal the dense
engine's, the pool drains), and ``tiny2`` (2 kv heads on a model axis of
4: heads replicate, slots stay data-sharded).  Every rank returns the same
completions (one host engine, run SPMD).  The other model families serve
on a mesh (tests/test_torch_sharded_moe.py,
tests/test_torch_sharded_layers.py), and so do prefix sharing, the
template store and the SLO scheduler (tests/test_torch_sharded_prefix.py,
tests/test_torch_sharded_slo.py); a mesh that is not a ``DeviceMesh`` is
refused for every family.

The reference's and the single-device serves run here, in the test
process, while the ranks (``_torch_serving_ranks.main``) serve."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.core import kv_compress as kv_ref
from repro.core import quantizer as quantizer_ref
from repro.core.request_cluster import Request as RequestRef
from repro.models.config import ModelConfig as ModelConfigRef
from repro.runtime.kv_pool import PagedKVConfig as PagedKVConfigRef
from repro.runtime.server import Server as ServerRef
from repro.runtime.server import ServerConfig as ServerConfigRef
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.runtime.server import Server, ServerConfig

import _torch_ref
import _torch_serving_ranks as ranks
from _torch_world import World

SEEDS = {"tiny4": 0, "tiny2": 1}


@pytest.fixture(scope="module")
def runs():
    """{scenario: (reference tokens, single-device tokens, [(tokens,
    stats) a rank])}: the ranks serve while this process runs the
    reference's and the single-device serves."""
    weights = {m: jax.tree.map(np.asarray, _torch_ref.ref_init_params(
        ranks.config(m, ModelConfigRef), seed))
        for m, seed in SEEDS.items()}
    world = World("_torch_serving_ranks:main", 8, weights=weights)
    ref, single = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quantizer_ref, "auto_scale", _torch_ref._auto_scale_exact)
        for name, (model, fields) in ranks.SCENARIOS.items():
            kw = ranks.server_config(fields, kv_cls=kv_ref.KVCompressConfig,
                                     paged_cls=PagedKVConfigRef)
            srv = ServerRef(ranks.config(model, ModelConfigRef),
                            ServerConfigRef(batch_size=4, max_seq=64, **kw),
                            weights[model])
            ref[name] = {o.uid: o.tokens for o in srv.serve(
                *ranks.requests(name, RequestRef))}
    for name, (model, fields) in ranks.SCENARIOS.items():
        cfg = ranks.config(model)
        srv = Server(cfg, ServerConfig(batch_size=4, max_seq=64,
                                       **ranks.server_config(fields)),
                     bridge.params_from_numpy(weights[model], cfg, "cpu"),
                     device="cpu")
        single[name] = {o.uid: o.tokens for o in srv.serve(
            *ranks.requests(name))}
    per_rank = world.result()
    return {name: (ref[name], single[name], [r[name] for r in per_rank])
            for name in ranks.SCENARIOS}


def _check(runs, name):
    ref, single, per_rank = runs[name]
    assert single == ref
    toks, stats = per_rank[0]
    assert sorted(toks) == sorted(ref)
    for uid, t in toks.items():
        assert t == ref[uid], (name, uid, t, ref[uid])
    return stats


def test_sharded_engine_greedy_parity(runs):
    """2x4 mesh tokens == single-device tokens, exact KV; the engine ran
    sharded: per-data-shard stats were recorded."""
    stats = _check(runs, "exact")
    assert stats["n_data_shards"] == 2.0
    assert stats["slot_waste_shard1"] is not None


def test_sharded_engine_parity_with_midstream_compaction(runs):
    """Served from a clustered KV cache: the reference test's stream
    (prompts past the ring compress at admission), then with longer
    budgets so that slots re-compact mid-decode."""
    _check(runs, "compaction")
    stats = _check(runs, "compaction_long")
    assert stats["kv_compactions"] > 0


def test_sharded_chunked_prefill_parity(runs):
    """Chunked prefill streams prompt chunks into the sharded engine
    cache, one admitting slot a data shard, exact KV and clustered with
    compaction and absorbs."""
    stats = _check(runs, "chunked")
    assert stats["prefill_chunks"] > 0
    assert stats["prefill_pad_frac"] == 0.0
    stats = _check(runs, "chunked_compaction")
    assert stats["kv_absorbs"] > 0


@pytest.mark.parametrize("chunk", [0, 8])
def test_sharded_paged_parity(runs, chunk):
    """The block pool shards over data like the slots (block ids rebased
    per shard on the host); tokens equal the single-device paged engine
    and the dense clustered one; the pool drains."""
    name = "paged_chunked" if chunk else "paged_blocking"
    stats = _check(runs, name)
    dense = runs["chunked_compaction" if chunk else "compaction"][0]
    assert runs[name][0] == dense
    assert stats["pool_blocks_end"] == 0.0
    if chunk:
        assert stats["kv_absorbs"] > 0
        # compaction over the rank's rebased block table
        stats = _check(runs, "paged_long")
        assert stats["kv_compactions"] > 0
        assert stats["pool_blocks_end"] == 0.0


def test_indivisible_heads_fall_back_to_replication(runs):
    """2 kv heads on a model axis of 4: heads replicate, slots stay
    data-sharded, tokens unchanged."""
    stats = _check(runs, "indivisible_heads")
    assert stats["n_data_shards"] == 2.0


def test_every_rank_serves_the_same_tokens(runs):
    for name, (_, _, per_rank) in runs.items():
        for r, (toks, stats) in enumerate(per_rank):
            assert toks == per_rank[0][0], (name, r)
            assert stats == per_rank[0][1], (name, r)


_GM = ModelConfig(name="gm4", family="hybrid", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                  pad_vocab_multiple=16, dtype="float32", layer_pattern="GM",
                  ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                                n_groups=1, chunk=32))
# reduced deepseek-v3 without its MoE layers: MLA alone
_MLA = dataclasses.replace(configs_t.get_reduced("deepseek-v3-671b"),
                           moe=None, family="dense")


@pytest.mark.parametrize("cfg", [
    configs_t.get_reduced("qwen2-moe-a2.7b"),
    _MLA,
    _GM,
    ModelConfig(**dict(ranks.TINY4, layer_pattern="GL", sliding_window=16)),
], ids=["moe", "mla", "recurrent", "window"])
def test_unported_mesh_modes_raise(cfg):
    """The model families (MoE, MLA, recurrent, sliding-window) serve on a
    mesh since 10b and 10c's first part (tests/test_torch_sharded_moe.py,
    tests/test_torch_sharded_layers.py): no family gate stops them, and
    the first check they meet is the mesh's type."""
    with pytest.raises(TypeError, match="mesh= takes a DeviceMesh"):
        Server(cfg, ServerConfig(batch_size=4, max_seq=64, mesh=object()),
               None, device="cpu")
