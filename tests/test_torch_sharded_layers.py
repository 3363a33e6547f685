"""Every layer family on the port's mesh: sliding-window ('L'), recurrent
('M' Mamba2 SSD, 'R' RG-LRU) and MLA layers served on a (data=2,
model=4) gloo world of 8 spawned CPU ranks, the twins of
tests/test_sharded_serving.py's ``test_sharded_windowed_paged_parity``
(:272) and ``test_sharded_recurrent_parity`` (:461).

* 'GL' (4 / 4 heads, window 16) chunked + paged: 'L' window rings shard
  like 'G' rings (slots over data, kv heads over model, the packed window
  path under the head island); tokens equal the reference's blocking
  dense single-device serve and the port's single-device serve of the
  same config; window and frontier retirement both ran; the pool drains.
* 'GM' and 'GR' (2 kv heads: heads replicate on a model axis of 4),
  chunked dense and chunked paged: recurrent state shards over slots
  only, each rank stepping its data shard's columns at its local slot
  count; tokens equal the reference's one-request-at-a-time static serve
  and the port's single-device serve; ``state_bytes_recurrent`` > 0 and
  equal to the single device's, nothing retired.
* The reduced deepseek-v3's MLA layers (its MoE layers taken out),
  blocking over exact KV and under a KVCompressConfig: the latent shards
  over slots only and every model rank decodes it in full; tokens equal
  the reference's and the port's single-device serves.
Prefix sharing, the template store and the SLO scheduler on a mesh are
tests/test_torch_sharded_prefix.py's and tests/test_torch_sharded_slo.py's
('GM' / 'GR' preemption among them).

The ranks (``_torch_family_ranks.layers_main``) serve while this process
runs the reference's and the single-device serves."""

import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as configs_ref
from repro.core import kv_compress as kv_ref
from repro.core import quantizer as quantizer_ref
from repro.core.request_cluster import Request as RequestRef
from repro.models.config import ModelConfig as ModelConfigRef
from repro.models.config import SSMConfig as SSMConfigRef
from repro.runtime.server import Server as ServerRef
from repro.runtime.server import ServerConfig as ServerConfigRef
from repro_torch import bridge

import _torch_family_ranks as ranks
import _torch_ref
from _torch_world import World

SEEDS = {"GL": 2, "GM": 0, "GR": 0, "MLA": 0}


def _ref_config(model):
    if model == "MLA":
        return ranks.mla_config(moe_layers=False,
                                reduced=configs_ref.get_reduced)
    return ranks.family_config(model, ModelConfigRef, SSMConfigRef)


def _ref_serve(model, stream, fields, weights):
    """The reference's single-device tokens the pins hold the mesh to:
    blocking dense for 'GL' and MLA (the config without its chunk and
    pool), one request at a time on the static engine for 'GM' / 'GR'."""
    if model in ("GM", "GR"):
        scfg = ServerConfigRef(batch_size=1, max_seq=fields["max_seq"],
                               engine="static",
                               use_clustered_batching=False)
    else:
        kw = {k: v for k, v in fields.items()
              if k not in ("prefill_chunk", "paged")}
        scfg = ServerConfigRef(**ranks.server_config(
            kw, kv_cls=kv_ref.KVCompressConfig))
    srv = ServerRef(_ref_config(model), scfg, weights)
    return {o.uid: o.tokens for o in srv.serve(
        *ranks.STREAMS[stream](RequestRef))}


@pytest.fixture(scope="module")
def runs():
    weights = {m: jax.tree.map(np.asarray, _torch_ref.ref_init_params(
        _ref_config(m), seed)) for m, seed in SEEDS.items()}
    world = World("_torch_family_ranks:layers_main", 8, weights=weights)
    single, ref, refs_by = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quantizer_ref, "auto_scale", _torch_ref._auto_scale_exact)
        for name, (model, stream, fields) in ranks.LAYER_SCENARIOS.items():
            key = (model, "dense" if model in ("GM", "GR") else name)
            if key not in refs_by:
                refs_by[key] = _ref_serve(model, stream, fields,
                                          weights[model])
            ref[name] = refs_by[key]
    for name, (model, stream, fields) in ranks.LAYER_SCENARIOS.items():
        cfg = ranks.model_config(model)
        params = bridge.params_from_numpy(weights[model], cfg, "cpu")
        single[name] = ranks.serve(cfg, fields, params, stream)[0]
    per_rank = world.result()
    return {name: (ref[name], single[name], [r[name] for r in per_rank])
            for name in ranks.LAYER_SCENARIOS}


def _check(runs, name):
    """Tokens equal on every rank, to the port's single-device serve and
    to the reference's; the rank's stats."""
    ref, (single, single_stats, _), per_rank = runs[name]
    assert single == ref
    toks, stats, _ = per_rank[0]
    for r, (t, s, _) in enumerate(per_rank):
        assert (t, s) == (toks, stats), (name, r)
    assert sorted(toks) == sorted(ref)
    for uid, t in toks.items():
        assert t == ref[uid], (name, uid, t, ref[uid])
    assert stats["n_data_shards"] == 2.0
    return stats, single_stats


def test_windowed_paged_parity(runs):
    """'GL' chunked + paged on the mesh == blocking dense on one device;
    'L' positions retired behind the window and 'G' ones behind the
    frontier; the pool drains."""
    stats, _ = _check(runs, "gl_paged")
    assert stats["kv_retired_window"] > 0 and stats["kv_retired_frontier"] > 0
    assert stats["pool_blocks_end"] == 0.0


@pytest.mark.parametrize("name", ["gm_dense", "gm_paged", "gr_dense",
                                  "gr_paged"])
def test_recurrent_parity(runs, name):
    """'GM' / 'GR' chunked, dense and paged, on the mesh == one request at
    a time on one device; recurrent state priced as on one device and
    never retired."""
    stats, single_stats = _check(runs, name)
    assert stats["state_bytes_recurrent"] > 0
    assert stats["state_bytes_recurrent"] == \
        single_stats["state_bytes_recurrent"]
    assert stats["kv_retired_recurrent"] == 0.0
    if name.endswith("paged"):
        assert stats["pool_blocks_end"] == 0.0


@pytest.mark.parametrize("name", ["mla_exact", "mla_clustered"])
def test_mla_parity(runs, name):
    """MLA blocking on the mesh, exact and under a KVCompressConfig (the
    latent passes the clustering untouched), == one device."""
    stats, _ = _check(runs, name)
    assert stats["kv_absorbs"] == 0.0


def test_mla_config_keeps_the_reference_fields():
    """The MLA pin's config is the reference's reduced deepseek-v3 less its
    MoE layers and MTP head, field for field."""
    got = dataclasses.asdict(ranks.mla_config(moe_layers=False))
    want = dataclasses.asdict(_ref_config("MLA"))
    assert got == want
