"""MoE on the port's mesh: the routed-expert banks placed over a (data=2,
model=4) gloo world of 8 spawned CPU ranks, and the reference's three
dispatches run there with explicit collectives (``repro_torch.models.moe``).

* Expert placement, the twin of tests/test_sharded_serving.py's
  ``test_sharded_moe_expert_placement_parity``: the reduced qwen2-moe (f32,
  8 routed experts, top-2, a shared expert) serves blocking and chunked,
  each rank holding 1 of the 8 experts (the expert dim over ("model",
  "data")); tokens equal the port's single-device serve and the
  reference's, request for request, and every other leaf is whole.  The
  same model with 4 routed experts serves chunked with its banks over
  ("model",) only (4 does not divide into 8 ranks): 1 expert a rank, each
  data shard's buffers dispatched on its own ranks.
* The "global" dispatch: the same model with ``impl="global"`` served
  chunked, one capacity over each step's rows of both data shards;
  tokens equal the port's single-device serve and the reference's.
* The a2a dispatch: the same model with ``impl="a2a"`` (8 experts = 2 x
  4) served chunked takes the a2a branch on its mixed steps (16 rows a
  data shard, 4 a model chunk) and the sharded fallback on its decode
  steps (2 rows); tokens equal the port's single-device serve.  The
  reduced deepseek-v3 (MLA, ``impl="a2a"``) serves blocking on the same
  world with tokens equal to the single-device serve, whichever branch
  its steps take.
* Single ``apply_moe`` calls on the mesh under the "sharded" dispatch (8
  experts over ("model", "data"), 4 over ("model",)) and the "global"
  one, their rows split over the data shards as in an engine step and
  whole on every rank as in a B=1 admission prefill, against the
  reference's ``apply_moe`` body at the mesh's data-shard count (skewed
  inputs, so experts overflow their capacities).  The reduced model's
  tokens do not depend on its routed experts (a serve with the routed
  output zeroed gives the same tokens), so these calls are what holds the
  dispatches' values; the serves hold the engine around them.
* One ``apply_moe`` call on the a2a geometry against the reference's
  ``_apply_moe_a2a`` on 8 fake XLA CPU devices (``tests/_subproc.py``),
  y within ``LAYER_RTOL`` of max |y_ref| and the expert load and drop
  fraction equal; the same call with the return ``all_to_all`` skipped
  (a planted fault) is caught by that comparison.

The ranks (``_torch_family_ranks.moe_main``) serve while this process runs
the single-device and the reference's serves and the reference's layer
call."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as configs_ref
from repro.core.request_cluster import Request as RequestRef
from repro.models import moe as moe_ref
from repro.runtime.server import Server as ServerRef
from repro.runtime.server import ServerConfig as ServerConfigRef
from repro_torch import bridge
from repro_torch.models import moe
from repro_torch.sharding import rules as shard_rules

import _torch_family_ranks as ranks
import _torch_ref
from _subproc import run_sub
from _torch_world import World

# |y - y_ref| bound of a layer call, relative to max |y_ref|: f32 products
# of 64- and 96-wide rows, XLA's CPU dot against torch's (measured: under
# 2.5e-7)
LAYER_RTOL = 1e-5
MODELS = {"qwen2": lambda r: ranks.moe_config(reduced=r),
          "qwen2_a2a": lambda r: ranks.moe_config("a2a", reduced=r),
          "qwen2_e4": lambda r: ranks.moe_config(reduced=r, n_routed=4),
          "qwen2_global": lambda r: ranks.moe_config("global", reduced=r),
          "dsv3": lambda r: ranks.mla_config(reduced=r)}
# scenarios served with the "sharded" dispatch, their tokens also held to
# the reference's single-device serve
SHARDED = ("blocking", "chunked", "e4_chunked")
# scenarios whose tokens are also held to the reference's single-device
# serve (the a2a ones: to the port's, whose one-shard dispatch is the
# reference's with no mesh)
WITH_REFERENCE = SHARDED + ("global_chunked",)
# (scenario, model, routed experts, the expert block of the rank at
# (data d, model m)): the bank over ("model", "data") folds to m * 2 + d,
# over ("model",) to m
PLACEMENTS = [("blocking", "qwen2", 8, lambda d, m: m * 2 + d),
              ("e4_chunked", "qwen2_e4", 4, lambda d, m: m)]

_REF_A2A = """
    import dataclasses, sys
    import jax, numpy as np
    from repro import configs
    from repro.launch.mesh import make_serving_mesh
    from repro.models import moe
    from repro.sharding import Rules, default_table, use_rules
    z = np.load(sys.argv[1])
    p = {"shared": {}}
    for k in z.files:
        if k.startswith("shared."):
            p["shared"][k[7:]] = z[k]
        elif k != "x":
            p[k] = z[k]
    cfg = dataclasses.replace(configs.get_reduced("qwen2-moe-a2.7b"),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="a2a"))
    x = z["x"]
    rules = Rules(make_serving_mesh("2x4"), default_table(False))
    with use_rules(rules):
        geo = moe._a2a_geometry(cfg, x.shape[0] * x.shape[1])
        assert geo is not None
        y, m = jax.jit(lambda p, x: moe._apply_moe_a2a(p, x, cfg, geo))(
            p, x)
    np.savez(sys.argv[2], y=np.asarray(y), load=np.asarray(m["expert_load"]),
             drop=np.asarray(m["drop_frac"]))
"""


def _reference_layer(model, p_moe, x):
    """The reference's ``apply_moe`` body on the 2 x 4 mesh, with no mesh:
    ``_dispatch_compute`` at the mesh's data-shard count (2 for "sharded",
    1 for "global"; the rows divide) plus the shared expert.  Returns
    (y, expert_load, drop_frac)."""
    cfg = MODELS[model](configs_ref.get_reduced)
    ds = 1 if cfg.moe.impl == "global" else 2
    p = jax.tree.map(jnp.asarray, p_moe)
    b, s, d = x.shape
    y, counts, _, keep = moe_ref._dispatch_compute(
        p, jnp.asarray(x).reshape(b * s, d), cfg, ds)
    y = y.reshape(b, s, d) + moe_ref.apply_mlp(p["shared"], jnp.asarray(x),
                                                cfg)
    return np.asarray(y), np.asarray(counts), 1.0 - float(keep)


def _moe_leaves(weights, model):
    """Layer 0's MoE leaves of ``model``'s bridged weights, as numpy."""
    cfg = ranks.model_config(model)
    whole = bridge.params_from_numpy(weights[model], cfg, "cpu")
    return cfg, jax.tree.map(lambda t: t.numpy(), whole["layers"][0]["moe"])


def _reference_a2a(p_moe, x):
    """The reference's ``_apply_moe_a2a`` of the numpy leaves ``p_moe`` on
    x, on 8 fake devices in a subprocess: (y, expert_load, drop_frac)."""
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        leaves = {k: v for k, v in p_moe.items() if k != "shared"}
        leaves.update({f"shared.{k}": v
                       for k, v in p_moe["shared"].items()})
        np.savez(src, x=x, **leaves)
        run_sub(_REF_A2A.replace("sys.argv[1]", repr(src))
                .replace("sys.argv[2]", repr(out)))
        z = np.load(out)
        return z["y"], z["load"], float(z["drop"])


@pytest.fixture(scope="module")
def runs():
    cfgs = {k: f(configs_ref.get_reduced) for k, f in MODELS.items()}
    weights = {k: jax.tree.map(np.asarray, _torch_ref.ref_init_params(c, 0))
               for k, c in cfgs.items()}
    world = World("_torch_family_ranks:moe_main", 8, weights=weights)
    single, ref = {}, {}
    for name, (model, stream, fields) in ranks.MOE_SCENARIOS.items():
        cfg = ranks.model_config(model)
        params = bridge.params_from_numpy(weights[model], cfg, "cpu")
        single[name] = ranks.serve(cfg, fields, params, stream)[0][0]
    for name in WITH_REFERENCE:
        model, stream, fields = ranks.MOE_SCENARIOS[name]
        srv = ServerRef(cfgs[model], ServerConfigRef(
            **ranks.server_config(fields)), weights[model])
        ref[name] = {o.uid: o.tokens for o in srv.serve(
            *ranks.STREAMS[stream](RequestRef))}
    cfg, p_moe = _moe_leaves(weights, "qwen2_a2a")
    ref_layer = _reference_a2a(p_moe, ranks.a2a_inputs(cfg.d_model))
    ref_layers = {}
    for model in ranks.LAYER_MODELS:
        cfg, p_moe = _moe_leaves(weights, model)
        ref_layers[model] = _reference_layer(
            model, p_moe, ranks.layer_inputs(cfg.d_model, ranks.LAYER_SKEW,
                                             ranks.LAYER_SHAPE))
    return {"single": single, "ref": ref, "ref_layer": ref_layer,
            "ref_layers": ref_layers, "whole": weights,
            "ranks": world.result()}


def _tokens(runs, name):
    """The scenario's tokens, checked equal on every rank."""
    per_rank = [r[name] for r in runs["ranks"]]
    for r, res in enumerate(per_rank):
        assert res[0] == per_rank[0][0], (name, r)
    return per_rank[0]


@pytest.mark.parametrize("name", SHARDED)
def test_expert_placement_parity(runs, name):
    """Blocking and chunked serves with the expert banks distributed, 1
    expert a rank (of 8 over ("model", "data"), or of 4 over ("model",)):
    tokens == the port's single device == the reference's, request for
    request; every MoE call took the sharded dispatch."""
    toks, stats, counts = _tokens(runs, name)
    assert runs["single"][name] == runs["ref"][name]
    assert toks == runs["single"][name]
    assert stats["n_data_shards"] == 2.0
    assert counts["sharded"] > 0 and counts["a2a"] == counts["global"] == 0


@pytest.mark.parametrize("name,model,n_routed,block", PLACEMENTS,
                         ids=[p[0] for p in PLACEMENTS])
def test_each_rank_holds_its_expert_block(runs, name, model, n_routed,
                                          block):
    """Rank (data d, model m) holds expert ``block(d, m)`` of every routed
    bank and nothing else of it; every other leaf is whole, the shared
    expert, the router and its bias included; the rank's expert bytes are
    1 / n_routed of the whole banks'."""
    cfg = ranks.model_config(model)
    assert cfg.moe.n_routed == n_routed
    flat = ranks.flat_leaves(bridge.params_from_numpy(runs["whole"][model],
                                                      cfg, "cpu"))
    whole_experts = sum(v.nbytes for p, v in flat.items()
                        if shard_rules.is_expert_bank(p))
    seen = set()
    for r in runs["ranks"]:
        placement, nbytes = r["placement"][name]
        b = block(r["coord"]["data"], r["coord"]["model"])
        seen.add(b)
        assert sorted(placement) == sorted(flat)
        experts = 0
        for path, leaf in placement.items():
            if shard_rules.is_expert_bank(path):
                assert leaf.shape[0] == 1, path
                np.testing.assert_array_equal(leaf[0], flat[path][b])
                experts += leaf.nbytes
            else:
                np.testing.assert_array_equal(leaf, flat[path])
        assert experts > 0 and nbytes["experts"] == experts
        assert experts * n_routed == whole_experts
    assert seen == set(range(n_routed))


def test_global_dispatch_on_the_mesh(runs):
    """``impl="global"`` chunked: each MoE call gathers its data group's
    rows and dispatches them under one capacity; tokens == the port's
    single device == the reference's."""
    toks, _, counts = _tokens(runs, "global_chunked")
    assert runs["single"]["global_chunked"] == runs["ref"]["global_chunked"]
    assert toks == runs["single"]["global_chunked"]
    assert counts["global"] > 0 and counts["sharded"] == counts["a2a"] == 0


def test_a2a_branch_runs_in_a_chunked_serve(runs):
    """``impl="a2a"`` chunked: mixed steps (16 rows a data shard) take
    the a2a branch, decode steps (2 rows) the sharded fallback; tokens ==
    the port's single-device serve."""
    toks, _, counts = _tokens(runs, "a2a_chunked")
    assert counts["a2a"] > 0 and counts["sharded"] > 0
    assert toks == runs["single"]["a2a_chunked"]


def test_mla_moe_serves_blocking_on_the_mesh(runs):
    """The reduced deepseek-v3 (MLA, its config's ``impl="a2a"``): a
    blocking serve on the mesh equals the single-device serve; its
    admission prefills hold every row on every rank, so they take the
    sharded path."""
    toks, _, counts = _tokens(runs, "mla_blocking")
    assert toks == runs["single"]["mla_blocking"]
    assert counts["sharded"] > 0


def _layer_rows(runs, key, whole=False):
    """A layer call's rows of every data shard (model ranks of a shard
    agree; with ``whole`` every rank holds all rows and all agree), and
    the rank's load, drop fraction and branch counts."""
    out = [r[key] for r in runs["ranks"]]
    by_data = {}
    for r, (y, load, drop, counts) in enumerate(out):
        d = 0 if whole else runs["ranks"][r]["coord"]["data"]
        if d in by_data:
            np.testing.assert_array_equal(y, by_data[d])
        by_data[d] = y
    return (np.concatenate([by_data[d] for d in sorted(by_data)]),
            out[0][1], out[0][2], out[0][3])


def _assert_close(y, y_ref):
    assert np.max(np.abs(y - y_ref)) <= LAYER_RTOL * np.max(np.abs(y_ref))


@pytest.mark.parametrize("whole", [False, True], ids=["split", "whole"])
@pytest.mark.parametrize("model", ranks.LAYER_MODELS)
def test_mesh_dispatch_layer_matches_reference(runs, model, whole):
    """One ``apply_moe`` on the mesh, rows split over the data shards or
    whole on every rank: y within LAYER_RTOL of the reference's at the
    mesh's data-shard count, the expert load equal and the drop fraction
    within f32 rounding; the call took its impl's branch.  The skewed
    inputs overflow the experts' capacities (drop_frac > 0)."""
    key = f"layer/{model}" + ("/whole" if whole else "")
    y, load, drop, counts = _layer_rows(runs, key, whole)
    y_ref, load_ref, drop_ref = runs["ref_layers"][model]
    branch = "global" if model == "qwen2_global" else "sharded"
    assert counts == {"sharded": 0, "global": 0, "a2a": 0, branch: 1}
    _assert_close(y, y_ref)
    np.testing.assert_array_equal(load, load_ref)
    assert abs(drop - drop_ref) < 1e-6 and drop_ref > 0


def test_a2a_layer_matches_reference(runs):
    """y within LAYER_RTOL of the reference's ``_apply_moe_a2a``; the
    expert load and the drop fraction equal; the call took the a2a
    branch."""
    y, load, drop, counts = _layer_rows(runs, "a2a_layer")
    y_ref, load_ref, drop_ref = runs["ref_layer"]
    assert counts == {"sharded": 0, "global": 0, "a2a": 1}
    _assert_close(y, y_ref)
    np.testing.assert_array_equal(load, load_ref)
    assert drop == drop_ref


def test_skipped_return_all_to_all_is_caught(runs):
    """The planted fault (the return exchange skipped: every rank combines
    its own expert's outputs of the rows it received) fails the layer
    comparison."""
    y, _, _, counts = _layer_rows(runs, "a2a_layer_fault")
    y_ref = runs["ref_layer"][0]
    assert counts["a2a"] == 1
    assert np.max(np.abs(y - y_ref)) > 1e3 * LAYER_RTOL * np.max(
        np.abs(y_ref))


def test_dispatch_split_over_data_shards_matches_reference():
    """In process: ``_dispatch_compute`` at ds = 2 (each shard its own
    capacity, the admission prefill's split on a mesh) against the
    reference's, a capacity that drops assignments included."""
    import dataclasses

    import jax.numpy as jnp
    import torch

    from repro.models import moe as moe_ref

    for cf in (1.25, 0.25):
        cfg_r = ranks.moe_config(reduced=configs_ref.get_reduced)
        cfg_r = dataclasses.replace(cfg_r, moe=dataclasses.replace(
            cfg_r.moe, capacity_factor=cf))
        cfg = ranks.moe_config()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        w = jax.tree.map(np.asarray, _torch_ref.ref_init_params(cfg_r, 0))
        p = bridge.params_from_numpy(w, cfg, "cpu")["layers"][0]["moe"]
        x = np.random.default_rng(3).standard_normal(
            (64, cfg.d_model)).astype(np.float32)
        p_ref = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
        y_r, c_r, pb_r, k_r = moe_ref._dispatch_compute(p_ref, jnp.asarray(x),
                                                        cfg_r, 2)
        y, c, pb, k = moe._dispatch_compute(p, torch.from_numpy(x), cfg, 2)
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_r))
        assert float(k) == float(k_r)
        _assert_close(y.numpy(), np.asarray(y_r))
        np.testing.assert_allclose(pb.numpy(), np.asarray(pb_r), atol=1e-6)
        if cf < 1:
            assert float(k) < 1.0
